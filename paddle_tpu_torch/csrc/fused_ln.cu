// Fused bias + dropout + residual add + LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of paddle_tpu/ops/pallas/fused_ln.py
// (launched there by `fused_ln_pallas`):
//
//   h   = x + bias                                       (N, D), fp32
//   h   = u >= p ? h / (1 - p) : 0     when p > 0, u = hash(seed, row*D + col)
//   z   = residual + h
//   out = (z - mean) * rsqrt(var + eps) * gamma + beta   in x's type
//
// with mean and the centred variance of each row in fp32.  x and residual
// are fp32 or bf16; bias, gamma and beta each fp32 or bf16.  The dropout
// mask is the reference's Murmur3-finaliser hash of the element index mod
// 2^32 (ops/pallas/fused_ln.py:33), bit for bit: the backward recomputes it
// from (seed, index) and stores no mask.  p and 1 - p arrive as fp32 from
// the host; the keep test is `u >= p` and the scale a true fp32 division
// (no fast-math flags), as the reference computes them.
//
// What bounds it on an H100: one read of x and of the residual and one
// write of out, a few flops per element: memory.  At N 16384, D 768, fp32
// that is 151 MB, a bound of 0.045 ms at 3.35 TB/s.
//
// Design: for D <= 1024 one warp per row holds the row in registers (at
// most 32 values a lane), loaded 16 bytes at a time where D and the
// alignment allow (fp32: 4 values, bf16: 8), else one value at a time.
// The hash runs in registers; mean and centred variance come from two warp
// shuffle reductions over the registers, with no second read of the row.
// Longer rows take one 256-thread block per row: the row's z values wait
// in 48 KB of dynamic shared memory (D <= 12288, opted in beyond the
// default limit, which the block sums' static array also takes from),
// else each pass recomputes them from x and the residual.  Eight rows per
// 256-thread block on the warp path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

using tile::from_f32;
using tile::to_f32;

constexpr int THREADS = 256;
constexpr int WARP_MAX_D = 1024;   // 32 values a lane
constexpr int ROW_CACHE_D = 12288; // 48 KB of fp32 z per row

struct Args {
  const void* x;
  const void* res;
  const void* bias;
  const void* gamma;
  const void* beta;
  void* out;
  int N, D;
  int param_bf16;  // bit 0 bias, bit 1 gamma, bit 2 beta
  uint32_t seed;
  int dropout;
  float p, q, eps;  // q = 1 - p, rounded once on the host
};

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t idx) {
  uint32_t h = (idx ^ seed) * 0x9E3779B1u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float param(const void* v, int col, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v)[col])
              : static_cast<const float*>(v)[col];
}

// z = residual + dropout(x + bias) of one element
__device__ __forceinline__ float pre_norm(const Args& a, float xv, float rv,
                                          int row, int col) {
  float h = xv + param(a.bias, col, a.param_bf16 & 1);
  if (a.dropout) {
    const uint32_t idx = (uint32_t)row * (uint32_t)a.D + (uint32_t)col;
    h = hash_uniform(a.seed, idx) >= a.p ? h / a.q : 0.f;
  }
  return rv + h;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC consecutive values at p (VEC * sizeof(T) == 16, or VEC == 1)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// One warp per row, D <= 1024.  Lane l holds chunks c = 0.. of VEC
// columns starting at (32c + l) * VEC; with VEC > 1, D % VEC == 0.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) fused_ln_warp(Args a) {
  constexpr int CHUNKS = WARP_MAX_D / (32 * VEC);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= a.N) return;  // the whole warp leaves together
  const size_t base = (size_t)row * a.D;
  const T* xr = static_cast<const T*>(a.x) + base;
  const T* rr = static_cast<const T*>(a.res) + base;
  T* orow = static_cast<T*>(a.out) + base;

  float z[CHUNKS][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col0 = (c * 32 + lane) * VEC;
    if (col0 < a.D) {
      float xv[VEC], rv[VEC];
      load<T, VEC>(xr + col0, xv);
      load<T, VEC>(rr + col0, rv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        z[c][v] = pre_norm(a, xv[v], rv[v], row, col0 + v);
        sum += z[c][v];
      }
    }
  }
  const float mean = warp_sum(sum) / (float)a.D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if ((c * 32 + lane) * VEC < a.D) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        z[c][v] -= mean;
        sq += z[c][v] * z[c][v];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)a.D + a.eps);
  const bool g16 = a.param_bf16 & 2, b16 = a.param_bf16 & 4;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col0 = (c * 32 + lane) * VEC;
    if (col0 < a.D) {
      float y[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        y[v] = z[c][v] * rstd * param(a.gamma, col0 + v, g16) +
               param(a.beta, col0 + v, b16);
      store<T, VEC>(orow + col0, y);
    }
  }
}

// The sum over the block of each thread's v, returned to every thread in
// the same order of additions.  red: THREADS / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red's previous use is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) t += red[i];
  return t;
}

// One block per row, any D.  With `cached`, z waits in dynamic shared
// memory between the passes; otherwise each pass recomputes it.
template <typename T>
__global__ void __launch_bounds__(THREADS) fused_ln_row(Args a, int cached) {
  extern __shared__ float zs[];
  __shared__ float red[THREADS / 32];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * a.D;
  const T* xr = static_cast<const T*>(a.x) + base;
  const T* rr = static_cast<const T*>(a.res) + base;
  T* orow = static_cast<T*>(a.out) + base;
  auto zval = [&](int col) {
    return cached ? zs[col]
                  : pre_norm(a, to_f32(xr[col]), to_f32(rr[col]), row, col);
  };

  float s = 0.f;
  for (int col = threadIdx.x; col < a.D; col += THREADS) {
    const float z = pre_norm(a, to_f32(xr[col]), to_f32(rr[col]), row, col);
    if (cached) zs[col] = z;
    s += z;
  }
  const float mean = block_sum(s, red) / (float)a.D;  // syncs zs too
  float sq = 0.f;
  for (int col = threadIdx.x; col < a.D; col += THREADS) {
    const float d = zval(col) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / (float)a.D + a.eps);
  const bool g16 = a.param_bf16 & 2, b16 = a.param_bf16 & 4;
  for (int col = threadIdx.x; col < a.D; col += THREADS)
    orow[col] = from_f32<T>((zval(col) - mean) * rstd *
                                param(a.gamma, col, g16) +
                            param(a.beta, col, b16));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t s) {
  if (a.D <= WARP_MAX_D) {
    constexpr int VN = 16 / sizeof(T);
    const int blocks = (a.N + THREADS / 32 - 1) / (THREADS / 32);
    if (a.D % VN == 0 && aligned16(a.x) && aligned16(a.res) &&
        aligned16(a.out))
      fused_ln_warp<T, VN><<<blocks, THREADS, 0, s>>>(a);
    else
      fused_ln_warp<T, 1><<<blocks, THREADS, 0, s>>>(a);
  } else {
    const int cached = a.D <= ROW_CACHE_D;
    const size_t smem = cached ? (size_t)a.D * sizeof(float) : 0;
    cudaError_t err = cudaFuncSetAttribute(
        fused_ln_row<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(ROW_CACHE_D * sizeof(float)));
    if (err != cudaSuccess) return err;
    fused_ln_row<T><<<a.N, THREADS, smem, s>>>(a, cached);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, residual, out).  param_bf16: bit 0
// bias, bit 1 gamma, bit 2 beta are bf16 (else fp32).  Returns a
// cudaError_t (0 = launched).
extern "C" int fused_ln(const void* x, const void* res, const void* bias,
                        const void* gamma, const void* beta, void* out, int N,
                        int D, int dtype, int param_bf16, unsigned int seed,
                        int dropout, float p, float q, float eps,
                        void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, res, bias, gamma, beta, out, N, D, param_bf16, seed,
               dropout, p, q, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)run<float>(a, s);
    case 1:
      return (int)run<__nv_bfloat16>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
