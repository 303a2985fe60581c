// What the fused epilogue's forward (fused_ln.cu) and backward
// (fused_ln_bwd.cu) share: the element math up to the normalisation, the
// reference's dropout hash, the 4-, 8- and 16-byte row loads and stores,
// and the warp and block sums.
//
// x and the residual each arrive as fp32, bf16 or fp16 (the reference's
// kernel reads each in its own type, ops/pallas/fused_ln.py:58,63), in the
// pairs AMP makes (`by_types`: one 16-bit type beside itself or fp32);
// bias, gamma and beta each as fp32, bf16 or fp16 (a 2-bit type code each
// in `param_types`).  All arithmetic is fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace fln {

using tile::from_f32;
using tile::to_f32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MAX_D = 1024;    // one warp per row: 32 values a lane
constexpr int ROW_CACHE_D = 12288;  // 48 KB of fp32 z per row

// The inputs both directions read.  p and q = 1 - p arrive rounded to
// fp32 once on the host; the keep test is `u >= p` and the scale a true
// fp32 division by q (no fast-math flags), as the reference computes them.
struct Inputs {
  const void* x;
  const void* res;
  const void* bias;
  const void* gamma;
  const void* beta;
  int N, D;
  int param_types;  // type codes: bits 0-1 bias, 2-3 gamma, 4-5 beta
  // The hash seed lives in device memory (its low 32 bits): a captured
  // CUDA graph replays the launch with its arguments frozen, and reads
  // there the seed its step wrote before the replay.  `seed` is that
  // value, loaded once at the kernel's start (with_seed).
  const unsigned long long* seed_ptr;
  uint32_t seed;
  int dropout;
  float p, q, eps;
};

// The inputs with the seed loaded from device memory (null and unread
// without dropout).
__device__ __forceinline__ Inputs with_seed(Inputs in) {
  in.seed = in.dropout ? (uint32_t)*in.seed_ptr : 0u;
  return in;
}

// Uniform [0, 1) from the Murmur3 finaliser of the element index mod 2^32
// (the reference's hash_uniform, ops/pallas/fused_ln.py:33, bit for bit).
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t idx) {
  uint32_t h = (idx ^ seed) * 0x9E3779B1u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

// Type codes, of the tensors and of the parameters in `param_types`.
constexpr int F32 = 0, BF16 = 1, F16 = 2;

// The type code of parameter k (0 bias, 1 gamma, 2 beta).
__host__ __device__ __forceinline__ int param_code(int types, int k) {
  return (types >> (2 * k)) & 3;
}

__device__ __forceinline__ float param(const void* v, int col, int code) {
  if (code == BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(v)[col]);
  if (code == F16) return __half2float(static_cast<const __half*>(v)[col]);
  return static_cast<const float*>(v)[col];
}

// One value stored in the type of `code`.
__device__ __forceinline__ void store_code(void* v, int col, int code,
                                           float x) {
  if (code == BF16)
    static_cast<__nv_bfloat16*>(v)[col] = __float2bfloat16_rn(x);
  else if (code == F16)
    static_cast<__half*>(v)[col] = __float2half_rn(x);
  else
    static_cast<float*>(v)[col] = x;
}

// Whether dropout keeps element (row, col): the index wraps mod 2^32, as
// the reference's uint32 iota does.
__device__ __forceinline__ bool kept(const Inputs& a, int row, int col) {
  const uint32_t idx = (uint32_t)row * (uint32_t)a.D + (uint32_t)col;
  return hash_uniform(a.seed, idx) >= a.p;
}

// z = residual + dropout(x + bias) of one element; `keep` is the mask bit
// (true without dropout).
__device__ __forceinline__ float pre_norm(const Inputs& a, float xv, float rv,
                                          int row, int col, bool& keep) {
  float h = xv + param(a.bias, col, param_code(a.param_types, 0));
  keep = true;
  if (a.dropout) {
    keep = kept(a, row, col);
    h = keep ? h / a.q : 0.f;
  }
  return rv + h;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the block of each thread's v, returned to every thread in
// the same order of additions.  red: WARPS floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red's previous use is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) t += red[i];
  return t;
}

template <int BYTES>
struct Vec;
template <>
struct Vec<4> {
  using type = uint32_t;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<16> {
  using type = uint4;
};

// VEC consecutive values at p, as one 4-, 8- or 16-byte access (VEC > 1,
// p aligned to VEC * sizeof(T)) or one value (VEC == 1)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else {
    using V = typename Vec<VEC * sizeof(T)>::type;
    const V raw = *reinterpret_cast<const V*>(p);
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
    using V = typename Vec<VEC * sizeof(T)>::type;
    V raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<V*>(p) = raw;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// F<TX, TR>::call(args...) for the (x, residual) type codes: fp32 with
// fp32, bf16 or fp16; bf16 or fp16 with itself or fp32.  A bf16 beside an
// fp16 is no pair AMP makes: cudaErrorInvalidValue.
template <template <typename, typename> class F, typename... A>
cudaError_t by_types(int dtype, int res_dtype, A... args) {
  switch (dtype * 3 + res_dtype) {
    case F32 * 3 + F32: return F<float, float>::call(args...);
    case F32 * 3 + BF16: return F<float, __nv_bfloat16>::call(args...);
    case F32 * 3 + F16: return F<float, __half>::call(args...);
    case BF16 * 3 + F32: return F<__nv_bfloat16, float>::call(args...);
    case BF16 * 3 + BF16:
      return F<__nv_bfloat16, __nv_bfloat16>::call(args...);
    case F16 * 3 + F32: return F<__half, float>::call(args...);
    case F16 * 3 + F16: return F<__half, __half>::call(args...);
    default: return cudaErrorInvalidValue;
  }
}

// Values a lane loads at once on the warp path: 16 bytes of a type when x
// and the residual share it, else 4 (16 bytes of fp32, 8 of bf16 or
// fp16); 1 when
// D or an operand's alignment does not allow it.
template <typename TX, typename TR>
constexpr int vec_width() {
  return sizeof(TX) == sizeof(TR) ? 16 / (int)sizeof(TX) : 4;
}

}  // namespace fln
