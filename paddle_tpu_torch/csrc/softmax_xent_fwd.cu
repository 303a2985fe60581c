// Fused LM-head forward (softmax cross-entropy statistics) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// paddle_tpu/ops/pallas/softmax_xent.py (launched there by
// `softmax_xent_fwd`):
//
//   logits = x @ w        x (N, D), w (D, V), fp32 accumulation
//   lse[n] = log sum_v exp(logits[n, v])        (N,) fp32
//   at[n]  = logits[n, labels[n]]               (N,) fp32
//
// so that loss = mean(lse - at) without an (N, V) logits tensor in device
// memory.  fp32, bf16 or fp16 inputs; labels int32.  Columns v >= V are masked
// here (no padded copy of w is made); a label outside [0, V) leaves at[n]
// as the caller initialised it.
//
// What bounds it on an H100: 2*N*D*V flops on (N*D + D*V) elements; at the
// flagship shape (N 65536, D 768, V 30528) that is 3.07 TFLOP against
// 148 MB, far above the card's ~295 flops per byte, so the kernel is bound
// by arithmetic.  In bf16 and fp16 the product runs on the tensor cores
// (mma.sync m16n8k16 with fp32 accumulators, operands from shared memory by
// ldmatrix); fp32 runs on FMAs.  wgmma, TMA and a pipeline of chunk loads
// are later work.
//
// Design: one 256-thread block per 64 rows (1024 blocks at the flagship
// shape); the block walks the vocabulary in tiles of 128 columns, each
// built from 64-deep chunks of x and w staged through shared memory, so
// the logits tile lives only in registers.  Each tile is folded into a
// running max and sum of exponentials per row (fp32), reduced across the
// four lanes of a row group by shuffles and across the two warps that
// share a row through shared memory; the lane holding a row's label column
// writes its logit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

using tile::NEG_INF;

constexpr int BM = 64;        // rows per block
constexpr int BV = 128;       // vocabulary columns per tile
constexpr int BK = 64;        // depth of one staged chunk
constexpr int THREADS = 256;  // eight warps: 4 row groups x 2 column halves
constexpr int NT = BV / 16;   // 8-column blocks per warp

template <typename T>
struct Cfg {
  static constexpr int LDX = BK + tile::pad<T>();
  static constexpr int LDW = BV + tile::pad<T>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(BM * LDX + BK * LDW) + sizeof(float) * 4 * BM;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sxent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ labels, float* __restrict__ lse,
                 float* __restrict__ at, int N, int D, int V, int vec_x,
                 int vec_w) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sW = sX + BM * C::LDX;
  float* sMax = reinterpret_cast<float*>(sW + BK * C::LDW);  // [2][BM]
  float* sSum = sMax + 2 * BM;                                // [2][BM]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 16, wn = warp >> 2;
  const int row0 = blockIdx.x * BM;
  const int r[2] = {wm + g, wm + g + 8};
  int lab[2];
  float m_r[2], l_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lab[h] = row0 + r[h] < N ? labels[row0 + r[h]] : -1;
    m_r[h] = NEG_INF;
    l_r[h] = 0.f;
  }

  for (int v0 = 0; v0 < V; v0 += BV) {
    float acc[NT][4];
    tile::zero(acc);
    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();  // the previous chunk is no longer read
      tile::copy_tile<T, BM, BK, C::LDX, THREADS>(x, D, row0, N, k0, D,
                                                  vec_x, sX);
      tile::copy_tile<T, BK, BV, C::LDW, THREADS>(w, V, k0, D, v0, V,
                                                  vec_w, sW);
      __syncthreads();
      tile::warp_mma<T, NT, false>(acc, sX, C::LDX, sW, C::LDW, wm, wn * 64,
                                   BK);
    }

    // tile max per row, and the label logit where this lane holds it
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = v0 + wn * 64 + 8 * j + 2 * t + (e & 1);
        if (col < V) {
          tmax[h] = fmaxf(tmax[h], acc[j][e]);
          if (col == lab[h]) at[row0 + r[h]] = acc[j][e];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      if (t == 0) sMax[wn * BM + r[h]] = tmax[h];
    }
    __syncthreads();
    float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      m_new[h] = fmaxf(m_r[h], fmaxf(sMax[r[h]], sMax[BM + r[h]]));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = v0 + wn * 64 + 8 * j + 2 * t + (e & 1);
        // columns past V do not exist: their weight is exactly 0
        if (col < V) psum[h] += expf(acc[j][e] - m_new[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      if (t == 0) sSum[wn * BM + r[h]] = psum[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] = l_r[h] * expf(m_r[h] - m_new[h]) + sSum[r[h]] +
               sSum[BM + r[h]];
      m_r[h] = m_new[h];
    }
  }

  if (wn == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + r[h] < N) lse[row0 + r[h]] = m_r[h] + logf(l_r[h]);
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w, const int* labels, float* lse,
                float* at, int N, int D, int V, cudaStream_t stream) {
  using C = Cfg<T>;
  constexpr int VN = 16 / sizeof(T);
  const int vec_x =
      D % VN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w =
      V % VN == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      sxent_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::bytes);
  if (err != cudaSuccess) return err;
  sxent_fwd_kernel<T><<<(N + BM - 1) / BM, THREADS, C::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, lse, at, N,
      D, V, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).
extern "C" int softmax_xent_fwd(const void* x, const void* w,
                                const int* labels, float* lse, float* at,
                                int N, int D, int V, int dtype,
                                void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (N <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)run<float>(x, w, labels, lse, at, N, D, V, s);
    case 1:
      return (int)run<__nv_bfloat16>(x, w, labels, lse, at, N, D, V, s);
    case 2:
      return (int)run<__half>(x, w, labels, lse, at, N, D, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* softmax_xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
