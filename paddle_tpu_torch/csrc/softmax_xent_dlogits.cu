// Gradient of the fused LM head's logits (dlogits) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dlogits_kernel` of
// paddle_tpu/ops/pallas/softmax_xent.py (launched there by
// `softmax_xent_dlogits`):
//
//   out[c, v] = (exp(x[c] . w[:, v] - lse[c]) - (v == labels[c])) * g
//
// x (C, D), w (D, V) fp32, bf16 or fp16, labels (C,) int32, lse (C,) fp32
// (saved by the forward kernel), g one fp32 value on the device (the loss
// gradient over N, read where it lies so the step never syncs); out (C, V)
// in x's type, with no pad columns.  The product is accumulated in fp32;
// the epilogue computes in fp32 and casts once (round to nearest, fp16
// subnormals kept).  A label outside [0, V) subtracts nothing.
//
// What bounds it on an H100: 2*C*D*V flops against (C*D + D*V + C*V)
// elements.  At the compiled step's chunk (C 4096, D 768, V 30528, bf16)
// that is 1.92e11 flops (0.194 ms at 989 TFLOP/s) against 306 MB
// (0.091 ms at 3.35 TB/s): bound by arithmetic.  In bf16 and fp16 the
// product runs on the tensor cores (mma.sync m16n8k16, fp32 accumulators,
// operands from shared memory by ldmatrix; tile_common.cuh), fp32 on FMAs.
// wgmma, TMA and a pipeline of chunk loads are later work.
//
// Design: one 256-thread block per 64-row x 128-column tile of out; the
// grid runs the row tiles fastest, so the blocks in flight share one
// 768 x 128 slice of w and the whole of x stays in L2.  The tile is built
// from 64-deep chunks of x and w staged through shared memory and lives
// only in registers; there is no reduction across tiles, so the epilogue
// writes each element once, two neighbouring columns per store where the
// row stride allows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BV = 128;       // vocabulary columns per block
constexpr int BK = 64;        // depth of one staged chunk
constexpr int THREADS = 256;  // eight warps: 4 row groups x 2 column halves
constexpr int NT = BV / 16;   // 8-column blocks per warp

template <typename T>
struct Cfg {
  static constexpr int LDX = BK + tile::pad<T>();
  static constexpr int LDW = BV + tile::pad<T>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(BM * LDX + BK * LDW);
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sxent_dlogits_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ labels,
                     const float* __restrict__ lse,
                     const float* __restrict__ g, T* __restrict__ out, int C,
                     int D, int V, int vec_x, int vec_w) {
  using Cf = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sW = sX + BM * Cf::LDX;

  const tile::Warp wp;
  const int row0 = blockIdx.x * BM;
  const int v0 = blockIdx.y * BV;

  float acc[NT][4];
  tile::zero(acc);
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // the previous chunk is no longer read
    tile::copy_tile<T, BM, BK, Cf::LDX, THREADS>(x, D, row0, C, k0, D, vec_x,
                                                 sX);
    tile::copy_tile<T, BK, BV, Cf::LDW, THREADS>(w, V, k0, D, v0, V, vec_w,
                                                 sW);
    __syncthreads();
    tile::warp_mma<T, NT, false>(acc, sX, Cf::LDX, sW, Cf::LDW, wp.wm,
                                 wp.wn * 64, BK);
  }

  const float gs = *g;
  const bool pairs = V % 2 == 0;  // (row * V + even col) is even
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wp.wm + wp.g + 8 * h;
    if (row >= C) continue;
    const float m = lse[row];
    const int lab = labels[row];
    T* orow = out + (size_t)row * V;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = v0 + wp.wn * 64 + 8 * j + 2 * wp.t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pv = expf(acc[j][2 * h + e] - m);
        if (col + e == lab) pv -= 1.f;
        y[e] = pv * gs;
      }
      if (pairs && col + 1 < V) {
        tile::store_pair(orow + col, y[0], y[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < V) orow[col + e] = tile::from_f32<T>(y[e]);
      }
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w, const int* labels,
                const float* lse, const float* g, void* out, int C, int D,
                int V, cudaStream_t stream) {
  using Cf = Cfg<T>;
  constexpr int VN = 16 / sizeof(T);
  const int vec_x =
      D % VN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w =
      V % VN == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      sxent_dlogits_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cf::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + BM - 1) / BM, (V + BV - 1) / BV);
  sxent_dlogits_kernel<T><<<grid, THREADS, Cf::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, lse, g,
      static_cast<T*>(out), C, D, V, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).
extern "C" int softmax_xent_dlogits(const void* x, const void* w,
                                    const int* labels, const float* lse,
                                    const float* g, void* out, int C, int D,
                                    int V, int dtype, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (C <= 0 || D <= 0 || V <= 0 || (V + BV - 1) / BV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)run<float>(x, w, labels, lse, g, out, C, D, V, s);
    case 1:
      return (int)run<__nv_bfloat16>(x, w, labels, lse, g, out, C, D, V, s);
    case 2:
      return (int)run<__half>(x, w, labels, lse, g, out, C, D, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* softmax_xent_dlogits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
