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
// are each fp32 or bf16, in their own types, as the reference's kernel
// reads them; bias, gamma and beta each fp32 or bf16.  The dropout mask is
// the reference's Murmur3-finaliser hash of the element index mod 2^32
// (ops/pallas/fused_ln.py:33), bit for bit: the backward (fused_ln_bwd.cu)
// recomputes it from (seed, index) and no mask is stored.  The shared
// element math is in fused_ln_common.cuh.
//
// What bounds it on an H100: one read of x and of the residual and one
// write of out, a few flops per element: memory.  At N 16384, D 768, fp32
// that is 151 MB, a bound of 0.045 ms at 3.35 TB/s.
//
// Design: for D <= 1024 one warp per row holds the row in registers (at
// most 32 values a lane), loaded 16 bytes at a time where D and the
// alignment allow (fp32: 4 values, bf16: 8; x and residual of different
// types: 4 values, 16 and 8 bytes), else one value at a time.  The hash
// runs in registers; mean and centred variance come from two warp shuffle
// reductions over the registers, with no second read of the row.  Longer
// rows take one 256-thread block per row: the row's z values wait in 48 KB
// of dynamic shared memory (D <= 12288, opted in beyond the default
// limit, which the block sums' static array also takes from), else each
// pass recomputes them from x and the residual.  Eight rows per 256-thread
// block on the warp path.

#include "fused_ln_common.cuh"

namespace {

using namespace fln;

struct Args {
  Inputs in;
  void* out;
};

// One warp per row, D <= 1024.  Lane l holds chunks c = 0.. of VEC
// columns starting at (32c + l) * VEC; with VEC > 1, D % VEC == 0.
template <typename TX, typename TR, int VEC>
__global__ void __launch_bounds__(THREADS) fused_ln_warp(Args args) {
  constexpr int CHUNKS = WARP_MAX_D / (32 * VEC);
  const Inputs a = with_seed(args.in);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.N) return;  // the whole warp leaves together
  const size_t base = (size_t)row * a.D;
  const TX* xr = static_cast<const TX*>(a.x) + base;
  const TR* rr = static_cast<const TR*>(a.res) + base;
  TX* orow = static_cast<TX*>(args.out) + base;

  float z[CHUNKS][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col0 = (c * 32 + lane) * VEC;
    if (col0 < a.D) {
      float xv[VEC], rv[VEC];
      load<TX, VEC>(xr + col0, xv);
      load<TR, VEC>(rr + col0, rv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        bool keep;
        z[c][v] = pre_norm(a, xv[v], rv[v], row, col0 + v, keep);
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
      store<TX, VEC>(orow + col0, y);
    }
  }
}

// One block per row, any D.  With `cached`, z waits in dynamic shared
// memory between the passes; otherwise each pass recomputes it.
template <typename TX, typename TR>
__global__ void __launch_bounds__(THREADS) fused_ln_row(Args args,
                                                        int cached) {
  extern __shared__ float zs[];
  __shared__ float red[WARPS];
  const Inputs a = with_seed(args.in);
  const int row = blockIdx.x;
  const size_t base = (size_t)row * a.D;
  const TX* xr = static_cast<const TX*>(a.x) + base;
  const TR* rr = static_cast<const TR*>(a.res) + base;
  TX* orow = static_cast<TX*>(args.out) + base;
  auto zval = [&](int col) {
    bool keep;
    return cached ? zs[col]
                  : pre_norm(a, to_f32(xr[col]), to_f32(rr[col]), row, col,
                             keep);
  };

  float s = 0.f;
  for (int col = threadIdx.x; col < a.D; col += THREADS) {
    bool keep;
    const float z =
        pre_norm(a, to_f32(xr[col]), to_f32(rr[col]), row, col, keep);
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
    orow[col] = from_f32<TX>((zval(col) - mean) * rstd *
                                 param(a.gamma, col, g16) +
                             param(a.beta, col, b16));
}

template <typename TX, typename TR>
cudaError_t run(const Args& a, cudaStream_t s) {
  const Inputs& in = a.in;
  if (in.D <= WARP_MAX_D) {
    constexpr int VN = vec_width<TX, TR>();
    const int blocks = (in.N + WARPS - 1) / WARPS;
    if (in.D % VN == 0 && aligned16(in.x) && aligned16(in.res) &&
        aligned16(a.out))
      fused_ln_warp<TX, TR, VN><<<blocks, THREADS, 0, s>>>(a);
    else
      fused_ln_warp<TX, TR, 1><<<blocks, THREADS, 0, s>>>(a);
  } else {
    const int cached = in.D <= ROW_CACHE_D;
    const size_t smem = cached ? (size_t)in.D * sizeof(float) : 0;
    cudaError_t err = cudaFuncSetAttribute(
        fused_ln_row<TX, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(ROW_CACHE_D * sizeof(float)));
    if (err != cudaSuccess) return err;
    fused_ln_row<TX, TR><<<in.N, THREADS, smem, s>>>(a, cached);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run_res(const Args& a, int res_dtype, cudaStream_t s) {
  switch (res_dtype) {
    case 0:
      return run<TX, float>(a, s);
    case 1:
      return run<TX, __nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (x, out) and res_dtype (residual): 0 = float32, 1 = bfloat16.
// param_bf16: bit 0 bias, bit 1 gamma, bit 2 beta are bf16 (else fp32).
// seed: one int64 in device memory, read only with dropout.  Returns a cudaError_t (0 = launched).
extern "C" int fused_ln(const void* x, const void* res, const void* bias,
                        const void* gamma, const void* beta, void* out, int N,
                        int D, int dtype, int res_dtype, int param_bf16,
                        const unsigned long long* seed, int dropout,
                        float p, float q, float eps, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const Args a{
      {x, res, bias, gamma, beta, N, D, param_bf16, seed, 0u, dropout, p, q,
       eps},
      out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)run_res<float>(a, res_dtype, s);
    case 1:
      return (int)run_res<__nv_bfloat16>(a, res_dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
