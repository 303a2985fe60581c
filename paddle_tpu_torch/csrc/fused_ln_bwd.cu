// Backward of the fused bias + dropout + residual add + LayerNorm for
// Hopper (sm_90a).
//
// Replaces `_fused_bwd` of paddle_tpu/ops/fused_ops.py:62, the vjp of
// `_fused_math` in plain XLA (the reference has no Pallas kernel for it;
// XLA fuses it into the surrounding backward).  For rows of (N, D), in
// fp32 inside:
//
//   per element  h = x + bias, m = hash(seed, row*D + col mod 2^32) >= p,
//                hd = m ? h / q : 0 (q = 1 - p), z = residual + hd
//   per row      mean and centred variance as the forward computes them,
//                rstd, y = (z - mean) * rstd, gg = g * gamma,
//                dz = rstd * (gg - mean(gg) - y * mean(gg * y)),
//                dres = dz, dx = m ? dz / q : 0 (dz without dropout)
//   over rows    dbias = sum dx, dgamma = sum g * y, dbeta = sum g
//
// The mask is the forward's (fused_ln_common.cuh) bit for bit; the
// division by q is a true fp32 division, as the vjp of h / (1 - p) gives
// it (no fast-math flags).  dx is written in x's type, dres in the
// residual's, each column gradient in its own parameter's type, rounded
// once from the fp32 sum.
//
// What bounds it on an H100: g, x and the residual read once, dx and dres
// written once, a few tens of flops per element: memory.  At N 16384,
// D 768, fp32 that is 5 x 50.3 MB = 251.7 MB, a bound of 0.0751 ms at
// 3.35 TB/s; the column sums add a (blocks, 3, D) fp32 scratch, written
// once and read once (~3.6 MB there).
//
// Design: the column sums are what a row-parallel kernel cannot do in one
// pass without atomics, and atomics would make two runs differ in their
// last bits.  So a block takes a contiguous range of rows, each warp one
// row at a time (D <= 1024: the row in registers, 4-, 8- or 16-byte
// loads as in the forward), and each warp adds its rows' column terms to
// its own (3, D) slice of shared memory, which no other warp touches,
// laid out lane-major so that a warp's 32 adds hit 32 banks.  At
// the end the block sums its eight slices in warp order into its row of
// the scratch, and a second launch sums the blocks' rows in block order
// into dbias, dgamma and dbeta.  The grid is the number of blocks that
// fit on the card at once (occupancy API), so every block runs in one
// wave and the scratch stays small.  Rows longer than 1024 take the whole
// block per row, z in shared memory as in the forward (D <= 12288, else
// recomputed), and the block's column sums in its row of the scratch, each
// column owned by one thread.

#include "fused_ln_common.cuh"

namespace {

using namespace fln;

struct Args {
  Inputs in;
  const void* g;   // in x's type
  void* dx;        // x's type
  void* dres;      // the residual's type
  float* partial;  // (gridDim.x, 3, D): dbias, dgamma, dbeta per block
  int rows_per_block;
};

// Slots of a warp's column sums: lane-major, so that the 32 lanes adding
// their columns' terms touch 32 consecutive words (no bank conflicts):
// column (32c + l) * VEC + v sits at slot (c * VEC + v) * 32 + l.
template <int VEC>
__device__ __forceinline__ int slot_of(int col) {
  const int c = col / (32 * VEC), rem = col - c * 32 * VEC;
  return (c * VEC + rem % VEC) * 32 + rem / VEC;
}

// Per warp: 3 x span(D) floats of column sums (span: D rounded up to the
// lanes' 32 * VEC columns).
__host__ __device__ __forceinline__ int span(int D, int vec) {
  return (D + 32 * vec - 1) / (32 * vec) * 32 * vec;
}

// One warp per row, D <= 1024.  Lane l holds chunks c = 0.. of VEC
// columns starting at (32c + l) * VEC; with VEC > 1, D % VEC == 0.
// Dynamic shared memory: WARPS x 3 x span(D) fp32 column sums, laid out
// by slot_of.
template <typename TX, typename TR, int VEC>
__global__ void __launch_bounds__(THREADS) ln_bwd_warp(Args args) {
  constexpr int CHUNKS = WARP_MAX_D / (32 * VEC);
  static_assert(CHUNKS * VEC <= 32, "the keep bits fit one word");
  extern __shared__ float acc[];
  const Inputs a = with_seed(args.in);
  const int D = a.D;
  const int S = span(D, VEC);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = acc + (size_t)warp * 3 * S;
  for (int i = lane; i < 3 * S; i += 32) mine[i] = 0.f;
  __syncwarp();

  const int first = blockIdx.x * args.rows_per_block;
  const int last = min(a.N, first + args.rows_per_block);
  const bool g16 = a.param_bf16 & 2;
  for (int row = first + warp; row < last; row += WARPS) {
    const size_t base = (size_t)row * D;
    const TX* xr = static_cast<const TX*>(a.x) + base;
    const TR* rr = static_cast<const TR*>(a.res) + base;
    const TX* gr = static_cast<const TX*>(args.g) + base;
    float z[CHUNKS][VEC], gv[CHUNKS][VEC];
    uint32_t keep_bits = 0;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col0 = (c * 32 + lane) * VEC;
      if (col0 < D) {
        float xv[VEC], rv[VEC];
        load<TX, VEC>(xr + col0, xv);
        load<TR, VEC>(rr + col0, rv);
        load<TX, VEC>(gr + col0, gv[c]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          bool keep;
          z[c][v] = pre_norm(a, xv[v], rv[v], row, col0 + v, keep);
          keep_bits |= (uint32_t)keep << (c * VEC + v);
          sum += z[c][v];
        }
      }
    }
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if ((c * 32 + lane) * VEC < D) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          z[c][v] -= mean;
          sq += z[c][v] * z[c][v];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)D + a.eps);
    // z becomes y = (z - mean) * rstd; the two row means of the backward
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col0 = (c * 32 + lane) * VEC;
      if (col0 < D) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          z[c][v] *= rstd;
          const float gg = gv[c][v] * param(a.gamma, col0 + v, g16);
          sa += gg;
          sb += gg * z[c][v];
        }
      }
    }
    const float ma = warp_sum(sa) / (float)D;
    const float mb = warp_sum(sb) / (float)D;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col0 = (c * 32 + lane) * VEC;
      if (col0 < D) {
        float dz[VEC], dh[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float gg = gv[c][v] * param(a.gamma, col0 + v, g16);
          dz[v] = rstd * (gg - ma - z[c][v] * mb);
          if (a.dropout)
            dh[v] = (keep_bits >> (c * VEC + v)) & 1u ? dz[v] / a.q : 0.f;
          else
            dh[v] = dz[v];
          float* s = mine + (c * VEC + v) * 32 + lane;
          s[0] += dh[v];
          s[S] += gv[c][v] * z[c][v];
          s[2 * S] += gv[c][v];
        }
        store<TX, VEC>(static_cast<TX*>(args.dx) + base + col0, dh);
        store<TR, VEC>(static_cast<TR*>(args.dres) + base + col0, dz);
      }
    }
  }
  __syncthreads();
  float* out = args.partial + (size_t)blockIdx.x * 3 * D;
  for (int i = threadIdx.x; i < 3 * D; i += THREADS) {
    const int k = i / D;
    const int at = k * S + slot_of<VEC>(i - k * D);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += acc[(size_t)w * 3 * S + at];
    out[i] = s;
  }
}

// One block per row at a time, any D; the block's column sums in its row
// of the scratch (column col owned by thread col % THREADS).  With
// `cached`, z waits in dynamic shared memory between the passes;
// otherwise each pass recomputes it.
template <typename TX, typename TR>
__global__ void __launch_bounds__(THREADS) ln_bwd_row(Args args,
                                                      int cached) {
  extern __shared__ float zs[];
  __shared__ float red[WARPS];
  const Inputs a = with_seed(args.in);
  const int D = a.D;
  const bool g16 = a.param_bf16 & 2;
  float* mine = args.partial + (size_t)blockIdx.x * 3 * D;
  for (int col = threadIdx.x; col < 3 * D; col += THREADS) mine[col] = 0.f;
  __syncthreads();  // a column's three sums were zeroed by other threads

  const int first = blockIdx.x * args.rows_per_block;
  const int last = min(a.N, first + args.rows_per_block);
  for (int row = first; row < last; ++row) {
    const size_t base = (size_t)row * D;
    const TX* xr = static_cast<const TX*>(a.x) + base;
    const TR* rr = static_cast<const TR*>(a.res) + base;
    const TX* gr = static_cast<const TX*>(args.g) + base;
    auto zval = [&](int col, bool& keep) {
      if (cached) {
        keep = a.dropout ? kept(a, row, col) : true;
        return zs[col];
      }
      return pre_norm(a, to_f32(xr[col]), to_f32(rr[col]), row, col, keep);
    };
    float s = 0.f;
    for (int col = threadIdx.x; col < D; col += THREADS) {
      bool keep;
      const float z =
          pre_norm(a, to_f32(xr[col]), to_f32(rr[col]), row, col, keep);
      if (cached) zs[col] = z;  // each thread rereads only its own columns
      s += z;
    }
    const float mean = block_sum(s, red) / (float)D;
    float sq = 0.f;
    for (int col = threadIdx.x; col < D; col += THREADS) {
      bool keep;
      const float d = zval(col, keep) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(block_sum(sq, red) / (float)D + a.eps);
    float sa = 0.f, sb = 0.f;
    for (int col = threadIdx.x; col < D; col += THREADS) {
      bool keep;
      const float y = (zval(col, keep) - mean) * rstd;
      const float gg = to_f32(gr[col]) * param(a.gamma, col, g16);
      sa += gg;
      sb += gg * y;
    }
    const float ma = block_sum(sa, red) / (float)D;
    const float mb = block_sum(sb, red) / (float)D;
    for (int col = threadIdx.x; col < D; col += THREADS) {
      bool keep;
      const float y = (zval(col, keep) - mean) * rstd;
      const float gv = to_f32(gr[col]);
      const float gg = gv * param(a.gamma, col, g16);
      const float dz = rstd * (gg - ma - y * mb);
      const float dh = a.dropout ? (keep ? dz / a.q : 0.f) : dz;
      static_cast<TX*>(args.dx)[base + col] = from_f32<TX>(dh);
      static_cast<TR*>(args.dres)[base + col] = from_f32<TR>(dz);
      mine[col] += dh;
      mine[D + col] += gv * y;
      mine[2 * D + col] += gv;
    }
  }
}

// dbias, dgamma, dbeta: the blocks' rows of the scratch summed in block
// order, one thread per (gradient, column), each written in its
// parameter's type.
__global__ void __launch_bounds__(THREADS)
    ln_bwd_fold(const float* partial, int blocks, int D, void* dbias,
                void* dgamma, void* dbeta, int param_bf16) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= 3 * D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * 3 * D + i];
  const int k = i / D, col = i - k * D;
  void* out = k == 0 ? dbias : (k == 1 ? dgamma : dbeta);
  if ((param_bf16 >> k) & 1)
    static_cast<__nv_bfloat16*>(out)[col] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(out)[col] = s;
}

// The warp kernel's shared memory at this D and vector width (1 pads D
// to a multiple of 32).
size_t warp_smem(int D, int vec) {
  return (size_t)WARPS * 3 * span(D, vec) * sizeof(float);
}

template <typename TX, typename TR>
cudaError_t prepare_warp() {
  const int most = (int)warp_smem(WARP_MAX_D, 1);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_warp<TX, TR, vec_width<TX, TR>()>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ln_bwd_warp<TX, TR, 1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most);
}

// Blocks of the row kernel that fit on the card at once.
template <typename TX, typename TR>
cudaError_t resident(int D, int* blocks) {
  int device, sms, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  if (D <= WARP_MAX_D) {
    err = prepare_warp<TX, TR>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_bwd_warp<TX, TR, vec_width<TX, TR>()>, THREADS,
          warp_smem(D, vec_width<TX, TR>()));
  } else {
    // the row kernel keeps its columns' sums in the scratch: two blocks an
    // SM hide each other's block-wide barriers
    per_sm = 2;
  }
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename TX, typename TR>
cudaError_t run(const Args& a, int blocks, void* dbias, void* dgamma,
                void* dbeta, cudaStream_t s) {
  const Inputs& in = a.in;
  if (in.D <= WARP_MAX_D) {
    constexpr int VN = vec_width<TX, TR>();
    cudaError_t err = prepare_warp<TX, TR>();
    if (err != cudaSuccess) return err;
    if (in.D % VN == 0 && aligned16(in.x) && aligned16(in.res) &&
        aligned16(a.g) && aligned16(a.dx) && aligned16(a.dres))
      ln_bwd_warp<TX, TR, VN>
          <<<blocks, THREADS, warp_smem(in.D, VN), s>>>(a);
    else
      ln_bwd_warp<TX, TR, 1><<<blocks, THREADS, warp_smem(in.D, 1), s>>>(a);
  } else {
    const int cached = in.D <= ROW_CACHE_D;
    const size_t smem = cached ? (size_t)in.D * sizeof(float) : 0;
    cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_row<TX, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(ROW_CACHE_D * sizeof(float)));
    if (err != cudaSuccess) return err;
    ln_bwd_row<TX, TR><<<blocks, THREADS, smem, s>>>(a, cached);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_fold<<<(3 * in.D + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      a.partial, blocks, in.D, dbias, dgamma, dbeta, in.param_bf16);
  return cudaGetLastError();
}

// The one switch over the two types: 0 = float32, 1 = bfloat16.
template <template <typename, typename> class F, typename... A>
cudaError_t by_types(int dtype, int res_dtype, A... args) {
  if (dtype == 0 && res_dtype == 0) return F<float, float>::call(args...);
  if (dtype == 0 && res_dtype == 1)
    return F<float, __nv_bfloat16>::call(args...);
  if (dtype == 1 && res_dtype == 0)
    return F<__nv_bfloat16, float>::call(args...);
  if (dtype == 1 && res_dtype == 1)
    return F<__nv_bfloat16, __nv_bfloat16>::call(args...);
  return cudaErrorInvalidValue;
}

template <typename TX, typename TR>
struct Resident {
  static cudaError_t call(int D, int* blocks) {
    return resident<TX, TR>(D, blocks);
  }
};

template <typename TX, typename TR>
struct Run {
  static cudaError_t call(const Args* a, int blocks, void* dbias,
                          void* dgamma, void* dbeta, cudaStream_t s) {
    return run<TX, TR>(*a, blocks, dbias, dgamma, dbeta, s);
  }
};

}  // namespace

// The number of blocks of fused_ln_bwd that fit on the current device at
// once for rows of D values of these types: the most `blocks` worth
// passing (the scratch is (blocks, 3, D) fp32).  Returns a cudaError_t.
extern "C" int fused_ln_bwd_resident(int D, int dtype, int res_dtype,
                                     int* blocks) {
  cudaGetLastError();
  if (D <= 0) return (int)cudaErrorInvalidValue;
  return (int)by_types<Resident>(dtype, res_dtype, D, blocks);
}

// g, x, dx in `dtype`; residual, dres in `res_dtype` (0 = float32,
// 1 = bfloat16); param_bf16: bit 0 bias/dbias, bit 1 gamma/dgamma, bit 2
// beta/dbeta are bf16 (else fp32).  `partial` holds blocks x 3 x D fp32.
// seed: one int64 in device memory, read only with dropout.  Two launches
// on `stream`: the rows, then the fold of the column sums.  Returns a
// cudaError_t (0 = launched).
extern "C" int fused_ln_bwd(const void* g, const void* x, const void* res,
                            const void* bias, const void* gamma,
                            const void* beta, void* dx, void* dres,
                            void* dbias, void* dgamma, void* dbeta,
                            float* partial, int blocks, int N, int D,
                            int dtype, int res_dtype, int param_bf16,
                            const unsigned long long* seed, int dropout,
                            float p, float q, float eps, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (N <= 0 || D <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const Args a{
      {x, res, bias, gamma, beta, N, D, param_bf16, seed, 0u, dropout, p, q,
       eps},
      g, dx, dres, partial, (N + blocks - 1) / blocks};
  return (int)by_types<Run>(dtype, res_dtype, &a, blocks, dbias, dgamma,
                            dbeta, static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_ln_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
