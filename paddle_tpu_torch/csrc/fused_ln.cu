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
// are each fp32, bf16 or fp16, in their own types, as the reference's
// kernel reads them (fused_ln_common.cuh `by_types` names the pairs); bias,
// gamma and beta each fp32, bf16 or fp16.  The dropout mask is
// the reference's Murmur3-finaliser hash of the element index mod 2^32
// (ops/pallas/fused_ln.py:33), bit for bit: the backward (fused_ln_bwd.cu)
// recomputes it from (seed, index) and no mask is stored.  The shared
// element math is in fused_ln_common.cuh.
//
// What bounds it on an H100: one read of x and of the residual and one
// write of out, a few tens of operations per element: memory.  At N
// 16384, D 768 that is 151 MB in fp32 (0.0451 ms at 3.35 TB/s), 75.5 MB
// in bf16 or fp16 (0.0225 ms) and 100.7 MB with 16-bit x over an fp32
// residual (0.0301 ms).  In 16 bits an element is only 6 bytes against a
// hash, a true division, conversions and two row reductions, so the
// instructions and their latency come close to the memory time, and the
// one-warp-a-row kernel below reached 49-53% of the bound there (38-39%
// with fp32 parameters): a type switch and a scalar load for each of
// bias, gamma and beta at every element, a row loaded only when its warp
// reached it, a float mask test.  On an H100 (700 W) at N 16384, D 768, p
// 0.1, ln_fwd_tile takes the 16-bit pairs to 0.032-0.033 ms (69-71% of
// the bound), 16-bit x over an fp32 residual to 0.051-0.052 (58%;
// PERF.md §6).
//
// Design:
// - 16-bit x (ln_fwd_tile; D <= 1024, D % 8 == 0, x, residual and out
//   16-byte aligned): the row tile of fused_ln_common.cuh, which
//   ln_bwd_tile runs too.  A lane holds the same 8-column chunks in every
//   row; a warp's next rows move into its ring in shared memory on
//   cp.async while it computes the current one; bias, gamma and beta wait
//   in shared memory in fp32 in the lanes' layout, read once per block,
//   so the row loop reads no type code; the mask is the integer test of
//   the hash's top 24 bits; the output goes out in 16-byte stores,
//   rounded two values at a time.  Persistent blocks, as many as fit on
//   the card at once (fused_ln_resident), walk the rows grid-strided.
// - fp32 x, and 16-bit x the tile does not take (fused_ln_warp): one warp
//   per row holds the row in registers (at most 32 values a lane), loaded
//   16 bytes at a time where D and the alignment allow (fp32: 4 values;
//   x and residual of different types: 4 values, 16 and 8 bytes), else
//   one value at a time.  The hash runs in registers; mean and centred
//   variance come from two warp shuffle reductions over the registers,
//   with no second read of the row.  Eight rows per 256-thread block.
// - D > 1024 (fused_ln_row): one 256-thread block per row: the row's z
//   values wait in 48 KB of dynamic shared memory (D <= 12288, opted in
//   beyond the default limit, which the block sums' static array also
//   takes from), else each pass recomputes them from x and the residual.

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
  const int gc = param_code(a.param_types, 1),
            bc = param_code(a.param_types, 2);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col0 = (c * 32 + lane) * VEC;
    if (col0 < a.D) {
      float y[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        y[v] = z[c][v] * rstd * param(a.gamma, col0 + v, gc) +
               param(a.beta, col0 + v, bc);
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
  const int gc = param_code(a.param_types, 1),
            bc = param_code(a.param_types, 2);
  for (int col = threadIdx.x; col < a.D; col += THREADS)
    orow[col] = from_f32<TX>((zval(col) - mean) * rstd *
                                 param(a.gamma, col, gc) +
                             param(a.beta, col, bc));
}

// ---------------------------------------------------------------------------
// The 16-bit tile (ln_fwd_tile)
// ---------------------------------------------------------------------------
// Warps of a block, a row each, at most, and rows in a warp's ring: 32 and
// two (one row in flight while one is computed), one block an SM.  Chosen
// by measurement (PERF.md §6): 32 warps of two stages ran the
// 16-bit pairs 5-7% faster than 16 warps of three, and 16 warps of four,
// 24 of three and 8 of three (two blocks an SM) slower again; a lane's
// sums split four ways, and an fp32 residual copied in coalesced 512-byte
// sweeps, gained nothing.
constexpr int FWD_WARPS = 32;
constexpr int FWD_STAGES = 2;

// Dynamic shared memory of ln_fwd_tile at w warps: every warp's ring (x
// and the residual), then bias, gamma and beta in fp32 (NC x 256 each)
template <typename TX, typename TR, int NC>
__host__ __device__ constexpr size_t fwd_smem_at(int w) {
  return (size_t)w * FWD_STAGES * ring_slots<TX, TR, 1>(NC) * 16 +
         3 * (size_t)NC * TILE_COLS * sizeof(float);
}

// Warps of a block: FWD_WARPS, or 8 fewer at a time until the block fits
// an SM's shared memory (24 at D 1024 or beside an fp32 residual, 16 at
// both)
template <typename TX, typename TR, int NC>
__host__ __device__ constexpr int fwd_warps() {
  int w = FWD_WARPS;
  while (w > 8 && fwd_smem_at<TX, TR, NC>(w) > 232448) w -= 8;
  return w;
}

template <typename TX, typename TR, int NC>
__host__ __device__ constexpr size_t fwd_smem() {
  return fwd_smem_at<TX, TR, NC>(fwd_warps<TX, TR, NC>());
}

// One warp per row, each lane NC chunks of 8 columns, the block's warps
// on rows blockIdx.x * W + warp + k * gridDim.x * W through their rings.
template <typename TX, typename TR, int NC>
__global__ void __launch_bounds__(fwd_warps<TX, TR, NC>() * 32, 1)
    ln_fwd_tile(Args args) {
  constexpr int W = fwd_warps<TX, TR, NC>();
  constexpr int ST = FWD_STAGES;
  constexpr int SLOTS = ring_slots<TX, TR, 1>(NC);
  static_assert(fwd_smem<TX, TR, NC>() <= 232448, "one block an SM");
  constexpr int RS = NC * 32 * pieces<TX>();  // the residual's part
  extern __shared__ uint4 smem[];
  const Inputs a = with_seed(args.in);
  const int D = a.D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int step = gridDim.x * W;
  uint4* ring = smem + warp * ST * SLOTS;
  auto fetch = [&](int row, int s) {
    copy_row<TX, TR, NC, 1>(ring + s * SLOTS, lane, D, (size_t)row * D, a.x,
                            a.res, nullptr);
  };
  const int first = blockIdx.x * W + warp;
  ring_prefetch<ST>(first, a.N, step, fetch);

  float* ps = reinterpret_cast<float*>(smem + W * ST * SLOTS);
  stage_params<NC, 3>(ps, a, threadIdx.x, W * 32);
  __syncthreads();
  const float4* bias_s = reinterpret_cast<const float4*>(ps);
  const float4* gamma_s = bias_s + 2 * NC * 32;
  const float4* beta_s = gamma_s + 2 * NC * 32;
  const uint32_t floor_keep = keep_floor(a.p);
  TX* out = static_cast<TX*>(args.out);

  for (int row = first, s = 0; row < a.N; row += step, s = ring_next<ST>(s)) {
    ring_advance<ST>(row, s, a.N, step, fetch);
    const uint4* st = ring + s * SLOTS;
    float z[NC][TILE_VEC];
    uint32_t keep_bits;
    const float rstd = tile_row<TX, TR, NC>(a, st, st + RS, bias_s, lane,
                                            row, floor_keep, z, keep_bits);
    TX* orow = out + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col0 = (c * 32 + lane) * TILE_VEC;
      if (col0 < D) {
        float gm[TILE_VEC], bt[TILE_VEC], y[TILE_VEC];
        param8(gamma_s, c, lane, gm);
        param8(beta_s, c, lane, bt);
#pragma unroll
        for (int v = 0; v < TILE_VEC; ++v)
          y[v] = z[c][v] * rstd * gm[v] + bt[v];
        store8<TX>(orow + col0, y);
      }
    }
  }
  tile::cp_async_wait<0>();
}

// f(kernel, its dynamic shared memory, its warps) for the 16-bit tile of
// nc chunks (fp32 x instantiates none)
template <typename TX, typename TR, int NC, typename F>
cudaError_t on_tile_nc(F&& f) {
  return f(ln_fwd_tile<TX, TR, NC>, fwd_smem<TX, TR, NC>(),
           fwd_warps<TX, TR, NC>());
}

template <typename TX, typename TR, typename F>
cudaError_t on_tile(int nc, F&& f) {
  if constexpr (sizeof(TX) == 2) {
    switch (nc) {
      case 3: return on_tile_nc<TX, TR, 3>(f);
      case 4: return on_tile_nc<TX, TR, 4>(f);
    }
  }
  return cudaErrorInvalidValue;
}

__host__ cudaError_t allow_smem(void (*kernel)(Args), size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of the tile that fit on the current device at once for rows of
// D values of these types (0 where the tile does not take them).
template <typename TX, typename TR>
cudaError_t resident(int D, int* blocks) {
  *blocks = 0;
  const int nc = tile_chunks<TX>(D);
  if (!nc) return cudaSuccess;
  int device, sms, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = on_tile<TX, TR>(
        nc, [&](void (*kernel)(Args), size_t smem, int warps) {
          cudaError_t e = allow_smem(kernel, smem);
          if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, warps * 32, smem);
          return e;
        });
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// The kernels, and the route taken: 0 ln_fwd_tile, 1 fused_ln_warp, 2
// fused_ln_row.
template <typename TX, typename TR>
cudaError_t run(const Args& a, int blocks, int* route, cudaStream_t s) {
  const Inputs& in = a.in;
  const bool aligned =
      aligned16(in.x) && aligned16(in.res) && aligned16(a.out);
  if (const int nc = aligned ? tile_chunks<TX>(in.D) : 0) {
    if (blocks <= 0) return cudaErrorInvalidValue;
    *route = 0;
    const cudaError_t err = on_tile<TX, TR>(
        nc, [&](void (*kernel)(Args), size_t smem, int warps) {
          const int needed = (in.N + warps - 1) / warps;
          const int grid = blocks < needed ? blocks : needed;
          const cudaError_t e = allow_smem(kernel, smem);
          if (e == cudaSuccess) kernel<<<grid, warps * 32, smem, s>>>(a);
          return e;
        });
    if (err != cudaSuccess) return err;
  } else if (in.D <= WARP_MAX_D) {
    constexpr int VN = warp_vec<TX, TR>();
    *route = 1;
    const int rows_blocks = (in.N + WARPS - 1) / WARPS;
    if (in.D % VN == 0 && aligned)
      fused_ln_warp<TX, TR, VN><<<rows_blocks, THREADS, 0, s>>>(a);
    else
      fused_ln_warp<TX, TR, 1><<<rows_blocks, THREADS, 0, s>>>(a);
  } else {
    *route = 2;
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

template <typename TX, typename TR>
struct Run {
  static cudaError_t call(const Args* a, int blocks, int* route,
                          cudaStream_t s) {
    return run<TX, TR>(*a, blocks, route, s);
  }
};

template <typename TX, typename TR>
struct Resident {
  static cudaError_t call(int D, int* blocks) {
    return resident<TX, TR>(D, blocks);
  }
};

}  // namespace

// The blocks of the 16-bit tile that fit on the current device at once
// for rows of D values of these types, the most `blocks` worth passing to
// fused_ln (0 where the tile does not take them: fp32 x, D > 1024, D % 8
// != 0).  Returns a cudaError_t.
extern "C" int fused_ln_resident(int D, int dtype, int res_dtype,
                                 int* blocks) {
  cudaGetLastError();
  if (D <= 0) return (int)cudaErrorInvalidValue;
  return (int)fln::by_types<Resident>(dtype, res_dtype, D, blocks);
}

// dtype (x, out) and res_dtype (residual): 0 = float32, 1 = bfloat16,
// 2 = float16, in the pairs of `by_types`.  param_types: the type codes of
// bias (bits 0-1), gamma (2-3) and beta (4-5).
// seed: one int64 in device memory, read only with dropout.  blocks: the
// tile's grid (fused_ln_resident; at most one block per warps' rows is
// launched), read where the tile takes the rows and then > 0.  route: the
// kernel launched (0 ln_fwd_tile, 1 fused_ln_warp, 2 fused_ln_row).
// Returns a cudaError_t (0 = launched).
extern "C" int fused_ln(const void* x, const void* res, const void* bias,
                        const void* gamma, const void* beta, void* out, int N,
                        int D, int dtype, int res_dtype, int param_types,
                        const unsigned long long* seed, int dropout,
                        float p, float q, float eps, int blocks,
                        int* route, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const Args a{
      {x, res, bias, gamma, beta, N, D, param_types, seed, 0u, dropout, p,
       q, eps},
      out};
  return (int)fln::by_types<Run>(dtype, res_dtype, &a, blocks, route,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
