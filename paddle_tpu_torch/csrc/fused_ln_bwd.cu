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
// The mask is the forward's (fused_ln_common.cuh) bit for bit.  dx is
// written in x's type, dres in the residual's, each column gradient in
// its own parameter's type, rounded once from the fp32 sum.
//
// What bounds it on an H100: g, x and the residual read once, dx and dres
// written once, a few tens of operations per element: memory, at the
// bound.  At N 16384, D 768 that is 5 x 50.3 MB = 251.7 MB in fp32
// (0.0751 ms at 3.35 TB/s), 125.8 MB in bf16 or fp16 (0.0376 ms) and
// 176.2 MB with 16-bit x over an fp32 residual (0.0526 ms); the column
// sums add a (blocks, 3, D) fp32 scratch, written once and read once.
// In practice the 16-bit rows were bound by instructions and latency
// before this design: the one-warp-a-row kernel below spent three
// shared-memory read-modify-writes an element on the column sums, read
// gamma twice through a type switch, divided by q twice and loaded each
// row only when it reached it, 34% of the bound.  On an H100 (700 W) at
// N 16384, D 768, p 0.1, the 16-bit pairs now take 0.062 ms (bf16, fp16)
// and 0.086 ms (16-bit x over an fp32 residual) against 0.108-0.121
// before, ~61% of their bounds; fp32 0.130 ms, 58% (PERF.md §6).
//
// Design: the column sums are what a row-parallel kernel cannot do in one
// pass without atomics, and atomics would make two runs differ in their
// last bits.  So a block takes a contiguous range of rows, a warp one row
// at a time, and each warp keeps its own column sums, which no other warp
// touches; at the end the block adds its warps' sums in warp order into
// its row of the scratch, and a second launch adds the blocks' rows in a
// fixed order into dbias, dgamma and dbeta.  The grid is the number of
// blocks that fit on the card at once (occupancy API), one wave.
//
// - 16-bit x (ln_bwd_tile; D <= 1024, D % 8 == 0, operands 16-byte
//   aligned), on the row tile of fused_ln_common.cuh that the forward's
//   ln_fwd_tile runs too (its ring, parameter staging and row prologue):
//   a lane holds the same 8-column chunks in every row, so its
//   column sums stay in registers (3 x 8 floats a chunk).  Each warp's
//   next rows move into its ring in shared memory on cp.async while it
//   computes the current one (three rows beside a 16-bit residual, two
//   beside fp32).  Bias and gamma wait in shared memory in fp32, read
//   once per block.  The dropout test compares the hash's top 24 bits
//   with ceil(p 2^24) as integers (the forward's float compare, exactly);
//   z divides by q as the forward does; dx multiplies dz by 1/q, within
//   one fp32 rounding of dz / q before its 16-bit rounding.  A block is
//   16 warps, one block an SM (8 at D > 768, whose sums take more
//   registers).
// - fp32 x, and 16-bit x the tile kernel does not take (ln_bwd_warp): one
//   warp per row, the row in registers (4-, 8- or 16-byte loads), each
//   warp's column sums in its own (3, D) slice of shared memory, laid out
//   lane-major so that a warp's 32 adds hit 32 banks.
// - D > 1024 (ln_bwd_row): the whole block per row, z in shared memory as
//   in the forward (D <= 12288, else recomputed), the block's column sums
//   in its row of the scratch, each column owned by one thread.
//
// Every division by q other than the 16-bit dx's is a true fp32 division
// (no fast-math flags), as the vjp of h / (1 - p) gives it.

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
  const int gc = param_code(a.param_types, 1);
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
          const float gg = gv[c][v] * param(a.gamma, col0 + v, gc);
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
          const float gg = gv[c][v] * param(a.gamma, col0 + v, gc);
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

// ---------------------------------------------------------------------------
// The 16-bit warp path: the row tile of fused_ln_common.cuh (x bf16 or
// fp16, the residual in x's type or fp32, D <= 1024, D % 8 == 0, every
// row operand 16-byte aligned); a lane's share of the column sums stays
// in registers, 3 x NC x 8 floats.
// ---------------------------------------------------------------------------
// Warps of a block, a row each: 16 (one block an SM, 128 registers a
// thread) while NC < 4; at NC 4 the sums take more, 8.
template <int NC>
__host__ __device__ constexpr int tile_warps() {
  return NC < 4 ? 16 : 8;
}

// Rows in a warp's ring: three (two in flight while one is computed)
// where the residual is 16-bit, two beside an fp32 residual, whose rows
// take the shared memory a third would need.
template <typename TR>
__host__ __device__ constexpr int tile_stages() {
  return sizeof(TR) == 2 ? 3 : 2;
}

// Dynamic shared memory of ln_bwd_tile: every warp's ring (x, residual
// and g), then bias and gamma in fp32 (NC x 256 each)
template <typename TX, typename TR, int NC>
__host__ __device__ constexpr size_t tile_smem() {
  return (size_t)tile_warps<NC>() * tile_stages<TR>() *
             ring_slots<TX, TR, 2>(NC) * 16 +
         2 * (size_t)NC * TILE_COLS * sizeof(float);
}

// One warp per row, each lane NC chunks of 8 columns, the rows through
// the warp's ring; bias and gamma wait in shared memory in
// fp32, read once from device memory per block.  At the end the block's
// warps add their registers' column sums in warp order, one gradient at a
// time through shared memory, into the block's row of the scratch.
template <typename TX, typename TR, int NC>
__global__ void __launch_bounds__(tile_warps<NC>() * 32, 1)
    ln_bwd_tile(Args args) {
  constexpr int W = tile_warps<NC>();
  constexpr int ST = tile_stages<TR>();
  constexpr int SLOTS = ring_slots<TX, TR, 2>(NC);
  static_assert(tile_smem<TX, TR, NC>() <= 232448, "one block an SM");
  constexpr int RS = NC * 32 * pieces<TX>();       // the residual's part
  constexpr int GS = RS + NC * 32 * pieces<TR>();  // g's
  extern __shared__ uint4 smem[];
  const Inputs a = with_seed(args.in);
  const int D = a.D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * args.rows_per_block;
  const int last = min(a.N, first + args.rows_per_block);
  uint4* ring = smem + warp * ST * SLOTS;
  auto fetch = [&](int row, int s) {
    copy_row<TX, TR, NC, 2>(ring + s * SLOTS, lane, D, (size_t)row * D, a.x,
                            a.res, args.g);
  };
  // the warp's first ST - 1 rows in flight before anything waits
  ring_prefetch<ST>(first + warp, last, W, fetch);

  float* ps = reinterpret_cast<float*>(smem + W * ST * SLOTS);
  stage_params<NC, 2>(ps, a, threadIdx.x, W * 32);
  __syncthreads();
  const float4* bias_s = reinterpret_cast<const float4*>(ps);
  const float4* gamma_s = bias_s + 2 * NC * 32;

  const uint32_t floor_keep = keep_floor(a.p);
  const float inv_q = 1.0f / a.q;
  float s_bias[NC][TILE_VEC], s_gamma[NC][TILE_VEC], s_beta[NC][TILE_VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int v = 0; v < TILE_VEC; ++v)
      s_bias[c][v] = s_gamma[c][v] = s_beta[c][v] = 0.f;

  for (int row = first + warp, s = 0; row < last;
       row += W, s = ring_next<ST>(s)) {
    ring_advance<ST>(row, s, last, W, fetch);
    const uint4* st = ring + s * SLOTS;
    // z = residual + dropout(x + bias) centred, the keep bits, rstd
    float z[NC][TILE_VEC];
    uint32_t keep_bits;
    const float rstd = tile_row<TX, TR, NC>(a, st, st + RS, bias_s, lane,
                                            row, floor_keep, z, keep_bits);

    // z becomes y = (z - mean) * rstd; the two row means of the backward
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if ((c * 32 + lane) * TILE_VEC < D) {
        float gv[TILE_VEC], gm[TILE_VEC];
        unpack8<TX>(st + GS, c, lane, gv);
        param8(gamma_s, c, lane, gm);
#pragma unroll
        for (int v = 0; v < TILE_VEC; ++v) {
          z[c][v] *= rstd;
          const float gg = gv[v] * gm[v];
          sa += gg;
          sb += gg * z[c][v];
        }
      }
    }
    warp_sum2(sa, sb);
    const float ma = sa / (float)D;
    const float mb = sb / (float)D;

    // dres = dz, dx = dropout's mask and scale on dz; the column terms
    const size_t base = (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col0 = (c * 32 + lane) * TILE_VEC;
      if (col0 < D) {
        float gv[TILE_VEC], gm[TILE_VEC];
        unpack8<TX>(st + GS, c, lane, gv);
        param8(gamma_s, c, lane, gm);
        float dz[TILE_VEC], dh[TILE_VEC];
#pragma unroll
        for (int v = 0; v < TILE_VEC; ++v) {
          const float gg = gv[v] * gm[v];
          dz[v] = rstd * (gg - ma - z[c][v] * mb);
          // a 16-bit dx: dz times 1/q, within one fp32 rounding of dz / q
          if (a.dropout)
            dh[v] = (keep_bits >> (c * TILE_VEC + v)) & 1u ? dz[v] * inv_q
                                                           : 0.f;
          else
            dh[v] = dz[v];
          s_bias[c][v] += dh[v];
          s_gamma[c][v] += gv[v] * z[c][v];
          s_beta[c][v] += gv[v];
        }
        store8<TX>(static_cast<TX*>(args.dx) + base + col0, dh);
        store8<TR>(static_cast<TR*>(args.dres) + base + col0, dz);
      }
    }
  }
  tile::cp_async_wait<0>();
  __syncthreads();  // every warp is past its ring: it holds the sums now

  // the block's column sums, gradient by gradient: each warp's registers
  // into its row of `red`, then the rows added in warp order
  float* red = reinterpret_cast<float*>(smem);  // W x NC x 256
  float* out = args.partial + (size_t)blockIdx.x * 3 * D;
  auto flush = [&](const float (&sums)[NC][TILE_VEC], int k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4* at = reinterpret_cast<float4*>(
          red + warp * NC * TILE_COLS + (c * 32 + lane) * TILE_VEC);
      at[0] = make_float4(sums[c][0], sums[c][1], sums[c][2], sums[c][3]);
      at[1] = make_float4(sums[c][4], sums[c][5], sums[c][6], sums[c][7]);
    }
    __syncthreads();
    for (int col = threadIdx.x; col < D; col += W * 32) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) t += red[w * NC * TILE_COLS + col];
      out[k * D + col] = t;
    }
    __syncthreads();
  };
  flush(s_bias, 0);
  flush(s_gamma, 1);
  flush(s_beta, 2);
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
  const int gc = param_code(a.param_types, 1);
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
      const float gg = to_f32(gr[col]) * param(a.gamma, col, gc);
      sa += gg;
      sb += gg * y;
    }
    const float ma = block_sum(sa, red) / (float)D;
    const float mb = block_sum(sb, red) / (float)D;
    for (int col = threadIdx.x; col < D; col += THREADS) {
      bool keep;
      const float y = (zval(col, keep) - mean) * rstd;
      const float gv = to_f32(gr[col]);
      const float gg = gv * param(a.gamma, col, gc);
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

// dbias, dgamma, dbeta: the blocks' rows of the scratch summed, each
// written in its parameter's type.  A block takes 32 of the 3 x D
// (gradient, column) sums, lane l the sum 32 * blockIdx.x + l; warp w adds
// the rows w, w + WARPS, ... in order, then warp 0 adds the warps' sums in
// warp order: a fixed order, the same in every run.
__global__ void __launch_bounds__(THREADS)
    ln_bwd_fold(const float* partial, int blocks, int D, void* dbias,
                void* dgamma, void* dbeta, int param_types) {
  __shared__ float part[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < 3 * D) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += WARPS)
      s += partial[(size_t)b * 3 * D + i];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || i >= 3 * D) return;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += part[w][lane];
  const int k = i / D, col = i - k * D;
  store_code(k == 0 ? dbias : (k == 1 ? dgamma : dbeta), col,
             param_code(param_types, k), t);
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
      ln_bwd_warp<TX, TR, warp_vec<TX, TR>()>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ln_bwd_warp<TX, TR, 1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most);
}

// f(kernel, its dynamic shared memory, its threads) for the 16-bit kernel
// of nc chunks (fp32 x instantiates none)
template <typename TX, typename TR, int NC, typename F>
cudaError_t on_tile_nc(F&& f) {
  return f(ln_bwd_tile<TX, TR, NC>, tile_smem<TX, TR, NC>(),
           tile_warps<NC>() * 32);
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

// Blocks of the first launch that fit on the card at once.
template <typename TX, typename TR>
cudaError_t resident(int D, int* blocks) {
  int device, sms, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  if (const int nc = tile_chunks<TX>(D)) {
    err = on_tile<TX, TR>(
        nc, [&](void (*kernel)(Args), size_t smem, int threads) {
          cudaError_t e = allow_smem(kernel, smem);
          if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, smem);
          return e;
        });
  } else if (D <= WARP_MAX_D) {
    err = prepare_warp<TX, TR>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_bwd_warp<TX, TR, warp_vec<TX, TR>()>, THREADS,
          warp_smem(D, warp_vec<TX, TR>()));
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
  const bool aligned = aligned16(in.x) && aligned16(in.res) &&
                       aligned16(a.g) && aligned16(a.dx) &&
                       aligned16(a.dres);
  cudaError_t err = cudaSuccess;
  if (const int nc = aligned ? tile_chunks<TX>(in.D) : 0) {
    err = on_tile<TX, TR>(
        nc, [&](void (*kernel)(Args), size_t smem, int threads) {
          const cudaError_t e = allow_smem(kernel, smem);
          if (e == cudaSuccess) kernel<<<blocks, threads, smem, s>>>(a);
          return e;
        });
  } else if (in.D <= WARP_MAX_D) {
    constexpr int VN = warp_vec<TX, TR>();
    err = prepare_warp<TX, TR>();
    if (err != cudaSuccess) return err;
    if (in.D % VN == 0 && aligned)
      ln_bwd_warp<TX, TR, VN>
          <<<blocks, THREADS, warp_smem(in.D, VN), s>>>(a);
    else
      ln_bwd_warp<TX, TR, 1><<<blocks, THREADS, warp_smem(in.D, 1), s>>>(a);
  } else {
    const int cached = in.D <= ROW_CACHE_D;
    const size_t smem = cached ? (size_t)in.D * sizeof(float) : 0;
    err = cudaFuncSetAttribute(ln_bwd_row<TX, TR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(ROW_CACHE_D * sizeof(float)));
    if (err != cudaSuccess) return err;
    ln_bwd_row<TX, TR><<<blocks, THREADS, smem, s>>>(a, cached);
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_fold<<<(3 * in.D + 31) / 32, THREADS, 0, s>>>(
      a.partial, blocks, in.D, dbias, dgamma, dbeta, in.param_types);
  return cudaGetLastError();
}

// ops/_build.py PARTS compiles this source in five parts, BUILD_PART 0
// to 4, and links them: nvcc compiles one unit on one core, and the type
// pairs' kernels took ~67 s in one unit, ~43 s in three (one per x type)
// once ln_bwd_tile's instantiations came (on the H100 machine's CPU).
// Part 0 holds fp32 x beside each residual type, parts 1 and 2 bf16 x
// beside bf16 and fp32, parts 3 and 4 fp16 x beside fp16 and fp32 (the
// pairs of fused_ln_common.cuh `by_types`).  Each part defines its pairs'
// kernels and two entry points; part 0 also the library's, which pick a
// part by the pair.
#ifndef BUILD_PART
#error "compile with -DBUILD_PART=0 ... 4 (ops/_build.py PARTS)"
#endif

template <int K>
struct Part;
template <>
struct Part<1> {
  using TX = __nv_bfloat16;
  using TR = __nv_bfloat16;
};
template <>
struct Part<2> {
  using TX = __nv_bfloat16;
  using TR = float;
};
template <>
struct Part<3> {
  using TX = __half;
  using TR = __half;
};
template <>
struct Part<4> {
  using TX = __half;
  using TR = float;
};

// F<TX, TR>::call(args...) for part K's pair with the residual's type code
// (part 0: fp32 x beside any residual type).
template <int K, template <typename, typename> class F, typename... A>
cudaError_t by_res(int res_dtype, A... args) {
  if constexpr (K == 0) {
    switch (res_dtype) {
      case F32: return F<float, float>::call(args...);
      case BF16: return F<float, __nv_bfloat16>::call(args...);
      case F16: return F<float, __half>::call(args...);
      default: return cudaErrorInvalidValue;
    }
  } else {
    return F<typename Part<K>::TX, typename Part<K>::TR>::call(args...);
  }
}

template <typename TX, typename TR>
struct Resident {
  static cudaError_t call(int D, int* blocks) {
    return resident<TX, TR>(D, blocks);
  }
};

template <typename TX, typename TR>
struct Run {
  static cudaError_t call(const void* a, int blocks, void* dbias,
                          void* dgamma, void* dbeta, cudaStream_t s) {
    return run<TX, TR>(*static_cast<const Args*>(a), blocks, dbias, dgamma,
                       dbeta, s);
  }
};

}  // namespace

// This part's entry points, named for it (fused_ln_bwd_part<K>, ...);
// `a` is an Args of this file.
#define PART_NAME(name) PART_NAME_(name, BUILD_PART)
#define PART_NAME_(name, k) PART_NAME__(name, k)
#define PART_NAME__(name, k) name##k

extern "C" int PART_NAME(fused_ln_bwd_resident_part)(int res_dtype, int D,
                                                     int* blocks) {
  return (int)by_res<BUILD_PART, Resident>(res_dtype, D, blocks);
}

extern "C" int PART_NAME(fused_ln_bwd_part)(int res_dtype, const void* a,
                                            int blocks, void* dbias,
                                            void* dgamma, void* dbeta,
                                            void* s) {
  return (int)by_res<BUILD_PART, Run>(res_dtype, a, blocks, dbias, dgamma,
                                      dbeta, static_cast<cudaStream_t>(s));
}

#if BUILD_PART == 0
// The other parts' entry points, which the library's call.
#define PART_DECL(k)                                                        \
  int fused_ln_bwd_resident_part##k(int res_dtype, int D, int* blocks);    \
  int fused_ln_bwd_part##k(int res_dtype, const void* a, int blocks,       \
                           void* dbias, void* dgamma, void* dbeta, void* s);
extern "C" {
PART_DECL(1)
PART_DECL(2)
PART_DECL(3)
PART_DECL(4)
}

// The part that holds the pair (x type, residual type), or -1.
static int part_of(int dtype, int res_dtype) {
  switch (dtype * 3 + res_dtype) {
    case fln::F32 * 3 + fln::F32:
    case fln::F32 * 3 + fln::BF16:
    case fln::F32 * 3 + fln::F16: return 0;
    case fln::BF16 * 3 + fln::BF16: return 1;
    case fln::BF16 * 3 + fln::F32: return 2;
    case fln::F16 * 3 + fln::F16: return 3;
    case fln::F16 * 3 + fln::F32: return 4;
    default: return -1;
  }
}

// The number of blocks of fused_ln_bwd that fit on the current device at
// once for rows of D values of these types: the most `blocks` worth
// passing (the scratch is (blocks, 3, D) fp32).  Returns a cudaError_t.
extern "C" int fused_ln_bwd_resident(int D, int dtype, int res_dtype,
                                     int* blocks) {
  cudaGetLastError();
  if (D <= 0) return (int)cudaErrorInvalidValue;
  switch (part_of(dtype, res_dtype)) {
    case 0: return fused_ln_bwd_resident_part0(res_dtype, D, blocks);
    case 1: return fused_ln_bwd_resident_part1(res_dtype, D, blocks);
    case 2: return fused_ln_bwd_resident_part2(res_dtype, D, blocks);
    case 3: return fused_ln_bwd_resident_part3(res_dtype, D, blocks);
    case 4: return fused_ln_bwd_resident_part4(res_dtype, D, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g, x, dx in `dtype`; residual, dres in `res_dtype` (0 = float32,
// 1 = bfloat16, 2 = float16, in the pairs of `by_types`); param_types:
// the type codes of bias/dbias (bits 0-1), gamma/dgamma (2-3) and
// beta/dbeta (4-5).  `partial` holds blocks x 3 x D fp32.
// seed: one int64 in device memory, read only with dropout.  Two launches
// on `stream`: the rows, then the fold of the column sums.  Returns a
// cudaError_t (0 = launched).
extern "C" int fused_ln_bwd(const void* g, const void* x, const void* res,
                            const void* bias, const void* gamma,
                            const void* beta, void* dx, void* dres,
                            void* dbias, void* dgamma, void* dbeta,
                            float* partial, int blocks, int N, int D,
                            int dtype, int res_dtype, int param_types,
                            const unsigned long long* seed, int dropout,
                            float p, float q, float eps, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (N <= 0 || D <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const Args a{
      {x, res, bias, gamma, beta, N, D, param_types, seed, 0u, dropout, p,
       q, eps},
      g, dx, dres, partial, (N + blocks - 1) / blocks};
  switch (part_of(dtype, res_dtype)) {
    case 0: return fused_ln_bwd_part0(res_dtype, &a, blocks, dbias, dgamma,
                                      dbeta, stream);
    case 1: return fused_ln_bwd_part1(res_dtype, &a, blocks, dbias, dgamma,
                                      dbeta, stream);
    case 2: return fused_ln_bwd_part2(res_dtype, &a, blocks, dbias, dgamma,
                                      dbeta, stream);
    case 3: return fused_ln_bwd_part3(res_dtype, &a, blocks, dbias, dgamma,
                                      dbeta, stream);
    case 4: return fused_ln_bwd_part4(res_dtype, &a, blocks, dbias, dgamma,
                                      dbeta, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_ln_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
