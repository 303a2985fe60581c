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
//   aligned): a lane holds the same 8-column chunks in every row, so its
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
// The 16-bit warp path: x bf16 or fp16 (the residual in x's type or fp32),
// D <= 1024, D % 8 == 0, every row operand 16-byte aligned
// ---------------------------------------------------------------------------
// A lane holds chunks c < NC of TILE_VEC columns, starting at (32c + lane)
// * TILE_VEC, the same columns in every row its warp takes: its share of
// the column sums stays in registers, 3 x NC x 8 floats.
constexpr int TILE_VEC = 8;
constexpr int TILE_COLS = 32 * TILE_VEC;  // the columns of one chunk index

// 16-byte pieces of 8 values of T: 1 for a 16-bit type, 2 for fp32
template <typename T>
__host__ __device__ constexpr int pieces() {
  return (int)sizeof(T) / 2;
}

// 16-byte slots of one row of the ring: x, residual, g pieces of NC chunks
template <typename TX, typename TR>
__host__ __device__ constexpr int stage_slots(int nc) {
  return nc * 32 * (2 * pieces<TX>() + pieces<TR>());
}

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

// Dynamic shared memory of ln_bwd_tile: every warp's ring, then bias and
// gamma in fp32 (NC x 256 each)
template <typename TX, typename TR, int NC>
__host__ __device__ constexpr size_t tile_smem() {
  return (size_t)tile_warps<NC>() * tile_stages<TR>() *
             stage_slots<TX, TR>(NC) * 16 +
         2 * (size_t)NC * TILE_COLS * sizeof(float);
}

// Piece h of chunk c of the lane's values of one operand sits at slot
// (c * P + h) * 32 + lane of the operand's part of a stage (and of the
// fp32 bias and gamma, P = 2): 32 lanes read 32 consecutive 16-byte slots.
template <typename T>
__device__ __forceinline__ void copy8(uint4* part, int c, int lane,
                                      const T* src) {
#pragma unroll
  for (int h = 0; h < pieces<T>(); ++h)
    tile::cp_async16(part + (c * pieces<T>() + h) * 32 + lane,
                     reinterpret_cast<const uint4*>(src) + h, true);
}

template <typename T>
__device__ __forceinline__ void unpack8(const uint4* part, int c, int lane,
                                        float (&v)[TILE_VEC]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < pieces<T>(); ++h) {
    const uint4 raw = part[(c * pieces<T>() + h) * 32 + lane];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) v[h * PER + i] = to_f32(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[TILE_VEC]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < pieces<T>(); ++h) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) e[i] = from_f32<T>(v[h * PER + i]);
    reinterpret_cast<uint4*>(dst)[h] = raw;
  }
}

// The sums of a and b over the warp, their shuffles interleaved.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Dropout keeps an element when hash_uniform(seed, idx) >= p, that is
// when (h >> 8) * 2^-24 >= p for the hash's 32 bits h: both sides exact,
// so when (h >> 8) >= ceil(p * 2^24) (at most 2^24: none kept).
__device__ __forceinline__ uint32_t keep_floor(float p) {
  return (uint32_t)fminf(ceilf(p * 16777216.0f), 16777216.0f);
}

// One warp per row, each lane NC chunks of 8 columns.  A warp's next rows
// move into its ring on cp.async while it computes the current one; each
// lane copies and reads back only its own 16-byte pieces, so no barrier
// orders the ring.  Bias and gamma wait in shared memory in fp32, read
// once from device memory per block.  At the end the block's warps add
// their registers' column sums in warp order, one gradient at a time
// through shared memory, into the block's row of the scratch.
template <typename TX, typename TR, int NC>
__global__ void __launch_bounds__(tile_warps<NC>() * 32, 1)
    ln_bwd_tile(Args args) {
  constexpr int W = tile_warps<NC>();
  constexpr int ST = tile_stages<TR>();
  constexpr int SLOTS = stage_slots<TX, TR>(NC);
  static_assert(tile_smem<TX, TR, NC>() <= 232448, "one block an SM");
  constexpr int XS = 0;                         // x's part of a stage
  constexpr int RS = NC * 32 * pieces<TX>();    // the residual's
  constexpr int GS = RS + NC * 32 * pieces<TR>();  // g's
  extern __shared__ uint4 smem[];
  const Inputs a = with_seed(args.in);
  const int D = a.D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * args.rows_per_block;
  const int last = min(a.N, first + args.rows_per_block);
  uint4* ring = smem + warp * ST * SLOTS;
  const TX* xg = static_cast<const TX*>(a.x);
  const TR* rg = static_cast<const TR*>(a.res);
  const TX* gg_in = static_cast<const TX*>(args.g);
  auto fetch = [&](int row, int s) {
    uint4* st = ring + s * SLOTS;
    const size_t base = (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col0 = (c * 32 + lane) * TILE_VEC;
      if (col0 < D) {
        copy8<TX>(st + XS, c, lane, xg + base + col0);
        copy8<TR>(st + RS, c, lane, rg + base + col0);
        copy8<TX>(st + GS, c, lane, gg_in + base + col0);
      }
    }
  };
  // the warp's first ST - 1 rows in flight before anything waits
  int row = first + warp;
#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    if (row + k * W < last) fetch(row + k * W, k);
    tile::cp_async_commit();
  }

  float4* params = reinterpret_cast<float4*>(smem + W * ST * SLOTS);
  {
    // bias and gamma in the lanes' layout: column (32c + l) * 8 + v at
    // float (((2c + v / 4) * 32 + l) * 4 + v % 4), zero past D
    float* ps = reinterpret_cast<float*>(params);
    const int bc = param_code(a.param_types, 0);
    const int gc = param_code(a.param_types, 1);
    for (int col = threadIdx.x; col < NC * TILE_COLS; col += W * 32) {
      const int k = col / TILE_VEC, v = col % TILE_VEC;
      const int at = ((2 * (k / 32) + v / 4) * 32 + k % 32) * 4 + v % 4;
      ps[at] = col < D ? param(a.bias, col, bc) : 0.f;
      ps[NC * TILE_COLS + at] = col < D ? param(a.gamma, col, gc) : 0.f;
    }
  }
  __syncthreads();
  const float4* bias_s = params;
  const float4* gamma_s = params + 2 * NC * 32;

  const uint32_t floor_keep = keep_floor(a.p);
  const float inv_q = 1.0f / a.q;
  float s_bias[NC][TILE_VEC], s_gamma[NC][TILE_VEC], s_beta[NC][TILE_VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int v = 0; v < TILE_VEC; ++v)
      s_bias[c][v] = s_gamma[c][v] = s_beta[c][v] = 0.f;

  for (int s = 0; row < last; row += W, s = s + 1 == ST ? 0 : s + 1) {
    // the row ST - 1 ahead into the stage the previous row left
    const int ahead = row + (ST - 1) * W;
    if (ahead < last) fetch(ahead, s == 0 ? ST - 1 : s - 1);
    tile::cp_async_commit();
    tile::cp_async_wait<ST - 1>();  // this lane's pieces of `row` landed
    const uint4* st = ring + s * SLOTS;
    const uint32_t idx0 = (uint32_t)row * (uint32_t)D;

    // z = residual + dropout(x + bias), the keep bits, the row's mean
    float z[NC][TILE_VEC];
    uint32_t keep_bits = 0;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col0 = (c * 32 + lane) * TILE_VEC;
      if (col0 < D) {
        float xv[TILE_VEC], rv[TILE_VEC];
        unpack8<TX>(st + XS, c, lane, xv);
        unpack8<TR>(st + RS, c, lane, rv);
        const float4 b0 = bias_s[(2 * c) * 32 + lane];
        const float4 b1 = bias_s[(2 * c + 1) * 32 + lane];
        const float bv[TILE_VEC] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int v = 0; v < TILE_VEC; ++v) {
          float h = xv[v] + bv[v];
          if (a.dropout) {
            const bool keep =
                (hash_bits(a.seed, idx0 + (uint32_t)(col0 + v)) >> 8) >=
                floor_keep;
            keep_bits |= (uint32_t)keep << (c * TILE_VEC + v);
            // the forward's true division, for every lane: a select, not
            // a branch that splits the warp
            const float hq = h / a.q;
            h = keep ? hq : 0.f;
          }
          z[c][v] = rv[v] + h;
          sum += z[c][v];
        }
      } else {
#pragma unroll
        for (int v = 0; v < TILE_VEC; ++v) z[c][v] = 0.f;
      }
    }
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if ((c * 32 + lane) * TILE_VEC < D) {
#pragma unroll
        for (int v = 0; v < TILE_VEC; ++v) {
          z[c][v] -= mean;
          sq += z[c][v] * z[c][v];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)D + a.eps);

    // z becomes y = (z - mean) * rstd; the two row means of the backward
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if ((c * 32 + lane) * TILE_VEC < D) {
        float gv[TILE_VEC];
        unpack8<TX>(st + GS, c, lane, gv);
        const float4 g0 = gamma_s[(2 * c) * 32 + lane];
        const float4 g1 = gamma_s[(2 * c + 1) * 32 + lane];
        const float gm[TILE_VEC] = {g0.x, g0.y, g0.z, g0.w,
                                    g1.x, g1.y, g1.z, g1.w};
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
        float gv[TILE_VEC];
        unpack8<TX>(st + GS, c, lane, gv);
        const float4 g0 = gamma_s[(2 * c) * 32 + lane];
        const float4 g1 = gamma_s[(2 * c + 1) * 32 + lane];
        const float gm[TILE_VEC] = {g0.x, g0.y, g0.z, g0.w,
                                    g1.x, g1.y, g1.z, g1.w};
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

// The vector width of the warp kernel's vector path: vec_width, or 1
// where every row the vector path could take goes to ln_bwd_tile (16-bit
// x beside itself: D % 8 == 0), so that only the value-by-value path is
// built.
template <typename TX, typename TR>
constexpr int warp_vec() {
  return sizeof(TX) == 2 && vec_width<TX, TR>() % TILE_VEC == 0
             ? 1
             : vec_width<TX, TR>();
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

// The chunks a lane of the 16-bit warp path holds for rows of D, or 0
// where the path does not take x of type TX or rows of D.  Rows of up to
// 768 values take the 3-chunk kernel, its chunks past D idle, and longer
// ones the 4-chunk kernel: two kernels a type pair, for the build's time
// (nvcc compiles each fully unrolled).
template <typename TX>
int tile_chunks(int D) {
  if (sizeof(TX) != 2 || D > WARP_MAX_D || D % TILE_VEC != 0) return 0;
  return D <= 3 * TILE_COLS ? 3 : 4;
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
