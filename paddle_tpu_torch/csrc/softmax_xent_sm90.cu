// The fused LM head's two kernels for 16-bit operands (bf16 or fp16, the
// element type a template parameter), built for Hopper (sm_90a) on TMA and
// wgmma.
//
// Replaces, for bf16 or fp16 x and w whose rows TMA can describe (D and V
// multiples of 8, 16-byte aligned bases; ops/softmax_xent.py `_route`),
// the TPU kernels of paddle_tpu/ops/pallas/softmax_xent.py:
//   _fwd_kernel (:48, launched by softmax_xent_fwd :104), row 10:
//     lse[n] = log sum_v exp(logits[n, v]),  at[n] = logits[n, labels[n]]
//     (0 for a label outside [0, V), as the caller initialised it);
//   _dlogits_kernel (:132, launched by softmax_xent_dlogits :163), row 11:
//     out[c, v] = (exp(logits[c, v] - lse[c]) - (v == labels[c])) * g,
//     cast once to x's type (round to nearest, subnormals kept: fp16's
//     label column at g = 1/65536 is one), g one fp32 value read on the
//     device;
// with logits = x @ w, x (rows, D), w (D, V), accumulated in fp32 and
// never written to device memory.  fp32 operands and 16-bit ones TMA
// cannot describe stay on softmax_xent_fwd.cu / softmax_xent_dlogits.cu.
// bf16 and fp16 share the tiles, the swizzle and the instruction count:
// only wgmma's type names, the TMA data type and the output's pack differ
// (sm90_common.cuh `wgmma_ss_mn<T>`, `tma_type<T>`, `pack2<T>`).
//
// What bounds it on an H100: 2 rows D V flops.  The forward at the
// compiled step's shape (N 65536, D 768, V 30528) is 3.07 TFLOP against
// 148 MB of operands: 3.1 ms at 989 TFLOP/s, far above the card's ~295
// flops per byte.  One dlogits chunk (C 4096) is 0.19 ms of products
// against a 250 MB output (0.075 ms at 3.35 TB/s).  Both are tensor-core
// bound.  The mma.sync kernels they replace reached 11% and 15% of it:
// each block loaded its chunks synchronously and then multiplied, a
// 64 x 128 tile did ~42 flops per staged byte, and the forward's blocks
// each walked the whole vocabulary, reading all of w through L2.
//
// Design: one mainloop, two epilogues.
// - A block tile is 128 rows x 256 vocabulary columns (~85 flops per
//   staged byte).  Blocks are persistent, one per SM; block b takes tiles
//   b, b + grid, ... in a fixed order: groups of 16 row tiles, and inside
//   a group the row tile fastest, so the blocks in flight share a few
//   column slices of w and a 3 MB slice of x in L2.
// - One thread of a producer warpgroup keeps a ring of 64-deep chunks
//   full (x 128 x 64, w 64 x 256 as four 64-column boxes) with TMA,
//   128-byte swizzle, on mbarriers; it runs ahead across tiles, so the
//   next tile's first chunks load during this tile's epilogue.  Boxes
//   wholly past V are not loaded (their columns are never read back).
//   Multicasting each w chunk to the 2 or 4 blocks of a cluster (one L2
//   read for several row tiles) measured no faster, and was not kept.
// - Two consumer warpgroups each own 64 rows and run m64n256k16 wgmma,
//   x K-major, w MN-major (V contiguous, read transposed), fp32
//   accumulators in 128 registers a thread (setmaxnreg: 232 a consumer
//   thread, 40 a producer one).  A chunk's products are one wgmma group;
//   its stage goes back to the producer once the next chunk's group is
//   issued and it has completed.
// - The epilogues run on the accumulator fragment, while the tensor cores
//   wait: they cost ~15% of the forward and ~25% of a dlogits chunk, so
//   the column mask and the label run only where a tile needs them.
// - Forward epilogue: per row, the tile's max and sum of exponentials
//   over the columns < V (TMA's zero fill past V is masked by index on the
//   last tile only), reduced over the quad of lanes that share a row,
//   written to fp32 partials (2, V tiles, rows); in the one tile that
//   holds a row's label, the lane holding its column selects the logit
//   and writes at.  A second small kernel folds each row's partials in
//   tile order into lse = m + log(l).  No atomics: a run repeats bit for
//   bit.  Keeping each row's running state in registers instead means one
//   block per row tile walking all ~120 column tiles: at the compiled
//   step's 512 row tiles a last partial wave over 132 SMs, at a 4096-row
//   chunk's 32 row tiles most SMs idle; the partials cost ~126 MB of
//   traffic (~0.04 ms) at the flagship shape and a second launch.
// - dlogits epilogue: exp, the label's -1 (in the tile that holds it) and
//   the scale on the fragment, the 16-bit tile staged in shared memory in
//   the TMA box layout (128-byte swizzle, conflict-free), then TMA stores
//   of 64-column boxes, which clip the rows and columns past the edge; the
//   staging buffer is reused once the store before it has read it, so the
//   stores overlap the next tile's products.  Three stages here (the 64 KB
//   staging buffer), four in the forward.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

// the element type codes of the C entry points (ops/softmax_xent.py
// _DTYPE_CODES; 0, fp32, is the tile kernels' alone)
constexpr int DTYPE_BF16 = 1, DTYPE_F16 = 2;
constexpr int ERR_DTYPE = 19999;  // a type code that is neither

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -3.402823466e38f;  // -FLT_MAX
constexpr int BM = 128;       // rows per tile (two consumer warpgroups)
constexpr int BN = 256;       // vocabulary columns per tile
constexpr int BK = 64;        // depth of a chunk: one 128-byte row
constexpr int GROUP = 16;     // row tiles per raster group
constexpr int THREADS = 384;  // 2 consumer warpgroups + a producer one
// registers a thread of a consumer / of the producer warpgroup keeps
// (setmaxnreg): 256 x 232 + 128 x 40 = 64512 of the SM's 65536
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int X_BYTES = BM * BK * 2;        // x chunk: 128 rows of 128 B
constexpr int W_BOX = BK * 64 * 2;          // w box: 64 rows x 64 columns
constexpr int BOXES = BN / 64;              // w boxes per chunk
constexpr int STAGE_BYTES = X_BYTES + BOXES * W_BOX;
constexpr int OUT_BOX = 64 * 64 * 2;        // output box: 64 rows x 64 cols

template <bool DLOGITS>
struct Cfg {
  static constexpr int STAGES = DLOGITS ? 3 : 4;
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int OUT_BYTES = DLOGITS ? BM * BN * 2 : 0;
  static constexpr int BARS = OUT_OFF + OUT_BYTES;
  static constexpr int SMEM = 1024 + BARS + 16 * STAGES;
};

struct Params {
  CUtensorMap mx, mw, mo;  // x (rows, D), w (D, V), out (rows, V)
  const int* labels;       // (rows,)
  const float* lse;        // dlogits: (rows,)
  const float* g;          // dlogits: one value
  float* part;             // forward: (2, nvt, rows), tile max then sum
  float* at;               // forward: (rows,)
  int rows, V, nrt, nvt, nk, tiles;
};

// Row tile and vocabulary tile of tile number `tile`: groups of GROUP row
// tiles, the row tiles fastest in a group.
__device__ __forceinline__ void tile_coords(const Params& p, int tile,
                                            int& rt, int& vt) {
  const int per_group = GROUP * p.nvt;
  const int grp = tile / per_group;
  const int gm = min(GROUP, p.nrt - grp * GROUP);
  const int local = tile - grp * per_group;
  rt = grp * GROUP + local % gm;
  vt = local / gm;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The forward's statistics of row h of this thread's fragment: the max of
// the tile's columns below V (`ncol` of them; MASKED where that is not
// all) and the sum of exp(logit - max) over them, both over the quad of
// lanes that shares the row.
template <bool MASKED>
__device__ __forceinline__ void tile_stats(const float (&acc)[BN / 2], int h,
                                           int q, int ncol, float& mx,
                                           float& sum) {
  mx = NEG_INF;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!MASKED || 8 * j + 2 * q + e < ncol)
        mx = fmaxf(mx, acc[4 * j + 2 * h + e]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float mb = mx * LOG2E;
  sum = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!MASKED || 8 * j + 2 * q + e < ncol)
        sum += ex2(fmaf(acc[4 * j + 2 * h + e], LOG2E, -mb));
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
}

// dlogits of row h of this thread's fragment into the staging buffer:
// (exp(logit - lse) - [column == label]) * g as pairs of T, at `dst` (the
// row's 128-byte line in box 0, plus this lane's 4 bytes) in box j / 8,
// 16-byte chunk j % 8 swizzled by the row % 8 (= g).  LABEL: the label is
// this tile's local column lc + 2 q (lc relative to this lane's pairs).
template <typename T, bool LABEL>
__device__ __forceinline__ void dlogits_row(const float (&acc)[BN / 2], int h,
                                            int g, float lb, float gs,
                                            int lc, uint32_t dst) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float y0 = ex2(fmaf(acc[4 * j + 2 * h], LOG2E, -lb));
    float y1 = ex2(fmaf(acc[4 * j + 2 * h + 1], LOG2E, -lb));
    if (LABEL) {
      if (8 * j == lc) y0 -= 1.f;
      if (8 * j + 1 == lc) y1 -= 1.f;
    }
    st_shared(dst + (j / 8) * OUT_BOX + (((j % 8) ^ g) << 4),
              pack2<T>(y0 * gs, y1 * gs));
  }
}

template <typename T, bool DLOGITS>
__device__ __forceinline__ void run_tiles(const Params& p) {
  using C = Cfg<DLOGITS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + C::BARS, empty = full + 8 * C::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // ---- producer warpgroup: one thread loads
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&p.mx);
      tma_prefetch_map(&p.mw);
      int c = 0;  // ring uses so far
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        int rt, vt;
        tile_coords(p, tile, rt, vt);
        // w boxes wholly past V are not loaded
        const int boxes = min(BOXES, (p.V - vt * BN + 63) / 64);
        for (int kc = 0; kc < p.nk; ++kc, ++c) {
          const int s = c % C::STAGES;
          if (c >= C::STAGES)
            mbar_wait(empty + 8 * s, (c / C::STAGES - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t sx = base + s * STAGE_BYTES, sw = sx + X_BYTES;
          mbar_arrive_expect_tx(bar, X_BYTES + boxes * W_BOX);
          tma_load_2d(sx, &p.mx, bar, kc * BK, rt * BM);
          for (int b = 0; b < boxes; ++b)
            tma_load_2d(sw + b * W_BOX, &p.mw, bar, vt * BN + 64 * b,
                        kc * BK);
        }
      }
    }
    __syncwarp();
  } else {  // ---- consumer warpgroups: 64 rows x 256 columns each
    reg_alloc<CONSUMER_REGS>();
    const int cw = threadIdx.x / 128;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
    const int wrow = warp * 16 + g;  // this thread's rows in the
                                     // warpgroup's 64: wrow, wrow + 8
    const uint32_t stage_out = base + C::OUT_OFF + cw * (BM / 2) * BN * 2;
    // a stage whose products are done goes back to the producer
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    };
    float gs = 0.f;
    if (DLOGITS) {
      gs = *p.g;
      if (t == 0) tma_prefetch_map(&p.mo);
    }
    float acc[BN / 2];
    int c = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      int rt, vt;
      tile_coords(p, tile, rt, vt);
      for (int kc = 0; kc < p.nk; ++kc, ++c) {
        const int s = c % C::STAGES;
        mbar_wait(full + 8 * s, (c / C::STAGES) & 1);
        const uint32_t sx = base + s * STAGE_BYTES + cw * 64 * 128;
        const uint32_t sw = base + s * STAGE_BYTES + X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          // x: K-major, a k16 step is 32 bytes along the row; w: MN-major,
          // a k16 step is 16 rows (2048 bytes), the next 64 columns one
          // box further (leading offset)
          wgmma_ss_mn<T, BN>(
              acc, desc_sw128(sx + k * 32, 16, 1024),
              desc_sw128(sw + k * 2048, W_BOX, 1024), kc > 0 || k > 0);
        wgmma_commit();
        if (kc > 0) {  // the chunk before is read
          wgmma_wait<1>();
          release((c - 1) % C::STAGES);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((c - 1) % C::STAGES);

      const int v0 = vt * BN;
      const int ncol = min(BN, p.V - v0);
      const int row_base = rt * BM + cw * 64;
      if (!DLOGITS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_base + wrow + 8 * h;
          float mx, sum;
          if (ncol == BN)  // every column is below V
            tile_stats<false>(acc, h, q, ncol, mx, sum);
          else
            tile_stats<true>(acc, h, q, ncol, mx, sum);
          if (q == 0 && row < p.rows) {
            p.part[(size_t)vt * p.rows + row] = mx;
            p.part[(size_t)(p.nvt + vt) * p.rows + row] = sum;
          }
          // the label's logit, from the one lane holding it (a label falls
          // in one tile: most tiles skip this)
          const int lc = (row < p.rows ? p.labels[row] : -1) - v0;
          if (lc >= 0 && lc < ncol && ((lc >> 1) & 3) == q) {
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (8 * j + 2 * q + e == lc) v = acc[4 * j + 2 * h + e];
            p.at[row] = v;
          }
        }
      } else {
        // the staging buffer is free once the last store has read it
        if (t == 0) bulk_wait_read<0>();
        named_sync(1 + cw, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + 8 * h;  // r % 8 == g
          const int row = row_base + r;
          const bool live = row < p.rows;
          const float lb = live ? p.lse[row] * LOG2E : 0.f;
          const int lab = live ? p.labels[row] : -1;
          // the label's column in the tile, relative to this lane's pairs:
          // negative where the lane does not hold it (most tiles)
          const int lt = lab - v0;
          const int lc = lt >= 0 && lt < BN ? lt - 2 * q : -1;
          const uint32_t dst = stage_out + r * 128 + q * 4;
          if (lc < 0)
            dlogits_row<T, false>(acc, h, g, lb, gs, lc, dst);
          else
            dlogits_row<T, true>(acc, h, g, lb, gs, lc, dst);
        }
        fence_async_smem();
        named_sync(1 + cw, 128);
        if (t == 0 && row_base < p.rows) {
          for (int b = 0; b < (ncol + 63) / 64; ++b)
            tma_store_2d(&p.mo, stage_out + b * OUT_BOX, v0 + 64 * b,
                         row_base);
          bulk_commit();
        }
      }
    }
    if (DLOGITS && t == 0) bulk_wait<0>();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
sxent_fwd_kernel_sm90(const __grid_constant__ Params p) {
  run_tiles<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
sxent_dlogits_kernel_sm90(const __grid_constant__ Params p) {
  run_tiles<T, true>(p);
}

// lse[n] from the forward's partials, folded in tile order.
__global__ void __launch_bounds__(256)
sxent_fwd_kernel_lse(const float* __restrict__ part, float* __restrict__ lse,
                     int rows, int nvt) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* pm = part + row;
  const float* pl = part + (size_t)nvt * rows + row;
  float m = NEG_INF;
  for (int vt = 0; vt < nvt; ++vt) m = fmaxf(m, pm[(size_t)vt * rows]);
  float l = 0.f;
  for (int vt = 0; vt < nvt; ++vt)
    l += pl[(size_t)vt * rows] * expf(pm[(size_t)vt * rows] - m);
  lse[row] = m + logf(l);
}

// ---- launches ------------------------------------------------------------------
// Encodes the maps, fills the tile counts and launches the persistent
// grid: one block per SM, at most one per tile.  Returns 0, a cudaError_t
// or an sm90 error code.
template <typename T, bool DLOGITS>
int launch(Params& p, const void* x, const void* w, void* out, int D,
           cudaStream_t stream) {
  using C = Cfg<DLOGITS>;
  int err;
  constexpr CUtensorMapDataType type = tma_type<T>();
  if ((err = encode_matrix(&p.mx, x, p.rows, D, 2LL * D, BM, type)) ||
      (err = encode_matrix(&p.mw, w, D, p.V, 2LL * p.V, BK, type)))
    return err;
  if (DLOGITS && (err = encode_matrix(&p.mo, out, p.rows, p.V, 2LL * p.V,
                                      BM / 2, type)))
    return err;
  p.nrt = (p.rows + BM - 1) / BM;
  p.nvt = (p.V + BN - 1) / BN;
  p.nk = (D + BK - 1) / BK;
  if ((long long)p.nrt * p.nvt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.tiles = p.nrt * p.nvt;
  auto kernel =
      DLOGITS ? sxent_dlogits_kernel_sm90<T> : sxent_fwd_kernel_sm90<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  kernel<<<p.tiles < sms ? p.tiles : sms, THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_sizes(int rows, int D, int V) {
  return rows <= 0 || D <= 0 || V <= 0 || D % 8 || V % 8;
}

// launch<T, DLOGITS> for the type code `dtype`, or ERR_DTYPE
template <bool DLOGITS>
int launch_typed(int dtype, Params& p, const void* x, const void* w,
                 void* out, int D, cudaStream_t stream) {
  switch (dtype) {
    case DTYPE_BF16:
      return launch<__nv_bfloat16, DLOGITS>(p, x, w, out, D, stream);
    case DTYPE_F16:
      return launch<__half, DLOGITS>(p, x, w, out, D, stream);
    default:
      return ERR_DTYPE;
  }
}

}  // namespace

// x (N, D), w (D, V) of one 16-bit type, row-major, 16-byte aligned, D and
// V multiples of 8; dtype their type code, DTYPE_BF16 (1) or DTYPE_F16
// (2), any other returns ERR_DTYPE; labels (N,) int32; lse, at (N,) fp32,
// at zeroed by the caller; part fp32 scratch of 2 * ceil(V / 256) * N
// values.  Two launches: the tiles, then the fold of the partials into
// lse.  Returns 0 when launched, a cudaError_t, or an sm90 error code
// (softmax_xent_sm90_error_string).
extern "C" int softmax_xent_sm90_fwd(const void* x, const void* w,
                                     const int* labels, float* lse, float* at,
                                     float* part, int N, int D, int V,
                                     int dtype, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (bad_sizes(N, D, V)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.labels = labels;
  p.part = part;
  p.at = at;
  p.rows = N;
  p.V = V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_typed<false>(dtype, p, x, w, nullptr, D, s);
  if (err) return err;
  sxent_fwd_kernel_lse<<<(N + 255) / 256, 256, 0, s>>>(part, lse, N, p.nvt);
  return (int)cudaGetLastError();
}

// x (C, D), w (D, V) and dtype as above; labels (C,) int32; lse (C,)
// fp32; g one fp32 value on the device; out (C, V) of x's type, 16-byte
// aligned.
extern "C" int softmax_xent_sm90_dlogits(const void* x, const void* w,
                                         const int* labels, const float* lse,
                                         const float* g, void* out, int C,
                                         int D, int V, int dtype,
                                         void* stream) {
  cudaGetLastError();
  if (bad_sizes(C, D, V)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.labels = labels;
  p.lse = lse;
  p.g = g;
  p.rows = C;
  p.V = V;
  return launch_typed<true>(dtype, p, x, w, out, D,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* softmax_xent_sm90_error_string(int code) {
  if (code == ERR_NO_DRIVER)
    return "cuTensorMapEncodeTiled not found (libcuda.so.1)";
  if (code >= ERR_ENCODE && code < ERR_ENCODE + 10000)
    return "cuTensorMapEncodeTiled refused an operand (CUresult = code - "
           "20001)";
  if (code == ERR_DTYPE)
    return "softmax_xent_sm90 takes type codes 1 (bf16) and 2 (fp16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
