// Flash attention in bf16 and fp16, forward and backward, built for Hopper
// (sm_90a) on wgmma and TMA.
//
// Replaces, for bf16 and fp16 operands with head dim 64 or 128, the TPU
// kernels of paddle_tpu/ops/pallas/flash_attention.py that the compiled
// train step runs, and every other 16-bit attention of the port at those
// head dims:
//   _qkv_fwd_kernel      row 3 (:276): the packed forward, here on head
//                        views of the (B, T, 3F) projection (bf16: the
//                        packed path refuses fp16);
//   _qkv_bwd_kernel      row 4 (:303) and _qkv_mid_bwd_kernel row 5
//                        (:442): the packed backward, writing the packed
//                        (B, T, 3F) gradient in place (bf16);
//   and the split-layout calls of rows 1, 2 and 6-9 in bf16 and in fp16
//   (AMP in fp16: Model's O1 / O2 steps and the GradScaler loop).
// The element type T is a template parameter of every kernel here: bf16
// and fp16 are both 2 bytes, so the tiles, the 128-byte swizzle, the
// 64-element halves and the k16 depth are one design; only the wgmma type
// names, the TMA data type and the roundings to T differ (sm90_common.cuh).
// fp32 stays on flash_attn_fwd.cu / flash_attn_bwd.cu (3xTF32, 2e-5
// parity); bf16 and fp16 at head dims 16, 32, 80 and 96 stay on their
// mma.sync path (d 32 needs a 64-byte swizzle, later work).
//
// What it computes is what flash_attn_fwd.cu and flash_attn_bwd.cu compute:
// operands (B, S, H, D) addressed by (batch, row, head) strides with a
// contiguous last axis; fp32 lse (B, H, Tq) out of the forward, the
// backward's residual; causal masking bottom-right aligned (query i sees
// key j iff j <= i + Tk - Tq; causal with Tq > Tk refused); masked scores
// NEG_INF = -1e30; any Tq, Tk, the ragged edge masked (a TMA box past the
// end is filled with zeros, and a zero score is not -1e30, so keys >= Tk are
// masked by index); operands in T, scores and softmax statistics in fp32
// with the scale multiplying the fp32 scores (so no fp16 score is ever
// held: raw scores past fp16's 65504 are exact), P rounded to T before
// P V, dS = P (dP - delta) rounded to T before dQ and dK, every product
// accumulating in fp32 (the reference's rounding points,
// flash_attention.py:139, :226, :336, :341, :482, :486).
//
// What bounds it on an H100: the causal forward at the train shape (B 128,
// T 512, H 12, d 64) moves 4 B T H d 16-bit elements (0.12 ms at 3.35
// TB/s) and does 2 B H T^2 d flops (0.05 ms at 989 TFLOP/s, bf16 and fp16
// alike): bytes bound at
// short T, tensor-core bound past T ~ 1k.  At d 64 the exponentials of the
// softmax cost as much as the products (16 ex2 an SM a clock against 4096
// flops).  The earlier mma.sync kernels reached 13% of the bound:
// synchronous loads, four block barriers per tile and the score and P
// tiles round-tripping through shared memory.  Here:
// - one producer warp keeps TMA loads of K/V (or Q/dO) tiles in flight in
//   a ring of two or three stages in shared memory, completed on
//   mbarriers; the loads cost the consumers no instructions and no
//   registers;
// - two consumer warpgroups each own 64 rows and run every product on
//   wgmma (64 x N x 16, fp32 accumulators in registers); operands that the
//   product reads from shared memory are the TMA tiles themselves
//   (128-byte swizzle), K-major or read transposed (MN-major);
// - the softmax (and in the backward P and dS) runs on the accumulator
//   fragment in registers with quad shuffles, one FFMA and one ex2 an
//   element, and P / dS become the register A operand of the next
//   product: no score tile in shared memory, no block-wide barrier in the
//   main loop; the forward issues tile j's S = Q K^T with tile j-1's
//   O += P V and runs tile j's softmax while P V is in flight, and the
//   backward forms P while dP is in flight;
// - causal tiles wholly above the diagonal are never loaded, and the mask
//   is applied only on tiles that cross the diagonal or the edge;
// - blocks are persistent (one per SM) and take work from a counter,
//   heaviest causal tile first within each head (see below).
// Tiles are sized to the registers: 168 a thread at launch, 232 for a
// consumer after setmaxnreg (the producer keeps 40).  Forward: 128 query
// rows an item, 128 keys a tile at d 64, 64 at d 128 (O takes 64
// registers there).  dK/dV: 128 keys an item, 64 queries a tile (32 at
// d 128, where dK and dV take 128 registers).  dQ: 128 queries an item,
// 64 keys a tile.
//
// Backward: three launches, deterministic (no atomics on values; a run
// repeats bit for bit): delta = rowsum(dO * O); dK/dV per key item
// streaming query tiles of Q, dO, lse and delta (S^T = K Q^T and dP^T =
// V dO^T in registers, P^T and dS^T formed there, dV += P^T dO and dK +=
// dS^T Q with P^T, dS^T as register A operands); dQ per query item
// streaming key tiles of K and V (dQ += dS K).  Both main passes recompute
// S and dP; a single pass would accumulate dQ across key items, which
// needs atomics (or an ordered reduction) and was not taken.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

// the element type codes of the C entry points (ops/flash_attention.py
// _DTYPE_CODES; 0, fp32, is flash_attn_fwd.cu's alone)
constexpr int DTYPE_BF16 = 1, DTYPE_F16 = 2;
constexpr int ERR_DTYPE = 19999;  // a type code that is neither

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PASS_DELTA = 1, PASS_DKV = 2, PASS_DQ = 4;
// registers a thread of the producer / a consumer warpgroup keeps
// (setmaxnreg): 128 x 40 + 256 x 232 = 64512 of the SM's 65536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Bytes of an R-row tile of head dim D (D / 64 halves of R x 128 bytes).
template <int D>
constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// A block's dynamic shared memory: tiles from a 1024-byte aligned base,
// then the mbarriers.
struct Smem {
  uint8_t* raw;
  uint32_t base;
  __device__ explicit Smem(uint8_t* p)
      : raw(p), base((smem_u32(p) + 1023u) & ~1023u) {}
  template <typename T>
  __device__ T* ptr(uint32_t addr) const {
    return reinterpret_cast<T*>(raw + (addr - smem_u32(raw)));
  }
};

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<T>(a, b);
}

// K-major descriptor of k16 step k of an operand tile (rows x D) at `tile`
// whose reading starts at row `row0` (a multiple of 8).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int k) {
  return desc_sw128(tile + (k / 4) * rows * 128 + row0 * 128 + (k % 4) * 32,
                    16, 1024);
}
// MN-major descriptor of k16 step k (rows 16k .. 16k + 15) of an operand
// tile (rows x D) read transposed: N = D across the halves.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int k) {
  return desc_sw128(tile + k * 16 * 128, rows * 128, 1024);
}

// Writes a 64 x D accumulator (times `mult`) of the warpgroup as T to
// rows (row0, row0 + 8) of this thread, skipping rows >= nrows.
template <int D, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], T* base,
                                           long long ld, int row0, int nrows,
                                           float mult) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrows) continue;
    T* dst = base + (long long)row * ld;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dst + 8 * j + 2 * q, acc[4 * j + 2 * r] * mult,
                 acc[4 * j + 2 * r + 1] * mult);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ---- persistent blocks -----------------------------------------------------------
// Every main kernel runs one block per SM (at most) that takes work items
// from a counter in device memory: first item blockIdx.x, then each next
// one from atomicAdd(sched) + gridDim.x.  Item w is head w / tiles and its
// (w % tiles)-th heaviest tile, so the blocks in flight share a few heads
// whose K/V (or Q/dO) stay in L2, and the light causal tiles come last.
// The producer fetches items and runs ahead across them: the next item's
// first tiles load while the current one computes (the per-item operand
// sits in one of two buffers, and the item's number in a shared slot that
// the buffer's barrier publishes; -1 ends the block).  Which block takes
// an item does not change its result.  The counter resets itself: each
// block's producer counts its exit in the word after it, and the last one
// zeroes both, so the next launch on the stream finds them zero.

// A block's producer is done fetching items: count its exit; the last
// block's producer zeroes the counter pair for the next launch.
__device__ __forceinline__ void sched_exit(int* sched) {
  if (atomicAdd(sched + 1, 1) == (int)gridDim.x - 1) {
    sched[0] = 0;
    sched[1] = 0;
  }
}

// Keys a query block [m0, m0 + rows) sees: past its last live row every
// key is masked.
__device__ __forceinline__ int key_end(int causal, int m0, int rows, int tq,
                                       int tk) {
  return causal ? min(tk, min(m0 + rows, tq) + tk - tq) : tk;
}

// The online softmax of one score tile on the wgmma fragment (64 rows x BN
// keys, two rows a thread), on raw scores: masked to NEG_INF where `edge`
// says the tile crosses the diagonal or Tk (a separate pass, so inner
// tiles pay nothing for it), the running max and (per thread, partial)
// sum updated, sc replaced by exp(scale (score - max)) = 2^(score *
// scale_log2 - base), one FFMA and one ex2 an element, base = fl(max *
// scale_log2), and corr by the factor the output must take.
//
// In fp16 the exponent also loses base's rounding residual (which the
// FFMA gives exactly), one FADD more an element, so the max's own weight
// is exactly 1: otherwise it is 2^residual, up to 2^(+-1e-3) where raw
// scores pass fp16's range, and rounded to fp16 for P V that error made O
// disagree with P by ~5e-4, which dP - delta, a difference that cancels
// for rows near one-hot, turned into 5-8x the plain version's dq / dk
// error.  bf16 keeps the one-FFMA form: its 8-bit mantissa rounds
// 2^residual to 1 there, and the FADD cost it ~5% at T 8192.
template <typename T, int BN>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BN / 2], float (&m_run)[2], float (&l_run)[2],
    float (&corr)[2], bool edge, int n0, int row0, int qd, int tk, int causal,
    int offset, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = n0 + 8 * (i / 4) + 2 * qd + (i & 1);
      const int row = row0 + 8 * ((i / 2) & 1);
      if (key >= tk || (causal && key > row + offset)) sc[i] = NEG_INF;
    }
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
  float rs[2] = {0.f, 0.f}, base[2], res[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m_run[r] - mx[r]) * scale_log2);
    m_run[r] = mx[r];
    base[r] = mx[r] * scale_log2;
    res[r] = fmaf(mx[r], scale_log2, -base[r]);
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i / 2) & 1;
    const float x = fmaf(sc[i], scale_log2, -base[r]);
    const float e = ex2(kF16<T> ? x - res[r] : x);
    sc[i] = e;
    rs[r] += e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
}

// ---- forward -------------------------------------------------------------------
template <int D>
struct Fwd {
  static constexpr int BM = 128;  // query rows per item (2 x 64)
  // keys per tile: at d 128, O takes 64 registers a thread, and 64 keys
  // keep S and P beside it without spilling
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr int STAGES =
      2 * BM * D * 2 + 3 * 2 * BN * D * 2 <= 200 * 1024 ? 3 : 2;
  static constexpr int Q_BYTES = tile_bytes<D>(BM);
  static constexpr int KV_BYTES = tile_bytes<D>(BN);
  static constexpr int KV_OFF = 2 * Q_BYTES;  // two Q buffers, then the ring
  static constexpr int BARS = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BARS + 8 * (5 + 2 * STAGES);
};

template <typename T>
struct FwdParams {
  CUtensorMap mq, mk, mv;
  T* o;
  long long o_b, o_s, o_h;
  float* lse;  // (B, H, Tq) or null
  int H, BH, tq, tk, causal, tiles, items;
  int* sched;  // item counter and exit count, zero at launch
  float scale, scale_log2;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  using C = Fwd<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const uint32_t sQ = sm.base;                 // buffer i at + i * Q_BYTES
  const uint32_t sKV = sm.base + C::KV_OFF;    // stage s: K, then V
  const uint32_t q_full = sm.base + C::BARS, q_empty = q_full + 16;
  const uint32_t kv_full = q_full + 32, kv_empty = kv_full + 8 * C::STAGES;
  volatile int* slot = sm.ptr<int>(kv_empty + 8 * C::STAGES);  // per Q buffer
  const int offset = p.tk - p.tq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&p.mq);
      tma_prefetch_map(&p.mk);
      tma_prefetch_map(&p.mv);
      int c = 0;  // ring uses so far
      for (int it = 0, w = blockIdx.x;; ++it) {
        const int qb = it & 1;
        if (it >= 2) mbar_wait(q_empty + 8 * qb, ((it >> 1) - 1) & 1);
        slot[qb] = w < p.items ? w : -1;
        if (w >= p.items) {
          mbar_arrive(q_full + 8 * qb);
          sched_exit(p.sched);
          break;
        }
        const int bh = w / p.tiles, b = bh / p.H, h = bh % p.H;
        const int m0 = (p.tiles - 1 - w % p.tiles) * C::BM;
        const int n_tiles =
            (key_end(p.causal, m0, C::BM, p.tq, p.tk) + C::BN - 1) / C::BN;
        mbar_arrive_expect_tx(q_full + 8 * qb, C::Q_BYTES);
        for (int hf = 0; hf < D / 64; ++hf)
          tma_load_4d(sQ + qb * C::Q_BYTES + hf * C::BM * 128, &p.mq,
                      q_full + 8 * qb, 64 * hf, h, m0, b);
        const int next = atomicAdd(p.sched, 1) + gridDim.x;
        for (int j = 0; j < n_tiles; ++j, ++c) {
          const int s = c % C::STAGES;
          if (c >= C::STAGES)
            mbar_wait(kv_empty + 8 * s, (c / C::STAGES - 1) & 1);
          const uint32_t full = kv_full + 8 * s;
          const uint32_t sK = sKV + s * 2 * C::KV_BYTES, sV = sK + C::KV_BYTES;
          mbar_arrive_expect_tx(full, 2 * C::KV_BYTES);
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(sK + hf * C::BN * 128, &p.mk, full, 64 * hf, h,
                        j * C::BN, b);
            tma_load_4d(sV + hf * C::BN * 128, &p.mv, full, 64 * hf, h,
                        j * C::BN, b);
          }
        }
        w = next;
      }
    }
  } else {  // ---- consumer warpgroups: 64 query rows each
    reg_alloc<CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32, qd = lane & 3;
    int c = 0;
    for (int it = 0;; ++it) {
      const int qb = it & 1;
      mbar_wait(q_full + 8 * qb, (it >> 1) & 1);
      const int w = slot[qb];
      if (w < 0) break;
      const int bh = w / p.tiles, b = bh / p.H, h = bh % p.H;
      const int m0 = (p.tiles - 1 - w % p.tiles) * C::BM;
      const int n_tiles =
          (key_end(p.causal, m0, C::BM, p.tq, p.tk) + C::BN - 1) / C::BN;
      const int wg_row = m0 + cw * 64;
      const int row0 = wg_row + (t / 32) * 16 + lane / 4;  // and row0 + 8
      const uint32_t sQb = sQ + qb * C::Q_BYTES;

      float o[D / 2];
      zero(o);
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
      float sc[C::BN / 2];
      uint32_t pa[C::BN / 4];  // P of the tile before, A fragments in T

      // Tile j's S = Q K^T is issued together with tile j-1's O += P V,
      // and tile j's softmax runs while P V is still on the tensor cores.
      // Each product is its own fenced group, so that the softmax may
      // write S's registers while P V is in flight.
      auto issue_s = [&](int stage) {
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<T, C::BN>(sc, kmajor(sQb, C::BM, cw * 64, k),
                          kmajor(sKV + stage * 2 * C::KV_BYTES, C::BN, 0, k),
                          k > 0);
        wgmma_commit();
        fence_regs(sc);
      };
      auto softmax = [&](int j, float (&corr)[2]) {
        const int n0 = j * C::BN;
        online_softmax<T, C::BN>(
            sc, m_run, l_run, corr,
            n0 + C::BN > p.tk || (p.causal && n0 + C::BN - 1 > wg_row + offset),
            n0, row0, qd, p.tk, p.causal, offset, p.scale_log2);
      };
      int s_prev = c % C::STAGES;
      mbar_wait(kv_full + 8 * s_prev, (c / C::STAGES) & 1);
      issue_s(s_prev);
      wgmma_wait<0>();
      fence_regs(sc);
      {
        float corr[2];
        softmax(0, corr);
      }
      pack_a<T, C::BN>(sc, pa);
      ++c;
      for (int j = 1; j < n_tiles; ++j, ++c) {
        const int s = c % C::STAGES;
        mbar_wait(kv_full + 8 * s, (c / C::STAGES) & 1);
        issue_s(s);
        const uint32_t sV = sKV + s_prev * 2 * C::KV_BYTES + C::KV_BYTES;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BN / 16; ++k)
          wgmma_rs<T, D>(o, &pa[4 * k], mnmajor(sV, C::BN, k));
        wgmma_commit();
        fence_regs(o);
        wgmma_wait<1>();
        fence_regs(sc);
        float corr[2];
        softmax(j, corr);
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty + 8 * s_prev);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];
        pack_a<T, C::BN>(sc, pa);
        s_prev = s;
      }
      {  // the last tile's O += P V
        const uint32_t sV = sKV + s_prev * 2 * C::KV_BYTES + C::KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BN / 16; ++k)
          wgmma_rs<T, D>(o, &pa[4 * k], mnmajor(sV, C::BN, k));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty + 8 * s_prev);
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      }
      T* ob = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= p.tq) continue;
        const float inv = 1.f / l_run[r];
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          store_pair(ob + (long long)row * p.o_s + 8 * i + 2 * qd,
                     o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
        // fp16: lse = max * scale + ln(sum), rounded once (max * scale
        // exact in the FFMA), so the backward's exp(score * scale - lse)
        // agrees with it to lse's own rounding; bf16: through log2 units
        if (qd == 0 && p.lse != nullptr)
          p.lse[(long long)bh * p.tq + row] =
              kF16<T> ? fmaf(m_run[r], p.scale, log2f(l_run[r]) * LN2)
                      : (m_run[r] * p.scale_log2 + log2f(l_run[r])) * LN2;
      }
    }
  }
}

// ---- backward ------------------------------------------------------------------
template <typename T>
struct BwdParams {
  CUtensorMap mq, mk, mv, mdo;
  const T* o;
  const T* dout;
  T *dq, *dk, *dv;
  long long o_b, o_s, o_h, do_b, do_s, do_h;
  long long dq_b, dq_s, dq_h, dk_b, dk_s, dk_h, dv_b, dv_s, dv_h;
  const float* lse;  // (B, H, Tq)
  float* delta;      // (B, H, Tq), written by the delta pass
  int H, BH, tq, tk, causal, tiles, items;
  int* sched;  // item counters and exit counts, zero at launch
  float scale, scale_log2;
};

// The backward's P = exp(score * scale - lse) from lse_stat(lse), the form
// the passes keep each query's lse in.  fp16: in natural units, as the
// forward's lse is, the FFMA forming score * scale - lse with one rounding
// of a small result, so P agrees with that lse to its own rounding.  bf16:
// 2^(score * scale_log2 - lse * log2(e)), one FMUL less an element, whose
// roundings of lse * log2(e) and of scale_log2 times the score (~1e-3
// each where raw scores pass fp16's range, 5-8x the plain version's
// gradient error there in fp16) bf16's own rounding of P and dS hides.
template <typename T>
__device__ __forceinline__ float lse_stat(float lse) {
  return kF16<T> ? lse : lse * LOG2E;
}
template <typename T>
__device__ __forceinline__ float exp_shifted(float score, float stat,
                                             const BwdParams<T>& p) {
  return kF16<T> ? ex2(fmaf(score, p.scale, -stat) * LOG2E)
                 : ex2(fmaf(score, p.scale_log2, -stat));
}

// -- pass 1: delta = rowsum(dO * O), D / 8 threads a row, 16-byte loads ----
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 to_float2(__half2 v) {
  return __half22float2(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const BwdParams<T> p,
                                                    int rows) {
  using T2 = std::conditional_t<kF16<T>, __half2, __nv_bfloat162>;
  constexpr int G = D / 8;  // threads per row
  const int r = blockIdx.x * (256 / G) + threadIdx.x / G;
  const int c = (threadIdx.x % G) * 8;
  float acc = 0.f;
  if (r < rows) {
    const int t = r % p.tq, bh = r / p.tq, b = bh / p.H, h = bh % p.H;
    const uint4 x =
        *reinterpret_cast<const uint4*>(p.o + b * p.o_b + t * p.o_s +
                                        h * p.o_h + c);
    const uint4 y =
        *reinterpret_cast<const uint4*>(p.dout + b * p.do_b + t * p.do_s +
                                        h * p.do_h + c);
    const T2* xs = reinterpret_cast<const T2*>(&x);
    const T2* ys = reinterpret_cast<const T2*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = to_float2(xs[i]), v = to_float2(ys[i]);
      acc = fmaf(u.x, v.x, fmaf(u.y, v.y, acc));
    }
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (r < rows && threadIdx.x % G == 0) p.delta[r] = acc;
}

// -- pass 2: dK, dV per 128-key item -----------------------------------------------
template <int D>
struct Dkv {
  static constexpr int BN = 128;  // keys per item (2 x 64)
  // queries per streamed tile: at d 128, dK and dV take 128 registers a
  // thread, and 32 queries keep S^T, dP^T, P^T and dS^T beside them
  static constexpr int BM = D == 128 ? 32 : 64;
  static constexpr int KV_BYTES = tile_bytes<D>(BN);
  static constexpr int QO_BYTES = tile_bytes<D>(BM);
  static constexpr int STAGES =
      4 * KV_BYTES + 3 * (2 * QO_BYTES + 2 * BM * 4) <= 200 * 1024 ? 3 : 2;
  static constexpr int STAGE = 2 * QO_BYTES;   // Q, then dO
  static constexpr int STATS = 2 * BM * 4;     // lse_stat, then delta
  static constexpr int RING_OFF = 4 * KV_BYTES;  // two (K, V) buffers
  static constexpr int STATS_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BARS = STATS_OFF + STAGES * STATS;
  static constexpr int SMEM = 1024 + BARS + 8 * (5 + 2 * STAGES);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ BwdParams<T> p) {
  using C = Dkv<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const uint32_t sKVb = sm.base;                // buffer i: K, then V
  const uint32_t sQO = sm.base + C::RING_OFF;   // stage s: Q, then dO
  const uint32_t sStats = sm.base + C::STATS_OFF;
  const uint32_t kv_full = sm.base + C::BARS, kv_empty = kv_full + 16;
  const uint32_t full0 = kv_full + 32, empty0 = full0 + 8 * C::STAGES;
  volatile int* slot = sm.ptr<int>(empty0 + 8 * C::STAGES);  // per K/V buffer
  const int offset = p.tk - p.tq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, 8);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 33);  // the TMA's expect_tx + 32 lanes
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&p.mq);
        tma_prefetch_map(&p.mk);
        tma_prefetch_map(&p.mv);
        tma_prefetch_map(&p.mdo);
      }
      int c = 0, w = blockIdx.x;
      for (int it = 0;; ++it) {
        const int kb = it & 1;
        if (it >= 2) mbar_wait(kv_empty + 8 * kb, ((it >> 1) - 1) & 1);
        if (lane == 0) slot[kb] = w < p.items ? w : -1;
        if (w >= p.items) {
          if (lane == 0) {
            mbar_arrive(kv_full + 8 * kb);
            sched_exit(p.sched);
          }
          break;
        }
        const int bh = w / p.tiles, b = bh / p.H, h = bh % p.H;
        const int n0 = (w % p.tiles) * C::BN;  // the early keys do the most work
        // causal: key n is seen by the queries m >= n - offset
        const int m_begin = p.causal ? max(0, n0 - offset) / C::BM * C::BM : 0;
        const int m_tiles = (p.tq - m_begin + C::BM - 1) / C::BM;
        int next = 0;
        if (lane == 0) {
          const uint32_t sK = sKVb + kb * 2 * C::KV_BYTES, sV = sK + C::KV_BYTES;
          mbar_arrive_expect_tx(kv_full + 8 * kb, 2 * C::KV_BYTES);
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(sK + hf * C::BN * 128, &p.mk, kv_full + 8 * kb,
                        64 * hf, h, n0, b);
            tma_load_4d(sV + hf * C::BN * 128, &p.mv, kv_full + 8 * kb,
                        64 * hf, h, n0, b);
          }
          next = atomicAdd(p.sched, 1) + gridDim.x;
        }
        const float* lse = p.lse + (long long)bh * p.tq;
        const float* delta = p.delta + (long long)bh * p.tq;
        for (int i = 0; i < m_tiles; ++i, ++c) {
          const int s = c % C::STAGES, m0 = m_begin + i * C::BM;
          if (c >= C::STAGES) mbar_wait(empty0 + 8 * s, (c / C::STAGES - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          if (lane == 0) {
            const uint32_t sQ = sQO + s * C::STAGE, sdO = sQ + C::QO_BYTES;
            mbar_arrive_expect_tx(full, C::STAGE);
            for (int hf = 0; hf < D / 64; ++hf) {
              tma_load_4d(sQ + hf * C::BM * 128, &p.mq, full, 64 * hf, h, m0,
                          b);
              tma_load_4d(sdO + hf * C::BM * 128, &p.mdo, full, 64 * hf, h,
                          m0, b);
            }
          }
          float* st = sm.ptr<float>(sStats + s * C::STATS);
          for (int e = lane; e < C::BM; e += 32) {
            const int m = m0 + e;
            st[e] = m < p.tq ? lse_stat<T>(lse[m]) : 0.f;
            st[C::BM + e] = m < p.tq ? delta[m] : 0.f;
          }
          mbar_arrive(full);
        }
        w = __shfl_sync(0xffffffffu, next, 0);
      }
    }
  } else {  // ---- consumer warpgroups: 64 keys each
    reg_alloc<CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32, qd = lane & 3;
    int c = 0;
    for (int it = 0;; ++it) {
      const int kb = it & 1;
      mbar_wait(kv_full + 8 * kb, (it >> 1) & 1);
      const int w = slot[kb];
      if (w < 0) break;
      const int bh = w / p.tiles, b = bh / p.H, h = bh % p.H;
      const int n0 = (w % p.tiles) * C::BN;
      const int m_begin = p.causal ? max(0, n0 - offset) / C::BM * C::BM : 0;
      const int m_tiles = (p.tq - m_begin + C::BM - 1) / C::BM;
      const int wg_key = n0 + cw * 64;
      const int key0 = wg_key + (t / 32) * 16 + lane / 4;  // and key0 + 8
      const uint32_t sK = sKVb + kb * 2 * C::KV_BYTES, sV = sK + C::KV_BYTES;

      float dk[D / 2], dv[D / 2];
      zero(dk);
      zero(dv);

      for (int i = 0; i < m_tiles; ++i, ++c) {
        const int s = c % C::STAGES, m0 = m_begin + i * C::BM;
        const uint32_t sQ = sQO + s * C::STAGE, sdO = sQ + C::QO_BYTES;
        mbar_wait(full0 + 8 * s, (c / C::STAGES) & 1);

        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
        float st[C::BM / 2], dpt[C::BM / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<T, C::BM>(st, kmajor(sK, C::BN, cw * 64, k),
                          kmajor(sQ, C::BM, 0, k), k > 0);
        wgmma_commit();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<T, C::BM>(dpt, kmajor(sV, C::BN, cw * 64, k),
                          kmajor(sdO, C::BM, 0, k), k > 0);
        wgmma_commit();
        wgmma_wait<1>();  // S^T is in; dP^T may still run
        fence_regs(st);

        // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - delta); the
        // statistics are indexed by query, the column
        const float* lse = sm.ptr<float>(sStats + s * C::STATS);
        const float* dl = lse + C::BM;
        const bool edge = m0 + C::BM > p.tq || wg_key + 64 > p.tk ||
                          (p.causal && wg_key + 63 > m0 + offset);
#pragma unroll
        for (int e = 0; e < C::BM / 2; ++e)
          st[e] = exp_shifted(st[e], lse[8 * (e / 4) + 2 * qd + (e & 1)],
                              p);
        if (edge) {
#pragma unroll
          for (int e = 0; e < C::BM / 2; ++e) {
            const int key = key0 + 8 * ((e / 2) & 1);
            const int query = m0 + 8 * (e / 4) + 2 * qd + (e & 1);
            if (key >= p.tk || query >= p.tq ||
                (p.causal && key > query + offset))
              st[e] = 0.f;
          }
        }
        uint32_t pa[C::BM / 4], dsa[C::BM / 4];
        pack_a<T, C::BM>(st, pa);

        // dV += P^T dO (dO read transposed) runs while dS^T is formed
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BM / 16; ++k)
          wgmma_rs<T, D>(dv, &pa[4 * k], mnmajor(sdO, C::BM, k));
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is in
        fence_regs(dpt);
#pragma unroll
        for (int e = 0; e < C::BM / 2; ++e)
          dpt[e] = st[e] * (dpt[e] - dl[8 * (e / 4) + 2 * qd + (e & 1)]);
        pack_a<T, C::BM>(dpt, dsa);

        // dK += dS^T Q (Q read transposed)
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BM / 16; ++k)
          wgmma_rs<T, D>(dk, &dsa[4 * k], mnmajor(sQ, C::BM, k));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      if (lane == 0) mbar_arrive(kv_empty + 8 * kb);
      store_rows<D>(dk, p.dk + b * p.dk_b + h * p.dk_h, p.dk_s, key0, p.tk,
                    p.scale);
      store_rows<D>(dv, p.dv + b * p.dv_b + h * p.dv_h, p.dv_s, key0, p.tk,
                    1.f);
    }
  }
}

// -- pass 3: dQ per 128-query item ------------------------------------------------
template <int D>
struct Dq {
  static constexpr int BM = 128;  // queries per item (2 x 64)
  // keys per streamed tile: S and dP of 128 keys fit beside dQ at d 64
  static constexpr int BN = 64;   // keys per streamed tile
  static constexpr int Q_BYTES = tile_bytes<D>(BM);
  static constexpr int KV_BYTES = tile_bytes<D>(BN);
  static constexpr int STAGES =
      4 * Q_BYTES + 3 * 2 * KV_BYTES <= 200 * 1024 ? 3 : 2;
  static constexpr int STAGE = 2 * KV_BYTES;       // K, then V
  static constexpr int RING_OFF = 4 * Q_BYTES;     // two (Q, dO) buffers
  static constexpr int BARS = RING_OFF + STAGES * STAGE;
  static constexpr int SMEM = 1024 + BARS + 8 * (5 + 2 * STAGES);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ BwdParams<T> p) {
  using C = Dq<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const uint32_t sQOb = sm.base;               // buffer i: Q, then dO
  const uint32_t sKV = sm.base + C::RING_OFF;  // stage s: K, then V
  const uint32_t q_full = sm.base + C::BARS, q_empty = q_full + 16;
  const uint32_t full0 = q_full + 32, empty0 = full0 + 8 * C::STAGES;
  volatile int* slot = sm.ptr<int>(empty0 + 8 * C::STAGES);  // per Q buffer
  const int offset = p.tk - p.tq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 8);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&p.mq);
      tma_prefetch_map(&p.mk);
      tma_prefetch_map(&p.mv);
      tma_prefetch_map(&p.mdo);
      int c = 0;
      for (int it = 0, w = blockIdx.x;; ++it) {
        const int qb = it & 1;
        if (it >= 2) mbar_wait(q_empty + 8 * qb, ((it >> 1) - 1) & 1);
        slot[qb] = w < p.items ? w : -1;
        if (w >= p.items) {
          mbar_arrive(q_full + 8 * qb);
          sched_exit(p.sched);
          break;
        }
        const int bh = w / p.tiles, b = bh / p.H, h = bh % p.H;
        const int m0 = (p.tiles - 1 - w % p.tiles) * C::BM;  // heavy first
        const int n_tiles =
            (key_end(p.causal, m0, C::BM, p.tq, p.tk) + C::BN - 1) / C::BN;
        const uint32_t sQ = sQOb + qb * 2 * C::Q_BYTES, sdO = sQ + C::Q_BYTES;
        mbar_arrive_expect_tx(q_full + 8 * qb, 2 * C::Q_BYTES);
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(sQ + hf * C::BM * 128, &p.mq, q_full + 8 * qb, 64 * hf,
                      h, m0, b);
          tma_load_4d(sdO + hf * C::BM * 128, &p.mdo, q_full + 8 * qb,
                      64 * hf, h, m0, b);
        }
        const int next = atomicAdd(p.sched, 1) + gridDim.x;
        for (int j = 0; j < n_tiles; ++j, ++c) {
          const int s = c % C::STAGES;
          if (c >= C::STAGES) mbar_wait(empty0 + 8 * s, (c / C::STAGES - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t sK = sKV + s * C::STAGE, sV = sK + C::KV_BYTES;
          mbar_arrive_expect_tx(full, C::STAGE);
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(sK + hf * C::BN * 128, &p.mk, full, 64 * hf, h,
                        j * C::BN, b);
            tma_load_4d(sV + hf * C::BN * 128, &p.mv, full, 64 * hf, h,
                        j * C::BN, b);
          }
        }
        w = next;
      }
    }
  } else {  // ---- consumer warpgroups: 64 query rows each
    reg_alloc<CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32, qd = lane & 3;
    int c = 0;
    for (int it = 0;; ++it) {
      const int qb = it & 1;
      mbar_wait(q_full + 8 * qb, (it >> 1) & 1);
      const int w = slot[qb];
      if (w < 0) break;
      const int bh = w / p.tiles, b = bh / p.H, h = bh % p.H;
      const int m0 = (p.tiles - 1 - w % p.tiles) * C::BM;
      const int n_tiles =
          (key_end(p.causal, m0, C::BM, p.tq, p.tk) + C::BN - 1) / C::BN;
      const int wg_row = m0 + cw * 64;
      const int row0 = wg_row + (t / 32) * 16 + lane / 4;  // and row0 + 8
      const uint32_t sQ = sQOb + qb * 2 * C::Q_BYTES, sdO = sQ + C::Q_BYTES;
      float lse[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long i = (long long)bh * p.tq + row;
        lse[r] = row < p.tq ? lse_stat<T>(p.lse[i]) : 0.f;
        dl[r] = row < p.tq ? p.delta[i] : 0.f;
      }
      float dq[D / 2];
      zero(dq);

      for (int j = 0; j < n_tiles; ++j, ++c) {
        const int s = c % C::STAGES, n0 = j * C::BN;
        const uint32_t sK = sKV + s * C::STAGE, sV = sK + C::KV_BYTES;
        mbar_wait(full0 + 8 * s, (c / C::STAGES) & 1);

        // S = Q K^T and dP = dO V^T (64 queries x 64 keys)
        float sc[C::BN / 2], dp[C::BN / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<T, C::BN>(sc, kmajor(sQ, C::BM, cw * 64, k),
                          kmajor(sK, C::BN, 0, k), k > 0);
        wgmma_commit();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<T, C::BN>(dp, kmajor(sdO, C::BM, cw * 64, k),
                          kmajor(sV, C::BN, 0, k), k > 0);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; dP may still run
        fence_regs(sc);

        const bool edge = wg_row + 64 > p.tq || n0 + C::BN > p.tk ||
                          (p.causal && n0 + C::BN - 1 > wg_row + offset);
#pragma unroll
        for (int e = 0; e < C::BN / 2; ++e)
          sc[e] = exp_shifted(sc[e], lse[(e / 2) & 1], p);
        if (edge) {
#pragma unroll
          for (int e = 0; e < C::BN / 2; ++e) {
            const int key = n0 + 8 * (e / 4) + 2 * qd + (e & 1);
            const int row = row0 + 8 * ((e / 2) & 1);
            if (key >= p.tk || row >= p.tq || (p.causal && key > row + offset))
              sc[e] = 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int e = 0; e < C::BN / 2; ++e)
          dp[e] = sc[e] * (dp[e] - dl[(e / 2) & 1]);
        uint32_t dsa[C::BN / 4];
        pack_a<T, C::BN>(dp, dsa);

        // dQ += dS K (K read transposed)
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BN / 16; ++k)
          wgmma_rs<T, D>(dq, &dsa[4 * k], mnmajor(sK, C::BN, k));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);
      store_rows<D>(dq, p.dq + b * p.dq_b + h * p.dq_h, p.dq_s, row0, p.tq,
                    p.scale);
    }
  }
}

// ---- launches ------------------------------------------------------------------
// Opts the kernel into `bytes` of dynamic shared memory (once per process
// and device; the attribute holds for later launches).
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done[dev] = e == cudaSuccess;
  return e;
}

// Persistent grid: one block per SM, at most one per item.
int grid_for(int items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return items < sms ? items : sms;
}

template <typename T, int D>
int launch_fwd(FwdParams<T>& p, const void* q, const void* k, const void* v,
               const Geometry* g, cudaStream_t stream) {
  using C = Fwd<D>;
  int err;
  constexpr CUtensorMapDataType type = tma_type<T>();
  if ((err = encode_operand(&p.mq, q, g[0], C::BM, type)) ||
      (err = encode_operand(&p.mk, k, g[1], C::BN, type)) ||
      (err = encode_operand(&p.mv, v, g[2], C::BN, type)))
    return err;
  p.tiles = (p.tq + C::BM - 1) / C::BM;
  p.items = p.BH * p.tiles;
  cudaError_t e = allow_smem<fwd_kernel<T, D>>(C::SMEM);
  if (e != cudaSuccess) return (int)e;
  fwd_kernel<T, D><<<grid_for(p.items), THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(BwdParams<T>& p, const void* const* ptrs, const Geometry* g,
               int passes, cudaStream_t stream) {
  constexpr CUtensorMapDataType type = tma_type<T>();
  cudaError_t e;
  if (passes & PASS_DELTA) {
    const int rows = p.BH * p.tq;
    constexpr int per_block = 256 / (D / 8);
    delta_kernel<T, D>
        <<<(rows + per_block - 1) / per_block, 256, 0, stream>>>(p, rows);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  int err;
  if (passes & PASS_DKV) {
    using C = Dkv<D>;
    if ((err = encode_operand(&p.mq, ptrs[0], g[0], C::BM, type)) ||
        (err = encode_operand(&p.mk, ptrs[1], g[1], C::BN, type)) ||
        (err = encode_operand(&p.mv, ptrs[2], g[2], C::BN, type)) ||
        (err = encode_operand(&p.mdo, ptrs[4], g[4], C::BM, type)))
      return err;
    p.tiles = (p.tk + C::BN - 1) / C::BN;
    p.items = p.BH * p.tiles;
    if ((e = allow_smem<dkv_kernel<T, D>>(C::SMEM)) != cudaSuccess)
      return (int)e;
    dkv_kernel<T, D><<<grid_for(p.items), THREADS, C::SMEM, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (passes & PASS_DQ) {
    using C = Dq<D>;
    if ((err = encode_operand(&p.mq, ptrs[0], g[0], C::BM, type)) ||
        (err = encode_operand(&p.mk, ptrs[1], g[1], C::BN, type)) ||
        (err = encode_operand(&p.mv, ptrs[2], g[2], C::BN, type)) ||
        (err = encode_operand(&p.mdo, ptrs[4], g[4], C::BM, type)))
      return err;
    p.tiles = (p.tq + C::BM - 1) / C::BM;
    p.items = p.BH * p.tiles;
    if ((e = allow_smem<dq_kernel<T, D>>(C::SMEM)) != cudaSuccess)
      return (int)e;
    p.sched += 2;  // the dQ pass's own counter pair
    dq_kernel<T, D><<<grid_for(p.items), THREADS, C::SMEM, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

bool bad_sizes(int B, int H, int tq, int tk, int causal) {
  return B <= 0 || H <= 0 || tq <= 0 || tk <= 0 || (causal && tq > tk) ||
         (long long)B * H * tq > 0x7fffffffLL ||
         (long long)B * H > 0x7fffffffLL;
}

// One forward launch in element type T (operands checked by the caller).
template <typename T>
int run_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
            const Geometry* g, int B, int H, int tq, int tk, int d,
            int causal, float scale, void* sched, cudaStream_t stream) {
  FwdParams<T> p;
  p.o = static_cast<T*>(o);
  p.o_b = g[3].eb();
  p.o_s = g[3].es();
  p.o_h = g[3].eh();
  p.lse = static_cast<float*>(lse);
  p.sched = static_cast<int*>(sched);
  p.H = H;
  p.BH = B * H;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  switch (d) {
    case 64:
      return launch_fwd<T, 64>(p, q, k, v, g, stream);
    case 128:
      return launch_fwd<T, 128>(p, q, k, v, g, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward's launches in element type T, as flash_sm90_bwd.
template <typename T>
int run_bwd(const void* const* ptrs, const Geometry* g, const void* lse,
            void* delta, int B, int H, int tq, int tk, int d, int causal,
            float scale, int passes, void* sched, cudaStream_t stream) {
  BwdParams<T> p;
  p.o = static_cast<const T*>(ptrs[3]);
  p.dout = static_cast<const T*>(ptrs[4]);
  p.dq = static_cast<T*>(const_cast<void*>(ptrs[5]));
  p.dk = static_cast<T*>(const_cast<void*>(ptrs[6]));
  p.dv = static_cast<T*>(const_cast<void*>(ptrs[7]));
  p.o_b = g[3].eb(), p.o_s = g[3].es(), p.o_h = g[3].eh();
  p.do_b = g[4].eb(), p.do_s = g[4].es(), p.do_h = g[4].eh();
  p.dq_b = g[5].eb(), p.dq_s = g[5].es(), p.dq_h = g[5].eh();
  p.dk_b = g[6].eb(), p.dk_s = g[6].es(), p.dk_h = g[6].eh();
  p.dv_b = g[7].eb(), p.dv_s = g[7].es(), p.dv_h = g[7].eh();
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.sched = static_cast<int*>(sched);
  p.H = H;
  p.BH = B * H;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.tiles = p.items = 0;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  switch (d) {
    case 64:
      return launch_bwd<T, 64>(p, ptrs, g, passes, stream);
    case 128:
      return launch_bwd<T, 128>(p, ptrs, g, passes, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// geo: 7 values per operand, [D, H, S, B, byte stride of H, of S, of B]
// (sm90_common.cuh Geometry), for q, k, v and out in that order.  lse:
// (B, H, Tq) fp32, or null.  d: 64 or 128.  dtype: the operands' type,
// DTYPE_BF16 (1) or DTYPE_F16 (2); any other code returns ERR_DTYPE.
// sched: two int32, zero, that the launch leaves zero (the item counter
// and its exit count; one pair per stream).  Returns 0 when launched, a
// cudaError_t, or an sm90 error code (flash_sm90_error_string).
extern "C" int flash_sm90_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* geo, int B,
                              int H, int tq, int tk, int d, int dtype,
                              int causal, float scale, void* sched,
                              void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (bad_sizes(B, H, tq, tk, causal)) return (int)cudaErrorInvalidValue;
  Geometry g[4];
  for (int i = 0; i < 4; ++i) g[i] = geometry(geo + 7 * i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_BF16:
      return run_fwd<__nv_bfloat16>(q, k, v, o, lse, g, B, H, tq, tk, d,
                                    causal, scale, sched, s);
    case DTYPE_F16:
      return run_fwd<__half>(q, k, v, o, lse, g, B, H, tq, tk, d, causal,
                             scale, sched, s);
    default:
      return ERR_DTYPE;
  }
}

// ptrs: q, k, v, out, dout, dq, dk, dv; geo: 7 values per operand in the
// same order.  lse is the forward's (B, H, Tq) fp32; delta is (B, H, Tq)
// fp32 scratch that the delta pass fills and the other two read.  dtype
// as flash_sm90_fwd's.  passes: bit mask of 1 (delta), 2 (dK/dV) and 4
// (dQ).  sched: four int32, zero, that the launches leave zero (the dK/dV
// and the dQ pass's counter pairs; one set per stream).
extern "C" int flash_sm90_bwd(const void* const* ptrs, const long long* geo,
                              const void* lse, void* delta, int B, int H,
                              int tq, int tk, int d, int dtype, int causal,
                              float scale, int passes, void* sched,
                              void* stream) {
  cudaGetLastError();
  if (bad_sizes(B, H, tq, tk, causal) || passes < 0 || passes > 7)
    return (int)cudaErrorInvalidValue;
  Geometry g[8];
  for (int i = 0; i < 8; ++i) g[i] = geometry(geo + 7 * i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_BF16:
      return run_bwd<__nv_bfloat16>(ptrs, g, lse, delta, B, H, tq, tk, d,
                                    causal, scale, passes, sched, s);
    case DTYPE_F16:
      return run_bwd<__half>(ptrs, g, lse, delta, B, H, tq, tk, d, causal,
                             scale, passes, sched, s);
    default:
      return ERR_DTYPE;
  }
}

extern "C" const char* flash_sm90_error_string(int code) {
  if (code == ERR_NO_DRIVER)
    return "cuTensorMapEncodeTiled not found (libcuda.so.1)";
  if (code >= ERR_ENCODE && code < ERR_ENCODE + 10000)
    return "cuTensorMapEncodeTiled refused an operand (CUresult = code - "
           "20001)";
  if (code == ERR_DTYPE)
    return "flash_attn_sm90 takes type codes 1 (bf16) and 2 (fp16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
