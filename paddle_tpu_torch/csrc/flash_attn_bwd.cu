// Flash-attention backward over strided (B, S, H, D) operands, for Hopper
// (sm_90a).
//
// Replaces six TPU kernels of paddle_tpu/ops/pallas/flash_attention.py,
// each of which computes dq, dk, dv of out = softmax(q k^T * scale) v:
//   _small_bwd_kernel    row 6: launched by _small_flash_bwd, Tk <= 512;
//                        lse and delta rebuilt in-kernel
//   _tiled_bwd_kernel    row 7: launched by _tiled_flash_bwd, 512 < Tk <=
//                        4096; q-block tiled, f32 dK/dV accumulators
//   _bwd_dq_kernel       row 8: the first call of _flash_bwd, T > 4096;
//                        dQ from the saved lse and delta = rowsum(dO * O)
//   _bwd_dkv_kernel      row 9: the second call of _flash_bwd; dK/dV
//   _qkv_bwd_kernel      row 4: launched by _qkv_small_bwd, T <= 512, on
//                        the packed (B, T, 3F) projection
//   _qkv_mid_bwd_kernel  row 5: launched by _qkv_mid_bwd, 512 < T <= 2048
// The port saves the forward's fp32 lse (B, H, Tq) for every length, so
// one FlashAttention-2 backward from lse and delta serves all six.
//
// Operands: q, dq are (B, Tq, H, D); k, v, dk, dv are (B, Tk, H, D); out
// and dout are (B, Tq, H, D).  Each is addressed by its own element strides
// (batch, row, head) with a contiguous last axis, so the gradients of a
// packed projection go straight into their column blocks of one
// (B, T, 3F) tensor and those of split views into (B, S, H, D) tensors,
// with no fold or unfold copy.  Head dims D in {16, 32, 64, 80, 96, 128}:
// fp32 at all of them, bf16 and fp16 at 16, 32, 80 and 96 (both at D 64
// and 128 run flash_attn_sm90.cu); causal masking bottom-right aligned
// (query i sees key j iff j <= i + Tk - Tq, with Tq <= Tk), or none; any
// Tq and Tk, masked at the ragged edge.  P = exp(s - lse) is cast to dO's type for
// dV and dS = P (dP - delta) to q's type for dQ and dK, every product
// accumulating in fp32, as in the reference.
//
// What bounds it on an H100: per (batch, head) the causal backward needs
// 5*Tq*Tk*D flops (S, dP, dV, dQ, dK, half of each square product) on
// 4*(Tq + Tk)*D elements read and written; the two passes below recompute
// S and dP, 7*Tq*Tk*D in all.  bf16 and fp16 run on mma.sync m16n8k16
// (ldmatrix operands, fp32 accumulators): bound by the bytes up to T ~ 512 and by
// the arithmetic above.  fp32 runs on the tensor cores in split precision
// (3xTF32, tile_common.cuh: three tf32 products per fp32 product, an
// effective 165 TFLOP/s), bound by the arithmetic past T ~ 100, within
// the reference's fp32 tolerances.  Q/dO (dK/dV pass) and K/V (dQ pass)
// are re-read once per 64-row tile, mostly from L2.
//
// Design (FlashAttention-2 shape, no atomics, so results are
// deterministic), three launches selected by the `passes` bit mask:
// - delta (1): delta = rowsum(dO * O) per (b, h, query), one warp a row;
// - dK/dV (2): one block per (b, h, 64 key rows); dK and dV accumulate in
//   registers over the query tiles that see those keys, P rebuilt from lse;
// - dQ (4): one block per (b, h, 64 query rows); dQ accumulates over the
//   key tiles the rows see.
// Tiles wholly outside the causal band are skipped in both passes, and the
// heaviest causal tiles take the lowest block indices (first keys in the
// dK/dV pass, last queries in the dQ pass).  The streamed tiles (Q, dO and
// their lse and delta; K, V) load on cp.async into one shared-memory
// stage.  A second stage, so the next tile loads while this one is
// multiplied, was measured on the card (PERF.md, tools/kernel_ab.py):
// ~10% slower at fp32 d 64 and at d 128 (its dQ pass), 4% faster at
// d 96, level at d 16 and 80.
// Eight warps share a 64-row tile: warp w takes rows 16*(w % 4) and one
// half of the columns (tile_common.cuh gives the accumulator layout); P
// and dS go through shared memory to the products that take them as the
// A operand.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_common.cuh"

namespace {

using tile::NEG_INF;
using tile::Strides;
using tile::Warp;

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // key rows per tile
constexpr int THREADS = 256;  // eight warps
constexpr int PASS_DELTA = 1, PASS_DKV = 2, PASS_DQ = 4;

template <typename T, int D>
struct Cfg {
  static constexpr int LDT = D + tile::pad<T>();  // q, k, v, dO tiles
  static constexpr int LDP = BN + 8;  // P, dS tiles (fp32: 8 mod 32 words)
  static constexpr int NTD = D / 16;  // 8-column blocks per warp over D
  static constexpr size_t TILE = sizeof(T) * (size_t)64 * LDT;
  static constexpr size_t PTILE = sizeof(T) * (size_t)64 * LDP;
  static constexpr size_t STATS = sizeof(float) * 2 * 64;
  // dK/dV: K, V, Q, dO, lse, delta, P and dS
  static constexpr size_t dkv_bytes = 4 * TILE + STATS + 2 * PTILE;
  // dQ: Q, dO, lse, delta, K, V and dS
  static constexpr size_t dq_bytes = 4 * TILE + STATS + PTILE;
  static_assert(D % 16 == 0 && dkv_bytes <= tile::SMEM_PER_BLOCK &&
                    dq_bytes <= tile::SMEM_PER_BLOCK,
                "head dim not built");
};

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;  // (B, H, Tq)
  float* delta;      // (B, H, Tq), written by the delta pass
  int H, tq, tk, causal;
  float scale;
};

// -- pass 1: delta = rowsum(dO * O) ------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_delta_kernel(const BwdArgs<T> a, int rows) {
  // row r = (b*H + h)*Tq + t, so the warps of a block write neighbours
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int t = r % a.tq, bh = r / a.tq, b = bh / a.H, h = bh % a.H;
  const T* o = a.so.head(a.o, b, h) + (size_t)t * a.so.s_;
  const T* d = a.sdo.head(a.dout, b, h) + (size_t)t * a.sdo.s_;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(tile::to_f32(o[c]), tile::to_f32(d[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) a.delta[r] = acc;
}

// The probabilities and dS = P * (dP - delta) of one 16 x 32 warp tile.
// Rows of the tile are keys when KEY_ROWS (dK/dV pass: P^T) and queries
// otherwise (dQ pass: P); the statistics are indexed by query.
template <typename T, int LDP, bool KEY_ROWS>
__device__ void softmax_grad(const float (&s)[4][4], const float (&dp)[4][4],
                             const Warp& w, int r0, int c0,
                             const BwdArgs<T>& a, const float* sLse,
                             const float* sDelta, T* sP, T* sdS) {
  const int offset = a.tk - a.tq;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = w.wm + w.g + 8 * half;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = w.wn * 32 + 8 * j + 2 * w.t + e;
        const int key = KEY_ROWS ? r0 + rl : c0 + cl;
        const int query = KEY_ROWS ? c0 + cl : r0 + rl;
        const int ql = KEY_ROWS ? cl : rl;
        const bool live = key < a.tk && query < a.tq &&
                          (!a.causal || key <= query + offset);
        const float x = s[j][2 * half + e] * a.scale - sLse[ql];
        p[e] = live ? expf(x) : 0.f;
        ds[e] = p[e] * (dp[j][2 * half + e] - sDelta[ql]);
      }
      const int off = rl * LDP + w.wn * 32 + 8 * j + 2 * w.t;
      if (sP != nullptr) tile::store_pair(sP + off, p[0], p[1]);
      tile::store_pair(sdS + off, ds[0], ds[1]);
    }
  }
}

// The lse and delta of query rows m0.. of head (b, h) into shared memory.
template <typename T>
__device__ void load_stats(const BwdArgs<T>& a, int bh, int m0, float* sLse,
                           float* sDelta) {
  if (threadIdx.x < BM) {
    const int m = m0 + threadIdx.x;
    const size_t i = (size_t)bh * a.tq + m;
    sLse[threadIdx.x] = m < a.tq ? a.lse[i] : 0.f;
    sDelta[threadIdx.x] = m < a.tq ? a.delta[i] : 0.f;
  }
}

// Writes a 64 x D accumulator (times `mult`) as T to rows r0.. (of nrows)
// of a matrix with row stride ld.
template <typename T, int NTD>
__device__ void store_acc(const float (&acc)[NTD][4], const Warp& w,
                          T* base, size_t ld, int r0, int nrows, float mult,
                          int D) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + w.wm + w.g + 8 * half;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < NTD; ++j) {
      const int col = w.wn * (D / 2) + 8 * j + 2 * w.t;
      tile::store_pair(base + (size_t)r * ld + col, acc[j][2 * half] * mult,
                       acc[j][2 * half + 1] * mult);
    }
  }
}

// -- pass 2: dK, dV per key tile -------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_dkv_kernel(const BwdArgs<T> a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BN * C::LDT;
  T* sQ = sV + BN * C::LDT;
  T* sdO = sQ + BM * C::LDT;
  T* sP = sdO + BM * C::LDT;
  T* sdS = sP + BN * C::LDP;
  float* sLse = reinterpret_cast<float*>(sdS + BN * C::LDP);
  float* sDelta = sLse + BM;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n0 = blockIdx.y * BN;  // the first keys see the most queries
  const T* qb = a.sq.head(a.q, b, h);
  const T* dob = a.sdo.head(a.dout, b, h);
  const Warp w;
  auto load_q = [&](int m0) {
    tile::copy_rows_async<T, BM, D, C::LDT, THREADS>(qb, a.sq.s_, m0, a.tq,
                                                     sQ);
    tile::copy_rows_async<T, BM, D, C::LDT, THREADS>(dob, a.sdo.s_, m0, a.tq,
                                                     sdO);
    tile::cp_async_commit();
    load_stats(a, bh, m0, sLse, sDelta);
  };

  tile::copy_rows_async<T, BN, D, C::LDT, THREADS>(a.sk.head(a.k, b, h),
                                                   a.sk.s_, n0, a.tk, sK);
  tile::copy_rows_async<T, BN, D, C::LDT, THREADS>(a.sv.head(a.v, b, h),
                                                   a.sv.s_, n0, a.tk, sV);
  float dk[C::NTD][4], dv[C::NTD][4];
  tile::zero(dk);
  tile::zero(dv);

  // causal: key n is seen by the queries m >= n - (Tk - Tq), so the first
  // query tile is the one holding max(0, n0 - (Tk - Tq))
  const int m_begin =
      a.causal ? max(0, n0 - (a.tk - a.tq)) / BM * BM : 0;
  load_q(m_begin);  // one group with K and V; m_begin < Tq always
  for (int m0 = m_begin; m0 < a.tq; m0 += BM) {
    if (m0 > m_begin) {
      __syncthreads();  // every warp is done with the previous tile
      load_q(m0);
    }
    tile::cp_async_wait<0>();
    __syncthreads();  // this tile is visible to all

    float s[4][4], dp[4][4];
    tile::zero(s);
    tile::zero(dp);
    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    tile::attn_mma<T, 4, true>(s, sK, C::LDT, sQ, C::LDT, w.wm, w.wn * 32,
                               D);
    tile::attn_mma<T, 4, true>(dp, sV, C::LDT, sdO, C::LDT, w.wm,
                               w.wn * 32, D);
    softmax_grad<T, C::LDP, true>(s, dp, w, n0, m0, a, sLse, sDelta, sP,
                                  sdS);
    __syncthreads();
    // dV += P^T dO,  dK += dS^T Q
    tile::attn_mma<T, C::NTD, false>(dv, sP, C::LDP, sdO, C::LDT, w.wm,
                                     w.wn * (D / 2), BM);
    tile::attn_mma<T, C::NTD, false>(dk, sdS, C::LDP, sQ, C::LDT, w.wm,
                                     w.wn * (D / 2), BM);
  }

  store_acc<T, C::NTD>(dk, w, a.sdk.head(a.dk, b, h), a.sdk.s_, n0, a.tk,
                       a.scale, D);
  store_acc<T, C::NTD>(dv, w, a.sdv.head(a.dv, b, h), a.sdv.s_, n0, a.tk,
                       1.f, D);
}

// -- pass 3: dQ per query tile -------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_dq_kernel(const BwdArgs<T> a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BM * C::LDT;
  T* sK = sdO + BM * C::LDT;
  T* sV = sK + BN * C::LDT;
  T* sdS = sV + BN * C::LDT;
  float* sLse = reinterpret_cast<float*>(sdS + BM * C::LDP);
  float* sDelta = sLse + BM;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // heaviest causal tiles first: block row 0 takes the last query tile
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const T* kb = a.sk.head(a.k, b, h);
  const T* vb = a.sv.head(a.v, b, h);
  const Warp w;
  auto load_kv = [&](int n0) {
    tile::copy_rows_async<T, BN, D, C::LDT, THREADS>(kb, a.sk.s_, n0, a.tk,
                                                     sK);
    tile::copy_rows_async<T, BN, D, C::LDT, THREADS>(vb, a.sv.s_, n0, a.tk,
                                                     sV);
    tile::cp_async_commit();
  };

  tile::copy_rows_async<T, BM, D, C::LDT, THREADS>(a.sq.head(a.q, b, h),
                                                   a.sq.s_, m0, a.tq, sQ);
  tile::copy_rows_async<T, BM, D, C::LDT, THREADS>(a.sdo.head(a.dout, b, h),
                                                   a.sdo.s_, m0, a.tq, sdO);
  load_stats(a, bh, m0, sLse, sDelta);
  load_kv(0);  // one group with Q and dO
  float dq[C::NTD][4];
  tile::zero(dq);
  // keys past the tile's last live query row are masked for every row
  const int n_end =
      a.causal ? min(a.tk, min(m0 + BM, a.tq) + a.tk - a.tq) : a.tk;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    if (n0 > 0) {
      __syncthreads();  // every warp is done with the previous tile
      load_kv(n0);
    }
    tile::cp_async_wait<0>();
    __syncthreads();  // this tile is visible to all

    float s[4][4], dp[4][4];
    tile::zero(s);
    tile::zero(dp);
    // S = Q K^T and dP = dO V^T: rows are queries, columns keys
    tile::attn_mma<T, 4, true>(s, sQ, C::LDT, sK, C::LDT, w.wm, w.wn * 32,
                               D);
    tile::attn_mma<T, 4, true>(dp, sdO, C::LDT, sV, C::LDT, w.wm,
                               w.wn * 32, D);
    softmax_grad<T, C::LDP, false>(s, dp, w, m0, n0, a, sLse, sDelta,
                                   nullptr, sdS);
    __syncthreads();
    // dQ += dS K
    tile::attn_mma<T, C::NTD, false>(dq, sdS, C::LDP, sK, C::LDT, w.wm,
                                     w.wn * (D / 2), BN);
  }

  store_acc<T, C::NTD>(dq, w, a.sdq.head(a.dq, b, h), a.sdq.s_, m0, a.tq,
                       a.scale, D);
}

// -- launches --------------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch(const BwdArgs<T>& a, int B, int passes,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  cudaError_t err = cudaSuccess;
  if (passes & PASS_DELTA) {
    const int rows = B * a.H * a.tq;
    const int per_block = THREADS / 32;
    attn_delta_kernel<T, D>
        <<<(rows + per_block - 1) / per_block, THREADS, 0, stream>>>(a,
                                                                     rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & PASS_DKV) {
    if ((err = allow_smem(attn_dkv_kernel<T, D>, C::dkv_bytes)) !=
        cudaSuccess)
      return err;
    const dim3 grid(B * a.H, (a.tk + BN - 1) / BN);
    attn_dkv_kernel<T, D><<<grid, THREADS, C::dkv_bytes, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & PASS_DQ) {
    if ((err = allow_smem(attn_dq_kernel<T, D>, C::dq_bytes)) != cudaSuccess)
      return err;
    const dim3 grid(B * a.H, (a.tq + BM - 1) / BM);
    attn_dq_kernel<T, D><<<grid, THREADS, C::dq_bytes, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return err;
}

template <typename T>
cudaError_t run(const void* const* ptrs, const long long* st, const void* lse,
                void* delta, int B, int H, int tq, int tk, int d, int causal,
                float scale, int passes, cudaStream_t stream) {
  auto strides = [st](int i) {
    return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  };
  const BwdArgs<T> a{static_cast<const T*>(ptrs[0]),
                     static_cast<const T*>(ptrs[1]),
                     static_cast<const T*>(ptrs[2]),
                     static_cast<const T*>(ptrs[3]),
                     static_cast<const T*>(ptrs[4]),
                     static_cast<T*>(const_cast<void*>(ptrs[5])),
                     static_cast<T*>(const_cast<void*>(ptrs[6])),
                     static_cast<T*>(const_cast<void*>(ptrs[7])),
                     strides(0),
                     strides(1),
                     strides(2),
                     strides(3),
                     strides(4),
                     strides(5),
                     strides(6),
                     strides(7),
                     static_cast<const float*>(lse),
                     static_cast<float*>(delta),
                     H,
                     tq,
                     tk,
                     causal,
                     scale};
  switch (d) {
    case 16:
      return launch<T, 16>(a, B, passes, stream);
    case 32:
      return launch<T, 32>(a, B, passes, stream);
    case 80:
      return launch<T, 80>(a, B, passes, stream);
    case 96:
      return launch<T, 96>(a, B, passes, stream);
  }
  // bf16 and fp16 at d 64 / 128 run flash_attn_sm90.cu; fp32 runs here
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 64:
        return launch<T, 64>(a, B, passes, stream);
      case 128:
        return launch<T, 128>(a, B, passes, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ptrs: q, k, v, out, dout, dq, dk, dv; strides: 24 element strides,
// (batch, row, head) of each in the same order.  lse is the forward's
// (B, H, Tq) fp32; delta is (B, H, Tq) fp32 scratch that the delta pass
// fills and the other two read.  passes: bit mask of 1 (delta), 2 (dK/dV)
// and 4 (dQ); 7 runs the whole backward.  dtype: 0 = float32, 1 =
// bfloat16, 2 = float16.  Returns a cudaError_t (0 = all launched).
extern "C" int flash_attn_bwd(const void* const* ptrs,
                              const long long* strides, const void* lse,
                              void* delta, int B, int H, int tq, int tk,
                              int d, int dtype, int causal, float scale,
                              int passes, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0 || (causal && tq > tk) ||
      (long long)B * H * tq > 0x7fffffffLL || (tq + BM - 1) / BM > 65535 ||
      (tk + BN - 1) / BN > 65535 || passes < 0 || passes > 7)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)run<float>(ptrs, strides, lse, delta, B, H, tq, tk, d,
                             causal, scale, passes, s);
    case 1:
      return (int)run<__nv_bfloat16>(ptrs, strides, lse, delta, B, H, tq, tk,
                                     d, causal, scale, passes, s);
    case 2:
      return (int)run<__half>(ptrs, strides, lse, delta, B, H, tq, tk, d,
                              causal, scale, passes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
