// Packed-QKV flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   _qkv_fwd_kernel      (launched by _qkv_small_fwd, for _flash_qkv and
//                         _flash_qkv_mid)
//   _qkv_bwd_kernel      (launched by _qkv_small_bwd, T <= 512)
//   _qkv_mid_bwd_kernel  (launched by _qkv_mid_bwd, 512 < T <= 2048)
//
// Input qkv is (B, T, 3F) with F = H*d, laid out [q heads | k heads |
// v heads]: head h reads q at column h*d, k at F + h*d, v at 2F + h*d, row
// stride 3F.  No head-split copy is made.  The forward writes
// ctx (B, T, F) = softmax(q k^T * scale) v per head, and lse (B, H, T) in
// fp32 for the backward.  The backward writes dq | dk | dv straight into
// one (B, T, 3F) gradient in the packed layout, as _qkv_bwd_kernel does.
// fp32 or bf16; d in {32, 64, 128}; causal (bottom-right aligned, with
// Tq == Tk here) or not; any T (the ragged edge is masked, where the TPU
// kernels needed multiples of 128).  Softmax statistics are fp32, masked
// scores take the finite NEG_INF = -1e30, and p is cast to v's type
// before the P V product, as in the reference.
//
// What bounds it on an H100: per head, the causal forward does 2*T^2*d
// flops on 4*T*d elements (q, k, v read, ctx written) and the backward
// 5*T^2*d flops (S, dP, dV, dQ, dK) on 8*T*d elements.  In bf16 on the
// tensor cores (~295 flops per byte of device memory) that is T/4 and
// 5T/16 flops per byte: at the train path's T = 512 both are bound by the
// bytes, from T ~ 1024 up by the arithmetic.  fp32 on FMAs (~20 flops per
// byte) is bound by the arithmetic at every T past ~160.  In bf16 every
// product runs on the tensor cores (mma.sync m16n8k16, fp32
// accumulation) with operands read from shared memory by ldmatrix; fp32
// runs on FMAs for its 2e-5 parity.  The kernels re-read K/V (forward, dQ)
// or Q/dO (dK/dV) once per 64-row tile, from L2 for the most part; wgmma,
// TMA, a pipeline of tile loads and larger tiles are later work.
//
// Design (FlashAttention-2 shape, no atomics, so the backward is
// deterministic):
// - forward: one 256-thread block per (b, h, 64 query rows); 64-row K/V
//   tiles stream through shared memory, tiles above the causal diagonal
//   are never loaded, the online softmax keeps its running max and sum in
//   fp32 and rescales the output accumulators (registers) per tile;
// - backward pass 0: delta = rowsum(dO * O) per (b, h, row), a warp each;
// - backward pass 1: one block per (b, h, 64 key rows); dK and dV
//   accumulate in registers over the query tiles that see those keys,
//   P is rebuilt from the saved lse;
// - backward pass 2: one block per (b, h, 64 query rows); dQ accumulates
//   over the key tiles.
// Eight warps share a 64-row tile: warp w takes rows 16*(w % 4) and one
// half of the columns (tile_common.cuh gives the accumulator layout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

using tile::NEG_INF;

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // key rows per tile
constexpr int THREADS = 256;  // eight warps

template <typename T, int D>
struct Cfg {
  static constexpr int LDT = D + tile::pad<T>();   // q, k, v, dO tiles
  static constexpr int LDP = BN + tile::pad<T>();  // P and dS tiles
  static constexpr int LDS = BN + 4;               // fp32 score tile
  static constexpr int NTD = D / 16;  // 8-column blocks per warp over d
  static constexpr size_t TILE = sizeof(T) * (size_t)64 * LDT;
  static constexpr size_t PTILE = sizeof(T) * (size_t)64 * LDP;
  static constexpr size_t STATS = sizeof(float) * 2 * 64;
  static constexpr size_t fwd_bytes =
      3 * TILE + sizeof(float) * (size_t)BM * LDS + PTILE + STATS;
  static constexpr size_t dkv_bytes = 4 * TILE + 2 * PTILE + STATS;
  static constexpr size_t dq_bytes = 4 * TILE + PTILE + STATS;
};

struct Warp {
  int g, t, wm, wn;  // lane group, lane in group, first row, column half
  __device__ Warp() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    wm = (warp & 3) * 16;
    wn = warp >> 2;
  }
};

// -- forward ----------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qkv_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
               float* __restrict__ lse, int T_, int H, int causal,
               float scale) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * C::LDT;
  T* sV = sK + BN * C::LDT;
  float* sS = reinterpret_cast<float*>(sV + BN * C::LDT);
  T* sP = reinterpret_cast<T*>(sS + BM * C::LDS);
  float* sCorr = reinterpret_cast<float*>(sP + BM * C::LDP);
  float* sL = sCorr + BM;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int m0 = blockIdx.y * BM;
  const int F = H * D;
  const size_t ld = 3 * (size_t)F;
  const T* qb = qkv + (size_t)b * T_ * ld + h * D;
  const T* kb = qb + F;
  const T* vb = qb + 2 * F;
  const Warp w;
  const int row = threadIdx.x >> 2;  // softmax: four lanes per query row
  const int sub = threadIdx.x & 3;
  const int qi = m0 + row;

  tile::copy_rows<T, BM, D, C::LDT, THREADS>(qb, ld, m0, T_, sQ);
  float m_i = NEG_INF, l_i = 0.f;
  float o[C::NTD][4];
  tile::zero(o);
  // keys past the tile's last query row are masked for every row
  const int n_end = causal ? min(T_, m0 + BM) : T_;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    tile::copy_rows<T, BN, D, C::LDT, THREADS>(kb, ld, n0, T_, sK);
    tile::copy_rows<T, BN, D, C::LDT, THREADS>(vb, ld, n0, T_, sV);
    __syncthreads();

    float s[4][4];
    tile::zero(s);
    tile::warp_mma<T, 4, true>(s, sQ, C::LDT, sK, C::LDT, w.wm, w.wn * 32,
                               D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = sS + (w.wm + w.g) * C::LDS + w.wn * 32 + 8 * j + 2 * w.t;
      tile::store_pair(dst, s[j][0], s[j][1]);
      tile::store_pair(dst + 8 * C::LDS, s[j][2], s[j][3]);
    }
    __syncthreads();

    // online softmax over keys n0 + sub + 4i of this row
    float x[BN / 4];
    float tile_max = NEG_INF;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const int j = n0 + sub + 4 * i;
      float v = sS[row * C::LDS + sub + 4 * i] * scale;
      if (j >= T_ || (causal && j > qi)) v = NEG_INF;
      x[i] = v;
      tile_max = fmaxf(tile_max, v);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float corr = expf(m_i - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      // keys past T do not exist: their weight is exactly 0
      const float p = (n0 + sub + 4 * i < T_) ? expf(x[i] - m_new) : 0.f;
      row_sum += p;
      sP[row * C::LDP + sub + 4 * i] = tile::from_f32<T>(p);
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l_i = l_i * corr + row_sum;
    m_i = m_new;
    if (sub == 0) sCorr[row] = corr;
    __syncthreads();

    const float c0 = sCorr[w.wm + w.g], c1 = sCorr[w.wm + w.g + 8];
#pragma unroll
    for (int j = 0; j < C::NTD; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
    tile::warp_mma<T, C::NTD, false>(o, sP, C::LDP, sV, C::LDT, w.wm,
                                     w.wn * (D / 2), BN);
  }

  if (sub == 0) {
    sL[row] = l_i;
    if (qi < T_) lse[(size_t)bh * T_ + qi] = m_i + logf(l_i);
  }
  __syncthreads();
  T* ob = out + (size_t)b * T_ * F + h * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w.wm + w.g + 8 * half;
    if (m0 + r >= T_) continue;
    const float inv = 1.f / sL[r];
#pragma unroll
    for (int j = 0; j < C::NTD; ++j) {
      const int col = w.wn * (D / 2) + 8 * j + 2 * w.t;
      tile::store_pair(ob + (size_t)(m0 + r) * F + col,
                       o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    }
  }
}

// -- backward pass 0: delta = rowsum(dO * O) ---------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qkv_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int T_, int H) {
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* o = out + (size_t)r * D;   // row r = (b*T + t)*H + h
  const T* d = dout + (size_t)r * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(tile::to_f32(o[c]), tile::to_f32(d[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int bt = r / H, h = r % H;
    const int b = bt / T_, t = bt % T_;
    delta[((size_t)b * H + h) * T_ + t] = acc;
  }
}

// The probabilities and dS = P * (dP - delta) of one 16 x 32 warp tile.
// Rows of the tile are keys when KEY_ROWS (pass 1: P^T) and queries
// otherwise (pass 2: P); stats are indexed by query.
template <typename T, int LDP, bool KEY_ROWS>
__device__ void softmax_grad(const float (&s)[4][4], const float (&dp)[4][4],
                             const Warp& w, int r0, int c0, int T_,
                             int causal, float scale, const float* sLse,
                             const float* sDelta, T* sP, T* sdS) {
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
        const bool live =
            key < T_ && query < T_ && (!causal || key <= query);
        const float x = s[j][2 * half + e] * scale - sLse[ql];
        p[e] = live ? expf(x) : 0.f;
        ds[e] = p[e] * (dp[j][2 * half + e] - sDelta[ql]);
      }
      const int off = rl * LDP + w.wn * 32 + 8 * j + 2 * w.t;
      if (sP != nullptr) tile::store_pair(sP + off, p[0], p[1]);
      tile::store_pair(sdS + off, ds[0], ds[1]);
    }
  }
}

// Writes a 64 x D accumulator (times `mult`) as T to rows r0.. of a
// matrix with row stride ld.
template <typename T, int NTD>
__device__ void store_acc(const float (&a)[NTD][4], const Warp& w, T* base,
                          size_t ld, int r0, int T_, float mult, int D) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + w.wm + w.g + 8 * half;
    if (r >= T_) continue;
#pragma unroll
    for (int j = 0; j < NTD; ++j) {
      const int col = w.wn * (D / 2) + 8 * j + 2 * w.t;
      tile::store_pair(base + (size_t)r * ld + col, a[j][2 * half] * mult,
                       a[j][2 * half + 1] * mult);
    }
  }
}

// -- backward pass 1: dK, dV per key tile ---------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qkv_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dqkv, int T_,
               int H, int causal, float scale) {
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

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n0 = blockIdx.y * BN;
  const int F = H * D;
  const size_t ld = 3 * (size_t)F;
  const T* qb = qkv + (size_t)b * T_ * ld + h * D;
  const T* dob = dout + (size_t)b * T_ * F + h * D;
  const float* lse_b = lse + (size_t)bh * T_;
  const float* delta_b = delta + (size_t)bh * T_;
  const Warp w;

  tile::copy_rows<T, BN, D, C::LDT, THREADS>(qb + F, ld, n0, T_, sK);
  tile::copy_rows<T, BN, D, C::LDT, THREADS>(qb + 2 * F, ld, n0, T_, sV);
  float dk[C::NTD][4], dv[C::NTD][4];
  tile::zero(dk);
  tile::zero(dv);

  // causal: key n is seen by queries m >= n, so the first query tile is
  // the one holding n0 (BM == BN)
  for (int m0 = causal ? n0 : 0; m0 < T_; m0 += BM) {
    __syncthreads();  // the previous tile's operands are no longer read
    tile::copy_rows<T, BM, D, C::LDT, THREADS>(qb, ld, m0, T_, sQ);
    tile::copy_rows<T, BM, D, C::LDT, THREADS>(dob, F, m0, T_, sdO);
    if (threadIdx.x < BM) {
      const int m = m0 + threadIdx.x;
      sLse[threadIdx.x] = m < T_ ? lse_b[m] : 0.f;
      sDelta[threadIdx.x] = m < T_ ? delta_b[m] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile::zero(s);
    tile::zero(dp);
    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    tile::warp_mma<T, 4, true>(s, sK, C::LDT, sQ, C::LDT, w.wm, w.wn * 32,
                               D);
    tile::warp_mma<T, 4, true>(dp, sV, C::LDT, sdO, C::LDT, w.wm,
                               w.wn * 32, D);
    softmax_grad<T, C::LDP, true>(s, dp, w, n0, m0, T_, causal, scale, sLse,
                                  sDelta, sP, sdS);
    __syncthreads();
    // dV += P^T dO,  dK += dS^T Q
    tile::warp_mma<T, C::NTD, false>(dv, sP, C::LDP, sdO, C::LDT, w.wm,
                                     w.wn * (D / 2), BM);
    tile::warp_mma<T, C::NTD, false>(dk, sdS, C::LDP, sQ, C::LDT, w.wm,
                                     w.wn * (D / 2), BM);
  }

  T* gb = dqkv + (size_t)b * T_ * ld + h * D;
  store_acc<T, C::NTD>(dk, w, gb + F, ld, n0, T_, scale, D);
  store_acc<T, C::NTD>(dv, w, gb + 2 * F, ld, n0, T_, 1.f, D);
}

// -- backward pass 2: dQ per query tile -----------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qkv_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dqkv, int T_, int H, int causal, float scale) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BM * C::LDT;
  T* sK = sdO + BM * C::LDT;
  T* sV = sK + BN * C::LDT;
  T* sdS = sV + BN * C::LDT;
  float* sLse = reinterpret_cast<float*>(sdS + BM * C::LDP);
  float* sDelta = sLse + BM;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int m0 = blockIdx.y * BM;
  const int F = H * D;
  const size_t ld = 3 * (size_t)F;
  const T* qb = qkv + (size_t)b * T_ * ld + h * D;
  const T* dob = dout + (size_t)b * T_ * F + h * D;
  const Warp w;

  tile::copy_rows<T, BM, D, C::LDT, THREADS>(qb, ld, m0, T_, sQ);
  tile::copy_rows<T, BM, D, C::LDT, THREADS>(dob, F, m0, T_, sdO);
  if (threadIdx.x < BM) {
    const int m = m0 + threadIdx.x;
    sLse[threadIdx.x] = m < T_ ? lse[(size_t)bh * T_ + m] : 0.f;
    sDelta[threadIdx.x] = m < T_ ? delta[(size_t)bh * T_ + m] : 0.f;
  }
  float dq[C::NTD][4];
  tile::zero(dq);
  const int n_end = causal ? min(T_, m0 + BM) : T_;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();
    tile::copy_rows<T, BN, D, C::LDT, THREADS>(qb + F, ld, n0, T_, sK);
    tile::copy_rows<T, BN, D, C::LDT, THREADS>(qb + 2 * F, ld, n0, T_, sV);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile::zero(s);
    tile::zero(dp);
    // S = Q K^T and dP = dO V^T: rows are queries, columns keys
    tile::warp_mma<T, 4, true>(s, sQ, C::LDT, sK, C::LDT, w.wm, w.wn * 32,
                               D);
    tile::warp_mma<T, 4, true>(dp, sdO, C::LDT, sV, C::LDT, w.wm,
                               w.wn * 32, D);
    softmax_grad<T, C::LDP, false>(s, dp, w, m0, n0, T_, causal, scale,
                                   sLse, sDelta, nullptr, sdS);
    __syncthreads();
    // dQ += dS K
    tile::warp_mma<T, C::NTD, false>(dq, sdS, C::LDP, sK, C::LDT, w.wm,
                                     w.wn * (D / 2), BN);
  }

  store_acc<T, C::NTD>(dq, w, dqkv + (size_t)b * T_ * ld + h * D, ld, m0,
                       T_, scale, D);
}

// -- launches --------------------------------------------------------------------
struct Args {
  const void* qkv;
  const void* out;
  const void* dout;
  const void* lse;
  void* res;    // forward: ctx; backward: dqkv
  void* stats;  // forward: lse out; backward: delta scratch
  int B, T, H, causal;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t run_fwd(const Args& a) {
  using C = Cfg<T, D>;
  cudaError_t err = allow_smem(qkv_fwd_kernel<T, D>, C::fwd_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.T + BM - 1) / BM);
  qkv_fwd_kernel<T, D><<<grid, THREADS, C::fwd_bytes, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<T*>(a.res),
      static_cast<float*>(a.stats), a.T, a.H, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_bwd(const Args& a) {
  using C = Cfg<T, D>;
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.stats);
  T* dqkv = static_cast<T*>(a.res);
  const int rows = a.B * a.T * a.H;
  const int per_block = THREADS / 32;
  qkv_delta_kernel<T, D>
      <<<(rows + per_block - 1) / per_block, THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.out), dout, delta, rows, a.T, a.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if ((err = allow_smem(qkv_dkv_kernel<T, D>, C::dkv_bytes)) != cudaSuccess)
    return err;
  const dim3 grid_k(a.B * a.H, (a.T + BN - 1) / BN);
  qkv_dkv_kernel<T, D><<<grid_k, THREADS, C::dkv_bytes, a.stream>>>(
      qkv, dout, lse, delta, dqkv, a.T, a.H, a.causal, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = allow_smem(qkv_dq_kernel<T, D>, C::dq_bytes)) != cudaSuccess)
    return err;
  const dim3 grid_q(a.B * a.H, (a.T + BM - 1) / BM);
  qkv_dq_kernel<T, D><<<grid_q, THREADS, C::dq_bytes, a.stream>>>(
      qkv, dout, lse, delta, dqkv, a.T, a.H, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t by_dim(int d, const Args& a) {
  switch (d) {
    case 32:
      return BWD ? run_bwd<T, 32>(a) : run_fwd<T, 32>(a);
    case 64:
      return BWD ? run_bwd<T, 64>(a) : run_fwd<T, 64>(a);
    case 128:
      return BWD ? run_bwd<T, 128>(a) : run_fwd<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool BWD>
int dispatch(int d, int dtype, const Args& a) {
  cudaGetLastError();  // launch errors below are this call's own
  if (a.B <= 0 || a.T <= 0 || a.H <= 0 || (a.T + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)by_dim<float, BWD>(d, a);
    case 1:
      return (int)by_dim<__nv_bfloat16, BWD>(d, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 = all
// kernels launched).  lse is (B, H, T) fp32; delta is (B, H, T) fp32
// scratch the backward fills itself; dqkv is written whole.
extern "C" int flash_qkv_fwd(const void* qkv, void* out, void* lse, int B,
                             int T, int H, int d, int dtype, int causal,
                             float scale, void* stream) {
  const Args a{qkv, nullptr, nullptr, nullptr, out, lse, B, T, H, causal,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(d, dtype, a);
}

extern "C" int flash_qkv_bwd(const void* qkv, const void* out,
                             const void* dout, const void* lse, void* delta,
                             void* dqkv, int B, int T, int H, int d,
                             int dtype, int causal, float scale,
                             void* stream) {
  const Args a{qkv, out, dout, lse, dqkv, delta, B, T, H, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(d, dtype, a);
}

extern "C" const char* flash_qkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
