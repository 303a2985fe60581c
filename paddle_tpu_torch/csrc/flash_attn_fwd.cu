// Flash-attention forward over strided (B, S, H, D) operands, for Hopper
// (sm_90a).
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py,
// each of which computes out = softmax(q k^T * scale) v per (batch, head):
//   _small_fwd_kernel      row 1: launched by _small_flash_fwd and, for
//                          1024 < T <= 4096, by _mid_flash_fwd; no lse
//   _fwd_kernel_pipelined  row 2: launched by _flash_fwd for T > 4096;
//                          writes lse
//   _qkv_fwd_kernel        row 3: launched by _qkv_small_fwd, straight
//                          from the packed (B, T, 3F) projection
// One kernel serves all three: it streams K/V for any Tk and writes the
// fp32 log-sum-exp lse (B, H, Tq) when asked (the backward's residual).
//
// Operands: q is (B, Tq, H, D), k and v are (B, Tk, H, D) and out is
// (B, Tq, H, D), each addressed by its own element strides (batch, row,
// head) with a contiguous last axis, so head-split views of a fused
// projection, the packed projection itself and folded (B*H, T, D)
// tensors are read where they lie, with no copy.  Head dims D in {16, 32,
// 64, 80, 96, 128}: fp32 at all of them, bf16 and fp16 at 16, 32, 80 and
// 96 (both at D 64 and 128 run flash_attn_sm90.cu).  Causal masking is
// bottom-right aligned as in the reference: query i sees key j iff
// j <= i + (Tk - Tq); causal with Tq > Tk (fully masked rows) is refused.
// Any Tq and Tk: the ragged edge is masked here, where the TPU kernels
// needed multiples of 128.  Softmax statistics are fp32, masked scores
// take the finite NEG_INF = -1e30, and p is cast to v's type before the
// P V product, as in the reference.  The scale multiplies the fp32 scores
// (never a 16-bit operand), so fp16 inputs whose products pass fp16's
// range (65504) give what the plain version's fp32 scores give.
//
// What bounds it on an H100: per (batch, head) the causal forward does
// 2*Tq*Tk*D flops on 2*(Tq + Tk)*D elements.  bf16 and fp16 run on mma.sync
// m16n8k16 (~295 flops per byte of device memory at the tensor cores'
// rate): bound by the bytes up to T ~ 512 at D = 64 and by the arithmetic
// above.  fp32 runs on the tensor cores in split precision (3xTF32,
// tile_common.cuh): three tf32 products per fp32 product at 495 TFLOP/s,
// an effective 165 TFLOP/s, so it is bound by the arithmetic past T ~ 100;
// the split costs two ALU operations per operand value read, and the
// parity with the fp32 reference stays within its 2e-5.  K/V tiles are
// re-read once per 64-row query tile, mostly from L2.
//
// Design: one 256-thread block per (b, h, 64 query rows), the tiles of
// the heaviest causal rows launched first (their blocks take the lowest
// indices), so the short diagonal tiles fill the tail.  64-row K/V tiles
// stream through a shared-memory ring on cp.async, two stages (the next
// tile loads while the current one is multiplied) where the registers,
// not the ring, set the blocks per SM (ring_stages below); tiles wholly
// above the causal diagonal are never loaded.  S goes through shared
// memory to the online softmax (four threads a query row), which keeps
// its running max and sum in fp32 and writes P in place of S (fp32) or
// beside it (bf16); the output accumulators (registers) are rescaled per
// tile.

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

// Depth of the K/V ring: two stages unless the second stage's shared
// memory (228 KB an SM, 1 KB reserved a block) leaves fewer blocks on an
// SM than min(2, one stage's).  In fp32, ptxas gives these kernels
// 101-163 registers a thread, so the registers allow at most two blocks
// of eight warps whatever the shared memory.  Measured on the card
// (PERF.md, tools/kernel_ab.py), fp32, against one stage: two stages
// gain 1-4% at d 16 and 64, where two blocks still fit, and 10-25% at
// d 128, where one fits either way; they lose ~20% at d 80 and 96, where
// they leave one block instead of two, so those keep one stage.  bf16
// (d 16, 32, 80, 96) measured level with one stage.
constexpr int blocks_per_sm(size_t bytes) {
  return static_cast<int>((228 * 1024) / (bytes + 1024));
}
constexpr int ring_stages(size_t one_stage, size_t two_stages) {
  const int keep = blocks_per_sm(one_stage) < 2 ? blocks_per_sm(one_stage) : 2;
  return two_stages <= tile::SMEM_PER_BLOCK &&
                 blocks_per_sm(two_stages) >= keep
             ? 2
             : 1;
}

template <typename T, int D>
struct Cfg {
  static constexpr int LDT = D + tile::pad<T>();  // q, k, v tiles
  static constexpr int LDP = BN + 8;  // P tile (fp32: 8 mod 32 words)
  // fp32 writes P over S (each thread rewrites the scores it read); bf16
  // keeps an fp32 score tile beside its bf16 P tile
  static constexpr bool P_OVER_S = sizeof(T) == 4;
  static constexpr int LDS = P_OVER_S ? LDP : BN + 4;  // fp32 score tile
  static constexpr int NTD = D / 16;  // 8-column blocks per warp over D
  static constexpr size_t TILE = sizeof(T) * (size_t)64 * LDT;
  // Q, the score and P tiles and the row statistics; then the K/V ring
  static constexpr size_t FIXED =
      TILE + sizeof(float) * (size_t)BM * LDS +
      (P_OVER_S ? 0 : sizeof(T) * (size_t)BM * LDP) + sizeof(float) * 2 * BM;
  static constexpr int STAGES =
      ring_stages(FIXED + 2 * TILE, FIXED + 4 * TILE);
  static constexpr size_t bytes = FIXED + 2 * STAGES * TILE;
  static_assert(D % 16 == 0 && bytes <= tile::SMEM_PER_BLOCK,
                "head dim not built");
};

template <typename T>
struct FwdArgs {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;  // (B, H, Tq) or null
  Strides sq, sk, sv, so;
  int H, tq, tk, causal;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const FwdArgs<T> a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + BM * C::LDT;  // stage s: K at 2s, V at 2s + 1
  float* sS = reinterpret_cast<float*>(sKV + 2 * C::STAGES * BN * C::LDT);
  T* sP = C::P_OVER_S ? reinterpret_cast<T*>(sS)
                      : reinterpret_cast<T*>(sS + BM * C::LDS);
  float* sCorr = C::P_OVER_S
                     ? sS + BM * C::LDS
                     : reinterpret_cast<float*>(sP + BM * C::LDP);
  float* sL = sCorr + BM;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // heaviest causal tiles first: block row 0 takes the last query tile
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = a.tk - a.tq;
  const T* qb = a.sq.head(a.q, b, h);
  const T* kb = a.sk.head(a.k, b, h);
  const T* vb = a.sv.head(a.v, b, h);
  const Warp w;
  const int row = threadIdx.x >> 2;  // softmax: four lanes per query row
  const int sub = threadIdx.x & 3;
  const int qi = m0 + row;
  auto load_kv = [&](int stage, int n0) {
    T* dst = sKV + 2 * stage * BN * C::LDT;
    tile::copy_rows_async<T, BN, D, C::LDT, THREADS>(kb, a.sk.s_, n0, a.tk,
                                                     dst);
    tile::copy_rows_async<T, BN, D, C::LDT, THREADS>(vb, a.sv.s_, n0, a.tk,
                                                     dst + BN * C::LDT);
    tile::cp_async_commit();
  };

  tile::copy_rows_async<T, BM, D, C::LDT, THREADS>(qb, a.sq.s_, m0, a.tq,
                                                   sQ);
  load_kv(0, 0);  // one group: Q and the first K/V tile
  float m_i = NEG_INF, l_i = 0.f;
  float o[C::NTD][4];
  tile::zero(o);
  // keys past the tile's last live query row are masked for every row;
  // key 0 is visible to every row, so the first tile sets a finite max
  const int n_end =
      a.causal ? min(a.tk, min(m0 + BM, a.tq) + offset) : a.tk;

  for (int n0 = 0, it = 0; n0 < n_end; n0 += BN, ++it) {
    const int stage = it % C::STAGES;
    if (C::STAGES == 1 && it > 0) {
      __syncthreads();  // every warp is done with the previous tile
      load_kv(0, n0);
    }
    tile::cp_async_wait<0>();
    // this tile is visible to all, and every warp is done with the
    // previous one (its stage, sS and sP are free)
    __syncthreads();
    if (C::STAGES == 2 && n0 + BN < n_end) load_kv(stage ^ 1, n0 + BN);
    const T* sK = sKV + 2 * stage * BN * C::LDT;
    const T* sV = sK + BN * C::LDT;

    float s[4][4];
    tile::zero(s);
    tile::attn_mma<T, 4, true>(s, sQ, C::LDT, sK, C::LDT, w.wm, w.wn * 32,
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
      float v = sS[row * C::LDS + sub + 4 * i] * a.scale;
      if (j >= a.tk || (a.causal && j > qi + offset)) v = NEG_INF;
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
      // keys past Tk do not exist: their weight is exactly 0
      const float p = (n0 + sub + 4 * i < a.tk) ? expf(x[i] - m_new) : 0.f;
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
    tile::attn_mma<T, C::NTD, false>(o, sP, C::LDP, sV, C::LDT, w.wm,
                                     w.wn * (D / 2), BN);
  }

  if (sub == 0) {
    sL[row] = l_i;
    if (a.lse != nullptr && qi < a.tq)
      a.lse[(size_t)bh * a.tq + qi] = m_i + logf(l_i);
  }
  __syncthreads();
  T* ob = a.so.head(a.o, b, h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w.wm + w.g + 8 * half;
    if (m0 + r >= a.tq) continue;
    const float inv = 1.f / sL[r];
#pragma unroll
    for (int j = 0; j < C::NTD; ++j) {
      const int col = w.wn * (D / 2) + 8 * j + 2 * w.t;
      tile::store_pair(ob + (size_t)(m0 + r) * a.so.s_ + col,
                       o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  using C = Cfg<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.tq + BM - 1) / BM);
  flash_fwd_kernel<T, D><<<grid, THREADS, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                void* lse, const long long* st, int B, int H, int tq, int tk,
                int d, int causal, float scale, cudaStream_t stream) {
  const FwdArgs<T> a{static_cast<const T*>(q),
                     static_cast<const T*>(k),
                     static_cast<const T*>(v),
                     static_cast<T*>(o),
                     static_cast<float*>(lse),
                     {st[0], st[1], st[2]},
                     {st[3], st[4], st[5]},
                     {st[6], st[7], st[8]},
                     {st[9], st[10], st[11]},
                     H,
                     tq,
                     tk,
                     causal,
                     scale};
  switch (d) {
    case 16:
      return launch<T, 16>(a, B, stream);
    case 32:
      return launch<T, 32>(a, B, stream);
    case 80:
      return launch<T, 80>(a, B, stream);
    case 96:
      return launch<T, 96>(a, B, stream);
  }
  // bf16 and fp16 at d 64 / 128 run flash_attn_sm90.cu; fp32 runs here
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 64:
        return launch<T, 64>(a, B, stream);
      case 128:
        return launch<T, 128>(a, B, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (batch, row, head) of q, k, v and out in
// that order.  lse: (B, H, Tq) fp32, or null for no lse.  dtype: 0 =
// float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t (0 =
// launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* strides,
                              int B, int H, int tq, int tk, int d, int dtype,
                              int causal, float scale, void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0 || (causal && tq > tk) ||
      (long long)B * H > 0x7fffffffLL || (tq + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)run<float>(q, k, v, o, lse, strides, B, H, tq, tk, d,
                             causal, scale, s);
    case 1:
      return (int)run<__nv_bfloat16>(q, k, v, o, lse, strides, B, H, tq, tk,
                                     d, causal, scale, s);
    case 2:
      return (int)run<__half>(q, k, v, o, lse, strides, B, H, tq, tk, d,
                              causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
