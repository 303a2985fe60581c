// Flash-attention forward, split layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_small_fwd_kernel` of
// paddle_tpu/ops/pallas/flash_attention.py (launched there by
// `_small_flash_fwd` and, for 1024 < T <= 4096, by `_mid_flash_fwd`):
//
//   out[bh] = softmax(q[bh] k[bh]^T * scale) v[bh]       (no lse output)
//
// q is (BH, Tq, d), k and v are (BH, Tk, d), all contiguous, fp32 or bf16;
// the output has the input's type.  Softmax statistics and both products
// accumulate in fp32.  Causal masking is bottom-right aligned, as in the
// reference: key j is visible to query i iff j <= i + (Tk - Tq), and a
// masked score takes the finite NEG_INF = -1e30.  Causal with Tq > Tk is
// refused.  Any Tq and Tk are taken: the ragged edges are masked here,
// where the TPU kernel needed multiples of 128.
//
// What bounds it on an H100: one head does 4*Tq*Tk*d flops (half of that
// when causal) on (2*Tq + 2*Tk)*d elements, so past T ~ 64 at d = 64 the
// work is bound by arithmetic, not by memory.  This first version does
// both products with fp32 FMAs out of shared memory, not on the tensor
// cores, so it runs well below the card's peak; wgmma, TMA and warp
// specialisation are later work.
//
// Design: one block of 256 threads per (bh, tile of 64 query rows); four
// neighbouring lanes own one query row.  K and V tiles of 64 rows are
// staged through shared memory (converted to fp32, rows padded so the
// float4 reads of one warp hit distinct banks), the online softmax
// (running max m and denominator l) stays in fp32 registers, and K/V
// tiles wholly above the causal diagonal are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // key rows per shared-memory tile
constexpr int THREADS = 256;  // four threads per query row
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int LD = D + 4;         // row stride of sQ/sK/sV (floats)
  static constexpr int PLD = BLOCK_N + 4;  // row stride of sP (floats)
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(3 * BLOCK_M * LD + BLOCK_M * PLD);
};

// 16-byte global loads and stores, converted to and from fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
  __device__ static void store4(float* dst, float4 x) {
    *reinterpret_cast<float4*>(dst) = x;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* dst, float4 x) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
};

// Rows [row0, row0 + 64) of a (nrows, D) matrix into shared memory as fp32;
// rows past nrows are zero so that 0-weighted products stay finite.
template <typename T, int D>
__device__ void load_tile(const T* __restrict__ src, int row0, int nrows,
                          float* dst) {
  constexpr int VN = Vec<T>::N;
  constexpr int PER_ROW = D / VN;
  for (int idx = threadIdx.x; idx < BLOCK_N * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VN;
    float* d = dst + r * Layout<D>::LD + c;
    if (row0 + r < nrows) {
      Vec<T>::load(src + (size_t)(row0 + r) * D + c, d);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) d[i] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
                 int causal, float scale) {
  constexpr int LD = Layout<D>::LD;
  constexpr int PLD = Layout<D>::PLD;
  constexpr int NS = BLOCK_N / 4;  // scores per thread per tile
  constexpr int NG = D / 16;       // float4 output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BLOCK_M * LD;
  float* sV = sK + BLOCK_N * LD;
  float* sP = sV + BLOCK_N * LD;

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * BLOCK_M;
  const int row = threadIdx.x >> 2;  // query row within the tile
  const int sub = threadIdx.x & 3;   // which quarter of the row's work
  const int offset = tk - tq;
  const int last_key = m0 + row + offset;  // causal: last visible key
  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_tile<T, D>(qb, m0, tq, sQ);

  // keys past the block's last live query row are masked for every row
  int n_end = tk;
  if (causal) n_end = min(tk, min(m0 + BLOCK_M, tq) + offset);

  float m_i = NEG_INF;
  float l_i = 0.f;
  float acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();  // the previous tile's sK/sV are no longer read
    load_tile<T, D>(kb, n0, tk, sK);
    load_tile<T, D>(vb, n0, tk, sV);
    __syncthreads();

    // scores of this row against keys n0 + 4*i + sub
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    const float* qrow = sQ + row * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sK + (4 * i + sub) * LD + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float tile_max = NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int j = n0 + 4 * i + sub;
      float x = s[i] * scale;
      if (j >= tk || (causal && j > last_key)) x = NEG_INF;
      s[i] = x;
      tile_max = fmaxf(tile_max, x);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float corr = expf(m_i - m_new);

    float row_sum = 0.f;
    float* prow = sP + row * PLD;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      // keys past tk do not exist: their weight is exactly 0
      const float p = (n0 + 4 * i + sub < tk) ? expf(s[i] - m_new) : 0.f;
      row_sum += p;
      prow[4 * i + sub] = p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l_i = l_i * corr + row_sum;
    m_i = m_new;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[g][0] *= corr;
      acc[g][1] *= corr;
      acc[g][2] *= corr;
      acc[g][3] *= corr;
    }
    __syncwarp();  // the row's four lanes wrote prow; all four read it

    const int jn = min(BLOCK_N, tk - n0);
    for (int j = 0; j < jn; ++j) {
      const float p = prow[j];
      const float* vrow = sV + j * LD;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vrow + 4 * (sub + 4 * g));
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        acc[g][2] = fmaf(p, vv.z, acc[g][2]);
        acc[g][3] = fmaf(p, vv.w, acc[g][3]);
      }
    }
  }

  const int gr = m0 + row;
  if (gr < tq) {
    T* orow = o + ((size_t)bh * tq + gr) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 x = make_float4(acc[g][0] / l_i, acc[g][1] / l_i,
                                   acc[g][2] / l_i, acc[g][3] / l_i);
      Vec<T>::store4(orow + 4 * (sub + 4 * g), x);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int tq, int tk, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int bh, int tq, int tk, int d, int causal, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, tq, tk, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, tq, tk, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, tq, tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int bh, int tq, int tk, int d,
                              int dtype, int causal, float scale,
                              void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (bh <= 0 || tq <= 0 || tk <= 0 || (causal && tq > tk) ||
      (tq + BLOCK_M - 1) / BLOCK_M > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(q, k, v, o, bh, tq, tk, d, causal, scale,
                                    s);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d,
                                            causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
