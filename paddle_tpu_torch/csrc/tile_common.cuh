// Shared device code of the hand-written Hopper kernels in this directory.
//
// - strided tile copies that keep the input type (`copy_tile`,
//   `copy_rows`), used by every kernel here;
// - the addressing of a (B, S, H, D) attention operand by element strides
//   (`Strides`) and a warp's place in a 64-row tile (`Warp`), used by
//   flash_attn_fwd.cu and flash_attn_bwd.cu;
// - a warp-level 16 x (8*NT) product `warp_mma` over operands in shared
//   memory.  bf16 runs on the tensor cores (ldmatrix and mma.sync
//   m16n8k16, fp32 accumulators); fp32 runs on FMAs with the same
//   ownership of the accumulators, so the kernels around it are written
//   once for both types.
//
// Accumulator layout (the mma.sync m16n8k16 C fragment): in a warp, lane
// (g = lane / 4, t = lane % 4) owns, for each 8-column block j, the four
// elements c[j][0..3] at (row g, col 8j + 2t), (g, 8j + 2t + 1),
// (g + 8, 8j + 2t) and (g + 8, 8j + 2t + 1) of its 16-row tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr float NEG_INF = -1e30f;

// ---- conversions ---------------------------------------------------------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two neighbouring columns (col, col + 1) of one row, stored as T.
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// ---- attention operands ----------------------------------------------------
// A (B, S, H, D) operand whose last axis is contiguous: element (b, s, h, 0)
// is at base + b*b_ + s*s_ + h*h_.  A packed (B, T, 3F) projection, a
// head-split view of it, a folded (B*H, T, D) tensor (H = 1) and a plain
// contiguous (B, S, H, D) tensor are all such operands.
struct Strides {
  long long b_, s_, h_;
  template <typename T>
  __device__ T* head(T* base, int b, int h) const {
    return base + b * b_ + h * h_;
  }
};

// A warp's place in a 64-row tile worked by eight warps: rows wm..wm+15
// and column half wn; lane (g, t) as in the accumulator layout above.
struct Warp {
  int g, t, wm, wn;
  __device__ Warp() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    wm = (warp & 3) * 16;
    wn = warp >> 2;
  }
};

// ---- tile copies in the input type ------------------------------------------
// Rows [row0, row0 + ROWS) x columns [col0, col0 + COLS) of a row-major
// matrix (row stride `ld` elements, nrows x ncols live) into shared memory
// (row stride LDS); everything outside the live region is zero.  `vec`
// says that `ld`, `col0` and the base are 16-byte multiples, so whole
// 16-byte chunks inside the live columns move in one load.
template <typename T, int ROWS, int COLS, int LDS, int THREADS>
__device__ void copy_tile(const T* __restrict__ src, size_t ld, int row0,
                          int nrows, int col0, int ncols, bool vec, T* dst) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VN;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VN;
    T* d = dst + r * LDS + c;
    const int gr = row0 + r;
    const int gc = col0 + c;
    if (gr < nrows && vec && gc + VN <= ncols) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i)
        d[i] = (gr < nrows && gc + i < ncols) ? src[(size_t)gr * ld + gc + i]
                                              : from_f32<T>(0.f);
    }
  }
}

// The same for a tile whose columns are all live and whose rows are
// 16-byte aligned (attention operands: COLS is the head dim).
template <typename T, int ROWS, int COLS, int LDS, int THREADS>
__device__ void copy_rows(const T* __restrict__ src, size_t ld, int row0,
                          int nrows, T* dst) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VN;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VN;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = v;
  }
}

// ---- warp-level products ----------------------------------------------------------
// c[j][*] += A(m0 + 0..15, k) * B(k, n0 + 8j + 0..7) summed over k < K.
// A is row-major in shared memory: A(m, k) = A[m * lda + k].  B(k, n) is
// B[k * ldb + n], or B[n * ldb + k] when BT (a matrix used transposed,
// such as K in Q K^T).  K is a multiple of 16.
template <typename T, int NT, bool BT>
struct WarpMma;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives in r[i] the pair at (row l/4,
// cols 2(l%4), 2(l%4)+1) of matrix i, or of its transpose with .trans.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// bf16 operands come in by ldmatrix: one x4 load gives the A fragment of a
// 16 x 16 step, one more the B fragments of two 8-column blocks (.trans
// when B is stored [k][n]).  Row strides and column offsets are multiples
// of 8 elements, so every row address is 16-byte aligned.  NT is even.
template <int NT, bool BT>
struct WarpMma<__nv_bfloat16, NT, BT> {
  using T = __nv_bfloat16;
  __device__ static void run(float (&c)[NT][4], const T* A, int lda,
                             const T* B, int ldb, int m0, int n0, int K) {
    static_assert(NT % 2 == 0, "B fragments load two 8-column blocks");
    const int lane = threadIdx.x & 31;
    const int r8 = lane & 7, hi8 = (lane >> 3) & 1, hi16 = lane >> 4;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, A + (m0 + (lane & 15)) * lda + k0 + hi16 * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        if (BT)   // B(k, n) = B[n * ldb + k]
          ldsm_x4(b, B + (n0 + 8 * j + r8 + hi16 * 8) * ldb + k0 + hi8 * 8);
        else      // B(k, n) = B[k * ldb + n]
          ldsm_x4_trans(b,
                        B + (k0 + r8 + hi8 * 8) * ldb + n0 + 8 * j + hi16 * 8);
        mma_16816(c[j], a, b);
        mma_16816(c[j + 1], a, b + 2);
      }
    }
  }
};

template <int NT, bool BT>
struct WarpMma<float, NT, BT> {
  __device__ static float b_at(const float* B, int ldb, int k, int n) {
    return BT ? B[n * ldb + k] : B[k * ldb + n];
  }
  __device__ static void run(float (&c)[NT][4], const float* A, int lda,
                             const float* B, int ldb, int m0, int n0,
                             int K) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* a_lo = A + (m0 + g) * lda;
    const float* a_hi = A + (m0 + g + 8) * lda;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x0 = a_lo[k], x1 = a_hi[k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        const float y0 = b_at(B, ldb, k, n), y1 = b_at(B, ldb, k, n + 1);
        c[j][0] = fmaf(x0, y0, c[j][0]);
        c[j][1] = fmaf(x0, y1, c[j][1]);
        c[j][2] = fmaf(x1, y0, c[j][2]);
        c[j][3] = fmaf(x1, y1, c[j][3]);
      }
    }
  }
};

template <typename T, int NT, bool BT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const T* A,
                                         int lda, const T* B, int ldb, int m0,
                                         int n0, int K) {
  WarpMma<T, NT, BT>::run(c, A, lda, B, ldb, m0, n0, K);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Shared-memory row padding that keeps 16-byte row alignment and spreads a
// warp's reads over the banks: 8 elements for bf16, 4 for fp32.
template <typename T>
constexpr int pad() {
  return sizeof(T) == 2 ? 8 : 4;
}

}  // namespace tile
