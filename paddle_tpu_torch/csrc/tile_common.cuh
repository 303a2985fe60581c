// Shared device code of the hand-written Hopper kernels in this directory.
//
// - strided tile copies that keep the input type (`copy_tile`, and
//   `copy_rows_async` on cp.async), used by every kernel here;
// - the addressing of a (B, S, H, D) attention operand by element strides
//   (`Strides`) and a warp's place in a 64-row tile (`Warp`), used by
//   flash_attn_fwd.cu and flash_attn_bwd.cu;
// - warp-level 16 x (8*NT) products over operands in shared memory, all
//   with fp32 accumulators in one layout:
//   `warp_mma` (the LM-head kernels): bf16 and fp16 on the tensor cores
//   (ldmatrix and mma.sync m16n8k16, the instruction's type from the
//   operands'), fp32 on FMAs;
//   `attn_mma` (the attention kernels): bf16 and fp16 as `warp_mma`, fp32
//   on the tensor cores in split precision (3xTF32, mma.sync m16n8k8),
//   which keeps fp32 accuracy (see `WarpMma3xTf32`).
//
// Accumulator layout (the mma.sync m16n8k16 and m16n8k8 C fragment): in a
// warp, lane (g = lane / 4, t = lane % 4) owns, for each 8-column block j,
// the four elements c[j][0..3] at (row g, col 8j + 2t), (g, 8j + 2t + 1),
// (g + 8, 8j + 2t) and (g + 8, 8j + 2t + 1) of its 16-row tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

constexpr float NEG_INF = -1e30f;

// ---- conversions ---------------------------------------------------------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
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
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Two neighbouring columns (col, col + 1) of one row, stored as T.
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* dst, float a, float b) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(a, b);
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

// Tiles whose columns are all live and whose rows are 16-byte aligned
// (attention operands: COLS is the head dim) move on cp.async (16 bytes a
// thread, L2 only): `copy_rows_async` issues the copies of rows [row0,
// row0 + ROWS) and does not wait; rows past `nrows` are zero-filled.  The
// caller commits the group (`cp_async_commit`) and waits for it
// (`cp_async_wait`) before a __syncthreads that makes the tile visible.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int ROWS, int COLS, int LDS, int THREADS>
__device__ void copy_rows_async(const T* __restrict__ src, size_t ld,
                                int row0, int nrows, T* dst) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VN;
  static_assert(COLS % VN == 0, "rows move in 16-byte chunks");
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VN;
    const bool live = row0 + r < nrows;
    // a dead row reads nothing (src-size 0) from a valid address
    cp_async16(dst + r * LDS + c,
               live ? src + (size_t)(row0 + r) * ld + c : src, live);
  }
}

// ---- warp-level products ----------------------------------------------------------
// c[j][*] += A(m0 + 0..15, k) * B(k, n0 + 8j + 0..7) summed over k < K.
// A is row-major in shared memory: A(m, k) = A[m * lda + k].  B(k, n) is
// B[k * ldb + n], or B[n * ldb + k] when BT (a matrix used transposed,
// such as K in Q K^T).  K is a multiple of 16.
template <typename T, int NT, bool BT>
struct WarpMma;

// c += a b on m16n8k16 with fp32 accumulators; T names the operands'
// 16-bit type (bf16 or fp16), whose fragments are laid out alike
template <typename T>
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// 16-bit operands (bf16 or fp16) come in by ldmatrix: one x4 load gives
// the A fragment of a 16 x 16 step, one more the B fragments of two
// 8-column blocks (.trans when B is stored [k][n]), and an x2 load the
// last block when NT is odd.  Row strides and column offsets are multiples
// of 8 elements, so every row address is 16-byte aligned.
template <typename T, int NT, bool BT>
struct WarpMma16 {
  __device__ static void run(float (&c)[NT][4], const T* A, int lda,
                             const T* B, int ldb, int m0, int n0, int K) {
    const int lane = threadIdx.x & 31;
    const int r8 = lane & 7, hi8 = (lane >> 3) & 1, hi16 = lane >> 4;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, A + (m0 + (lane & 15)) * lda + k0 + hi16 * 8);
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {
        uint32_t b[4];
        if (BT)   // B(k, n) = B[n * ldb + k]
          ldsm_x4(b, B + (n0 + 8 * j + r8 + hi16 * 8) * ldb + k0 + hi8 * 8);
        else      // B(k, n) = B[k * ldb + n]
          ldsm_x4_trans(b,
                        B + (k0 + r8 + hi8 * 8) * ldb + n0 + 8 * j + hi16 * 8);
        mma_16816<T>(c[j], a, b);
        mma_16816<T>(c[j + 1], a, b + 2);
      }
      if constexpr (NT % 2 == 1) {  // lanes 0..15 address the two halves
        uint32_t b[2];
        if (BT)
          ldsm_x2(b, B + (n0 + 8 * (NT - 1) + r8) * ldb + k0 + hi8 * 8);
        else
          ldsm_x2_trans(b, B + (k0 + r8 + hi8 * 8) * ldb + n0 + 8 * (NT - 1));
        mma_16816<T>(c[NT - 1], a, b);
      }
    }
  }
};
template <int NT, bool BT>
struct WarpMma<__nv_bfloat16, NT, BT> : WarpMma16<__nv_bfloat16, NT, BT> {};
template <int NT, bool BT>
struct WarpMma<__half, NT, BT> : WarpMma16<__half, NT, BT> {};

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

// ---- fp32 on the tensor cores in split precision (3xTF32) ------------------
// Each fp32 operand x is split into two tf32 values, big = rna(x) and
// small = x - big (exact), which the tensor cores read as tf32 by dropping
// its low 13 bits, so x = big + small to about 2^-21 |x| (rounding small
// as well measured no more accurate on the card and cost 8% of the time).
// A product accumulates small*big and big*small first, then big*big, on
// mma.sync m16n8k8 (tf32 in, fp32 accumulators); the dropped small*small
// term is below 2^-22 |a||b|.  One pass of tf32 alone keeps
// about three decimal digits, which the fp32 tolerances of the attention
// kernels do not allow.  The tensor cores' accumulation truncates where
// an fp32 add rounds, so over sums of positive terms it drifts one way
// (measured on the card: a dV summed over 512 queries inside the
// accumulators drifted ~100 ulps).  So partial sums leave the tensor
// cores through fp32 adds into `c`: per call for the products over keys
// or queries, which the kernels sum over many tiles in `c`; per k-step of
// 8 for the products over the head dim (BT: S and dP), which go straight
// into exp() and the lse, where a drift of the score shows.
//
// Fragments of m16n8k8 (lane g = lane / 4, t = lane % 4): A a0..a3 at
// (g, s), (g + 8, s), (g, s'), (g + 8, s'), B b0, b1 at (k = s, n = g),
// (k = s', n = g), C as above.  The sum over k is taken in any order, so
// the k held by the slots s = t, s' = t + 4 is chosen per product for
// conflict-free shared-memory reads:
// - BT (B(k, n) = B[n * ldb + k], a product over the head dim such as
//   Q K^T): s = k0 + t, s' = k0 + t + 4.  ldmatrix reads 32-bit values
//   too: an 8 x 8 b16 matrix is 8 rows of 4 fp32, and lane (g, t)
//   receives element (g, t), so one x4 load gives the A fragment and one
//   more the B fragments of two 8-column blocks; conflict-free when lda
//   and ldb are 4 mod 8 words (D + 4) and rows are 16-byte aligned;
// - not BT (B(k, n) = B[k * ldb + n], a product over keys or queries such
//   as P V): s = k0 + 2t, s' = k0 + 2t + 1, so a lane reads (s, s') of A
//   as one float2 (conflict-free when lda is 8 mod 32 words: P and dS
//   tiles, BN + 8) and B one value at a time (conflict-free when ldb is
//   4 mod 8 words).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}
// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_1688_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
__device__ __forceinline__ void mma_1688(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

template <int NT>
__device__ __forceinline__ void add(float (&c)[NT][4],
                                    const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += x[j][e];
}

template <int NT, bool BT>
struct WarpMma3xTf32 {
  __device__ static void run(float (&c)[NT][4], const float* A, int lda,
                             const float* B, int ldb, int m0, int n0,
                             int K) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* a_lo = A + (m0 + g) * lda;
    const float* a_hi = a_lo + 8 * lda;
    float acc[NT][4];  // the partial sum: per call, or per k-step when BT
    if constexpr (!BT) zero(acc);
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      float x[4];
      if (BT) {  // matrices (rows 0-7 | 8-15) x (k0..k0+3 | k0+4..k0+7)
        uint32_t r[4];
        ldsm_x4(r, A + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * lda + k0 +
                       (lane >> 4) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]);
      } else {
        const float2 lo = *reinterpret_cast<const float2*>(a_lo + k0 + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(a_hi + k0 + 2 * t);
        x[0] = lo.x;
        x[1] = hi.x;
        x[2] = lo.y;
        x[3] = hi.y;
      }
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], ab[i], as[i]);
      float y[NT][2];
      if (BT) {  // matrices (rows n of blocks j, j + 1) x (k0.. | k0+4..)
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, B + (n0 + 8 * j + (lane & 7) + (lane >> 4) * 8) * ldb +
                         k0 + ((lane >> 3) & 1) * 4);
          y[j][0] = __uint_as_float(r[0]);
          y[j][1] = __uint_as_float(r[1]);
          y[j + 1][0] = __uint_as_float(r[2]);
          y[j + 1][1] = __uint_as_float(r[3]);
        }
        if constexpr (NT % 2 == 1) {
          uint32_t r[2];
          ldsm_x2(r, B + (n0 + 8 * (NT - 1) + (lane & 7)) * ldb + k0 +
                         ((lane >> 3) & 1) * 4);
          y[NT - 1][0] = __uint_as_float(r[0]);
          y[NT - 1][1] = __uint_as_float(r[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + 8 * j + g;
          y[j][0] = B[(k0 + 2 * t) * ldb + n];
          y[j][1] = B[(k0 + 2 * t + 1) * ldb + n];
        }
      }
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(y[j][0], bb[j][0], bs[j][0]);
        split_tf32(y[j][1], bb[j][1], bs[j][1]);
      }
      // one pass over the blocks per partial product, so neighbouring
      // mma instructions do not wait for each other's accumulators
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (BT)
          mma_1688_zero(acc[j], as, bb[j]);
        else
          mma_1688(acc[j], as, bb[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_1688(acc[j], ab, bs[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_1688(acc[j], ab, bb[j]);
      if constexpr (BT) add(c, acc);
    }
    if constexpr (!BT) add(c, acc);
  }
};

template <typename T, int NT, bool BT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const T* A,
                                         int lda, const T* B, int ldb, int m0,
                                         int n0, int K) {
  WarpMma<T, NT, BT>::run(c, A, lda, B, ldb, m0, n0, K);
}

// The attention kernels' product: bf16 and fp16 as warp_mma, fp32 in
// 3xTF32.  K is a multiple of 16 (16-bit types) or 8 (fp32).
template <typename T, int NT, bool BT>
__device__ __forceinline__ void attn_mma(float (&c)[NT][4], const T* A,
                                         int lda, const T* B, int ldb, int m0,
                                         int n0, int K) {
  if constexpr (sizeof(T) == 4)
    WarpMma3xTf32<NT, BT>::run(c, A, lda, B, ldb, m0, n0, K);
  else
    WarpMma<T, NT, BT>::run(c, A, lda, B, ldb, m0, n0, K);
}

// Dynamic shared memory one block may opt into on sm_90.
constexpr size_t SMEM_PER_BLOCK = 227 * 1024;

// Shared-memory row padding that keeps 16-byte row alignment and spreads a
// warp's reads over the banks: 8 elements for bf16 and fp16, 4 for fp32
// (operand tiles of D + 4 words, 4 mod 8, for the 3xTF32 reads above).
template <typename T>
constexpr int pad() {
  return sizeof(T) == 2 ? 8 : 4;
}

}  // namespace tile
