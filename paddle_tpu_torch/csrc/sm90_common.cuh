// Hopper (sm_90a) building blocks for the hand-written kernels in this
// directory, in inline PTX:
//
// - mbarriers (`mbar_*`): init, arrive, arrive with an expected byte count,
//   and a parity wait that traps after ~10 s instead of hanging the card;
// - TMA (`tma_load_4d`, `tma_load_2d`): one thread asks for a whole box of
//   a 4-D or 2-D tensor map to be copied into shared memory, completing on
//   an mbarrier; `tma_store_2d` copies a box back to device memory in a
//   bulk group (`bulk_commit`, `bulk_wait_read`), after the writing
//   threads' `fence_async_smem`;
// - wgmma (`wgmma_ss`, `wgmma_ss_mn`, `wgmma_rs`): a warpgroup's
//   asynchronous 64 x N x 16 product of bf16 or fp16 operands (the type a
//   template parameter, the instruction picked at compile time) with fp32
//   accumulators, A from shared memory (SS) or from registers (RS), B from
//   shared memory, K-major (`wgmma_ss`) or MN-major (`wgmma_ss_mn`,
//   `wgmma_rs`), and the fence / commit / wait that order them;
// - named barriers (`named_sync`) for a subset of the block's warps;
// - the shared-memory matrix descriptor of a tile that TMA wrote with the
//   128-byte swizzle (`desc_sw128`);
// - `setmaxnreg` (register hand-over between warpgroups);
// - the host side of TMA: `cuTensorMapEncodeTiled`, a driver-API call,
//   reached through dlopen of the driver so the library links against the
//   runtime alone, the 4-D (D, H, S, B) attention operand map
//   (`encode_operand`) and a 2-D map of a row-major matrix
//   (`encode_matrix`), each in the TMA data type it is given (`tma_type`).
//
// Tile layout that every kernel here shares: an operand tile of R rows
// and D columns (bf16 or fp16, 2 bytes an element) lives in D / 64
// "halves" of R x 64 elements, each half R rows of 128 bytes, 1024-byte
// aligned, written by one TMA box (64, 1, R, 1) with
// CU_TENSOR_MAP_SWIZZLE_128B.  Read as a K-major wgmma
// operand (D is the reduction axis: Q and K in Q K^T) a k16 step is the
// half's base + 32 bytes per step, leading offset unused, stride 1024
// bytes per 8 rows.  Read as an MN-major operand (rows are the reduction
// axis: V in P V) a k16 step is the base + 16 rows (2048 bytes), the
// stride 1024 bytes per 8 rows and the leading offset the distance to
// the next half (the next 64 columns of N).
//
// wgmma accumulator layout (m64nN, fp32): thread t of the warpgroup, warp
// w = t / 32, lane g = (t % 32) / 4, q = t % 4, holds for each 8-column
// block j the four values d[4j .. 4j+3] at (row 16w + g, col 8j + 2q),
// (16w + g, 8j + 2q + 1), (16w + g + 8, 8j + 2q), (16w + g + 8,
// 8j + 2q + 1).  The register A fragment of one k16 step is that of
// mma.sync m16n8k16 for the warp's 16 rows, so the accumulator of columns
// 16k .. 16k + 15, rounded to pairs of the element type, is the A operand
// of step k (`pack_a`).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Makes initialised barriers visible to the async proxy (TMA); call once
// after the inits, before the block-wide barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits until the phase of parity `parity` has completed.  A wrong parity
// would wait forever; after ~10 s of clock the kernel traps, so the launch
// fails with an error the wrapper raises instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// ---- TMA ----------------------------------------------------------------------
// The box at coordinates (c0, c1, c2, c3), innermost first, of the tensor
// map into shared memory at `dst`; completes `bytes` of the barrier's
// expected transaction count (the whole box, out-of-bounds elements filled
// with zeros).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// The box at (c0, c1), innermost first, of a 2-D map; as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// Shared memory at `src` to the box at (c0, c1) of a 2-D map, in the
// calling thread's current bulk group; elements outside the tensor are not
// written.  The threads that wrote `src` call fence_async_smem() and meet
// at a barrier first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's bulk groups still read shared
// memory (their sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of the thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders the calling thread's writes to shared memory before later reads
// of the async proxy (a TMA store).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) among `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait or fence.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_F16(i) SM90_F4(i), SM90_F4(i + 4), SM90_F4(i + 8), SM90_F4(i + 12)

// The products' element type T: bf16 or fp16.  Both are 2 bytes, so the
// tiles, the swizzle, the k16 depth and the fragment layouts are the same;
// only the instruction's type names (and the TMA data type) differ.
template <typename T>
constexpr bool kF16 = std::is_same<T, __half>::value;

// ASM(TY), with TY the PTX name of T ("bf16" or "f16"), picked at compile
// time.
#define SM90_TYPED(T, ASM)                                          \
  if constexpr (kF16<T>) {                                          \
    ASM("f16");                                                     \
  } else {                                                          \
    static_assert(std::is_same<T, __nv_bfloat16>::value,            \
                  "the sm90 products take bf16 or fp16 operands");  \
    ASM("bf16");                                                    \
  }

#define SM90_SS32(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %18, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"                                     \
      "}\n"                                                                  \
      : SM90_F16(0)                                                          \
      : "l"(da), "l"(db), "r"(scale_d))
#define SM90_SS64(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                      \
      "}\n"                                                                  \
      : SM90_F16(0), SM90_F16(16)                                            \
      : "l"(da), "l"(db), "r"(scale_d))
#define SM90_SS128(TY)                                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "  \
      "1, 0, 0;\n"                                                           \
      "}\n"                                                                  \
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48)                \
      : "l"(da), "l"(db), "r"(scale_d))
#define SM90_RS64(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %37, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"        \
      "}\n"                                                                  \
      : SM90_F16(0), SM90_F16(16)                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define SM90_RS128(TY)                                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %69, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "  \
      "%67}, %68, p, 1, 1, 1;\n"                                             \
      "}\n"                                                                  \
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48)                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define SM90_SS_MN256(TY)                                                    \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %130, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "    \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "    \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "    \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "   \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "   \
      "%127}, %128, %129, p, 1, 1, 0, 1;\n"                                  \
      "}\n"                                                                  \
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48), SM90_F16(64), \
        SM90_F16(80), SM90_F16(96), SM90_F16(112)                            \
      : "l"(da), "l"(db), "r"(scale_d))

// d (64 x N) += A (64 x 16, shared, K-major) * B (16 x N, shared, K-major);
// scale_d = 0 overwrites d.  N: 32, 64 or 128.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N 32, 64, 128");
  if constexpr (N == 32) {
    SM90_TYPED(T, SM90_SS32)
  } else if constexpr (N == 64) {
    SM90_TYPED(T, SM90_SS64)
  } else {
    SM90_TYPED(T, SM90_SS128)
  }
}

// d (64 x N) += A (64 x 16, registers: a[0..3] as `pack_a` gives them) *
// B (16 x N, shared, MN-major: N contiguous, read transposed).  N: 64 or
// 128.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N 64 or 128");
  if constexpr (N == 64) {
    SM90_TYPED(T, SM90_RS64)
  } else {
    SM90_TYPED(T, SM90_RS128)
  }
}

// d (64 x N) += A (64 x 16, shared, K-major) * B (16 x N, shared,
// MN-major: N contiguous, read transposed); scale_d = 0 overwrites d.
// N: 256.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  static_assert(N == 256, "wgmma_ss_mn: N 256");
  SM90_TYPED(T, SM90_SS_MN256)
}

#undef SM90_SS_MN256
#undef SM90_RS128
#undef SM90_RS64
#undef SM90_SS128
#undef SM90_SS64
#undef SM90_SS32
#undef SM90_TYPED
#undef SM90_F16
#undef SM90_F4

// 2^x on the special-function unit, flushing denormal results to 0 (the
// softmax's weights below 2^-126 of the row maximum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to a pair of T (to nearest even), lo in the low
// half: one 32-bit register of an A fragment, or two adjacent elements.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
// The A fragments of the K / 16 steps of an accumulator d (64 x K, the
// layout above) rounded to T: a[4k .. 4k + 3] is step k.
template <typename T, int K>
__device__ __forceinline__ void pack_a(const float (&d)[K / 2],
                                       uint32_t (&a)[K / 4]) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    a[4 * k + 0] = pack2<T>(d[8 * k + 0], d[8 * k + 1]);
    a[4 * k + 1] = pack2<T>(d[8 * k + 2], d[8 * k + 3]);
    a[4 * k + 2] = pack2<T>(d[8 * k + 4], d[8 * k + 5]);
    a[4 * k + 3] = pack2<T>(d[8 * k + 6], d[8 * k + 7]);
  }
}

// ---- registers ----------------------------------------------------------------
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps -------------------------------------------------------
// Error codes past the CUDA runtime's, returned by the C entry points.
constexpr int ERR_NO_DRIVER = 20000;     // libcuda or the symbol not found
constexpr int ERR_ENCODE = 20001;        // + CUresult of the refused encode

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The TMA data type of T (bf16 or fp16).
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return kF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// One (B, S, H, D) 16-bit attention operand as the wrappers describe it:
// dims (D, H, S, B), innermost first, and the byte strides of H, S and B.
struct Geometry {
  long long dims[4];
  long long strides[3];
  // element strides (batch, row, head) for plain loads and stores
  long long eb() const { return strides[2] / 2; }
  long long es() const { return strides[1] / 2; }
  long long eh() const { return strides[0] / 2; }
};

inline Geometry geometry(const long long* g) {
  return Geometry{{g[0], g[1], g[2], g[3]}, {g[4], g[5], g[6]}};
}

// The 4-D map of an operand of elements `type` (bf16 or fp16) with box
// (64, 1, rows, 1) and the 128-byte swizzle.  Returns 0, or ERR_NO_DRIVER /
// ERR_ENCODE + CUresult.
inline int encode_operand(CUtensorMap* map, const void* base,
                          const Geometry& g, int rows,
                          CUtensorMapDataType type) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_DRIVER;
  const cuuint64_t dims[4] = {(cuuint64_t)g.dims[0], (cuuint64_t)g.dims[1],
                              (cuuint64_t)g.dims[2], (cuuint64_t)g.dims[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g.strides[0],
                                 (cuuint64_t)g.strides[1],
                                 (cuuint64_t)g.strides[2]};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// The 2-D map of a row-major matrix of elements `type` (a 16-bit type;
// rows x cols, `row_bytes` apart) with box (64 columns, `box_rows` rows)
// and the 128-byte swizzle: the box is one "half" of the layout above.
// Returns 0, or ERR_NO_DRIVER / ERR_ENCODE + CUresult.
inline int encode_matrix(CUtensorMap* map, const void* base, long long rows,
                         long long cols, long long row_bytes, int box_rows,
                         CUtensorMapDataType type) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_DRIVER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

}  // namespace sm90
