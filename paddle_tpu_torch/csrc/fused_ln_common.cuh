// What the fused epilogue's forward (fused_ln.cu) and backward
// (fused_ln_bwd.cu) share: the element math up to the normalisation, the
// reference's dropout hash, the 4-, 8- and 16-byte row loads and stores,
// the warp and block sums, and the 16-bit row tile both directions run
// (ln_fwd_tile, ln_bwd_tile): the ring of rows on cp.async, the fp32
// parameters in shared memory and the row prologue (z, mean, rstd).
//
// x and the residual each arrive as fp32, bf16 or fp16 (the reference's
// kernel reads each in its own type, ops/pallas/fused_ln.py:58,63), in the
// pairs AMP makes (`by_types`: one 16-bit type beside itself or fp32);
// bias, gamma and beta each as fp32, bf16 or fp16 (a 2-bit type code each
// in `param_types`).  All arithmetic is fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace fln {

using tile::from_f32;
using tile::to_f32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MAX_D = 1024;    // one warp per row: 32 values a lane
constexpr int ROW_CACHE_D = 12288;  // 48 KB of fp32 z per row

// The inputs both directions read.  p and q = 1 - p arrive rounded to
// fp32 once on the host; the keep test is `u >= p` and the scale a true
// fp32 division by q (no fast-math flags), as the reference computes them.
struct Inputs {
  const void* x;
  const void* res;
  const void* bias;
  const void* gamma;
  const void* beta;
  int N, D;
  int param_types;  // type codes: bits 0-1 bias, 2-3 gamma, 4-5 beta
  // The hash seed lives in device memory (its low 32 bits): a captured
  // CUDA graph replays the launch with its arguments frozen, and reads
  // there the seed its step wrote before the replay.  `seed` is that
  // value, loaded once at the kernel's start (with_seed).
  const unsigned long long* seed_ptr;
  uint32_t seed;
  int dropout;
  float p, q, eps;
};

// The inputs with the seed loaded from device memory (null and unread
// without dropout).
__device__ __forceinline__ Inputs with_seed(Inputs in) {
  in.seed = in.dropout ? (uint32_t)*in.seed_ptr : 0u;
  return in;
}

// The Murmur3 finaliser of the element index mod 2^32 under the seed.
__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t idx) {
  uint32_t h = (idx ^ seed) * 0x9E3779B1u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Uniform [0, 1) from its top 24 bits (the reference's hash_uniform,
// ops/pallas/fused_ln.py:33, bit for bit).
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t idx) {
  return (float)(hash_bits(seed, idx) >> 8) * (1.0f / 16777216.0f);
}

// Type codes, of the tensors and of the parameters in `param_types`.
constexpr int F32 = 0, BF16 = 1, F16 = 2;

// The type code of parameter k (0 bias, 1 gamma, 2 beta).
__host__ __device__ __forceinline__ int param_code(int types, int k) {
  return (types >> (2 * k)) & 3;
}

__device__ __forceinline__ float param(const void* v, int col, int code) {
  if (code == BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(v)[col]);
  if (code == F16) return __half2float(static_cast<const __half*>(v)[col]);
  return static_cast<const float*>(v)[col];
}

// One value stored in the type of `code`.
__device__ __forceinline__ void store_code(void* v, int col, int code,
                                           float x) {
  if (code == BF16)
    static_cast<__nv_bfloat16*>(v)[col] = __float2bfloat16_rn(x);
  else if (code == F16)
    static_cast<__half*>(v)[col] = __float2half_rn(x);
  else
    static_cast<float*>(v)[col] = x;
}

// Whether dropout keeps element (row, col): the index wraps mod 2^32, as
// the reference's uint32 iota does.
__device__ __forceinline__ bool kept(const Inputs& a, int row, int col) {
  const uint32_t idx = (uint32_t)row * (uint32_t)a.D + (uint32_t)col;
  return hash_uniform(a.seed, idx) >= a.p;
}

// z = residual + dropout(x + bias) of one element; `keep` is the mask bit
// (true without dropout).
__device__ __forceinline__ float pre_norm(const Inputs& a, float xv, float rv,
                                          int row, int col, bool& keep) {
  float h = xv + param(a.bias, col, param_code(a.param_types, 0));
  keep = true;
  if (a.dropout) {
    keep = kept(a, row, col);
    h = keep ? h / a.q : 0.f;
  }
  return rv + h;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the block of each thread's v, returned to every thread in
// the same order of additions.  red: WARPS floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red's previous use is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) t += red[i];
  return t;
}

template <int BYTES>
struct Vec;
template <>
struct Vec<4> {
  using type = uint32_t;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<16> {
  using type = uint4;
};

// VEC consecutive values at p, as one 4-, 8- or 16-byte access (VEC > 1,
// p aligned to VEC * sizeof(T)) or one value (VEC == 1)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else {
    using V = typename Vec<VEC * sizeof(T)>::type;
    const V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    using V = typename Vec<VEC * sizeof(T)>::type;
    V raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<V*>(p) = raw;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// F<TX, TR>::call(args...) for the (x, residual) type codes: fp32 with
// fp32, bf16 or fp16; bf16 or fp16 with itself or fp32.  A bf16 beside an
// fp16 is no pair AMP makes: cudaErrorInvalidValue.
template <template <typename, typename> class F, typename... A>
cudaError_t by_types(int dtype, int res_dtype, A... args) {
  switch (dtype * 3 + res_dtype) {
    case F32 * 3 + F32: return F<float, float>::call(args...);
    case F32 * 3 + BF16: return F<float, __nv_bfloat16>::call(args...);
    case F32 * 3 + F16: return F<float, __half>::call(args...);
    case BF16 * 3 + F32: return F<__nv_bfloat16, float>::call(args...);
    case BF16 * 3 + BF16:
      return F<__nv_bfloat16, __nv_bfloat16>::call(args...);
    case F16 * 3 + F32: return F<__half, float>::call(args...);
    case F16 * 3 + F16: return F<__half, __half>::call(args...);
    default: return cudaErrorInvalidValue;
  }
}

// Values a lane loads at once on the warp path: 16 bytes of a type when x
// and the residual share it, else 4 (16 bytes of fp32, 8 of bf16 or
// fp16); 1 when
// D or an operand's alignment does not allow it.
template <typename TX, typename TR>
constexpr int vec_width() {
  return sizeof(TX) == sizeof(TR) ? 16 / (int)sizeof(TX) : 4;
}

// ---------------------------------------------------------------------------
// The 16-bit row tile: x bf16 or fp16 (the residual in x's type or fp32),
// D <= 1024, D % 8 == 0, every row operand 16-byte aligned
// ---------------------------------------------------------------------------
// One warp per row.  A lane holds chunks c < NC of TILE_VEC columns,
// starting at (32c + lane) * TILE_VEC, the same columns in every row its
// warp takes.  A warp's next rows move into its ring in shared memory on
// cp.async while it computes the current one; each lane copies and reads
// back only its own 16-byte pieces, so no barrier orders the ring.
constexpr int TILE_VEC = 8;
constexpr int TILE_COLS = 32 * TILE_VEC;  // the columns of one chunk index

// 16-byte pieces of 8 values of T: 1 for a 16-bit type, 2 for fp32
template <typename T>
__host__ __device__ constexpr int pieces() {
  return (int)sizeof(T) / 2;
}

// 16-byte slots of one row of a ring: XN operands of x's type (the
// forward's x; the backward's x and g), then the residual, NC chunks each
template <typename TX, typename TR, int XN>
__host__ __device__ constexpr int ring_slots(int nc) {
  return nc * 32 * (XN * pieces<TX>() + pieces<TR>());
}

// The chunks a lane of the tile holds for rows of D, or 0 where the tile
// does not take x of type TX or rows of D.  Rows of up to 768 values take
// the 3-chunk kernels, their chunks past D idle, and longer ones the
// 4-chunk kernels: two kernels a type pair and direction, for the build's
// time (nvcc compiles each fully unrolled).
template <typename TX>
int tile_chunks(int D) {
  if (sizeof(TX) != 2 || D > WARP_MAX_D || D % TILE_VEC != 0) return 0;
  return D <= 3 * TILE_COLS ? 3 : 4;
}

// The vector width of the one-warp-a-row kernels' vector path: vec_width,
// or 1 where every row the vector path could take goes to the tile (16-bit
// x beside itself: D % 8 == 0), so that only the value-by-value path is
// built.
template <typename TX, typename TR>
constexpr int warp_vec() {
  return sizeof(TX) == 2 && vec_width<TX, TR>() % TILE_VEC == 0
             ? 1
             : vec_width<TX, TR>();
}

// Piece h of chunk c of the lane's values of one operand sits at slot
// (c * P + h) * 32 + lane of the operand's part of a stage (and of the
// fp32 parameters, P = 2): 32 lanes read 32 consecutive 16-byte slots.
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

// 8 values as T in 16-byte stores, rounded two at a time (one packing
// conversion a pair in 16 bits: store_pair)
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[TILE_VEC]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < pieces<T>(); ++h) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; i += 2)
      tile::store_pair(e + i, v[h * PER + i], v[h * PER + i + 1]);
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

// The lane's pieces of one row into a stage of its ring: x, then the
// residual, then (XN 2) g in x's type, each NC chunks.
template <typename TX, typename TR, int NC, int XN>
__device__ __forceinline__ void copy_row(uint4* st, int lane, int D,
                                         size_t base, const void* x,
                                         const void* res, const void* g) {
  uint4* rs = st + NC * 32 * pieces<TX>();
  uint4* gs = rs + NC * 32 * pieces<TR>();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col0 = (c * 32 + lane) * TILE_VEC;
    if (col0 < D) {
      copy8<TX>(st, c, lane, static_cast<const TX*>(x) + base + col0);
      copy8<TR>(rs, c, lane, static_cast<const TR*>(res) + base + col0);
      if constexpr (XN == 2)
        copy8<TX>(gs, c, lane, static_cast<const TX*>(g) + base + col0);
    }
  }
}

// A warp walks its rows row, row + step, ... < last through its ring of
// ST stages, row k in stage k % ST: ring_prefetch puts the first ST - 1
// in flight; ring_advance, at the top of row `row` (stage s), moves the
// row ST - 1 ahead into the stage the previous row left and waits for
// this lane's pieces of `row`.
template <int ST, typename Fetch>
__device__ __forceinline__ void ring_prefetch(int row, int last, int step,
                                              Fetch&& fetch) {
#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    if (row + k * step < last) fetch(row + k * step, k);
    tile::cp_async_commit();
  }
}

template <int ST, typename Fetch>
__device__ __forceinline__ void ring_advance(int row, int s, int last,
                                             int step, Fetch&& fetch) {
  const int ahead = row + (ST - 1) * step;
  if (ahead < last) fetch(ahead, s == 0 ? ST - 1 : s - 1);
  tile::cp_async_commit();
  tile::cp_async_wait<ST - 1>();  // this lane's pieces of `row` landed
}

template <int ST>
__device__ __forceinline__ int ring_next(int s) {
  return s + 1 == ST ? 0 : s + 1;
}

// The first K of bias, gamma and beta in fp32 in the lanes' layout, zero
// past D: column (32c + l) * 8 + v of vector k at float k * NC * 256 +
// ((2c + v / 4) * 32 + l) * 4 + v % 4.  Each vector is read once from
// device memory per block, through its type code.
template <int NC, int K>
__device__ __forceinline__ void stage_params(float* ps, const Inputs& a,
                                             int tid, int threads) {
  const void* vec[3] = {a.bias, a.gamma, a.beta};
  for (int col = tid; col < NC * TILE_COLS; col += threads) {
    const int k = col / TILE_VEC, v = col % TILE_VEC;
    const int at = ((2 * (k / 32) + v / 4) * 32 + k % 32) * 4 + v % 4;
#pragma unroll
    for (int j = 0; j < K; ++j)
      ps[j * NC * TILE_COLS + at] =
          col < a.D ? param(vec[j], col, param_code(a.param_types, j)) : 0.f;
  }
}

// Chunk c of the lane's values of one staged vector
__device__ __forceinline__ void param8(const float4* ps, int c, int lane,
                                       float (&v)[TILE_VEC]) {
  const float4 lo = ps[(2 * c) * 32 + lane];
  const float4 hi = ps[(2 * c + 1) * 32 + lane];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// The row prologue both directions share: from the lane's pieces of one
// row in a stage (x's part xs, the residual's rs), z = residual +
// dropout(x + bias) with the keep bits (bit 8c + v; 0 without dropout),
// then z centred on the row's mean (0 in chunks past D); returns rstd.
// The mask is the integer test against keep_floor, and the scale the
// reference's true fp32 division by q for every lane, then selected (no
// branch that splits the warp).
template <typename TX, typename TR, int NC>
__device__ __forceinline__ float tile_row(const Inputs& a, const uint4* xs,
                                          const uint4* rs,
                                          const float4* bias_s, int lane,
                                          int row, uint32_t floor_keep,
                                          float (&z)[NC][TILE_VEC],
                                          uint32_t& keep_bits) {
  const int D = a.D;
  const uint32_t idx0 = (uint32_t)row * (uint32_t)D;
  keep_bits = 0;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col0 = (c * 32 + lane) * TILE_VEC;
    if (col0 < D) {
      float xv[TILE_VEC], rv[TILE_VEC], bv[TILE_VEC];
      unpack8<TX>(xs, c, lane, xv);
      unpack8<TR>(rs, c, lane, rv);
      param8(bias_s, c, lane, bv);
#pragma unroll
      for (int v = 0; v < TILE_VEC; ++v) {
        float h = xv[v] + bv[v];
        if (a.dropout) {
          const bool keep =
              (hash_bits(a.seed, idx0 + (uint32_t)(col0 + v)) >> 8) >=
              floor_keep;
          keep_bits |= (uint32_t)keep << (c * TILE_VEC + v);
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
  return rsqrtf(warp_sum(sq) / (float)D + a.eps);
}

}  // namespace fln
