// The optimizer update for Hopper (sm_90a): every parameter of one step in
// one launch per group, for all twelve optimizers of optimizer/optimizers.py.
//
// Replaces no Pallas kernel.  The reference updates in two ways: its eager
// `Optimizer.step()` stacks same-shape parameters and runs one jitted
// `vmap` of the optimizer's `_update` per group
// (paddle_tpu/optimizer/fused_update.py:91, Momentum, Adam and AdamW), and
// its jitted `Model` step (`functional_apply`, optimizers.py:276) leaves
// every optimizer's per-parameter chain to XLA, which fuses it into one
// pass an element.  Both are this kernel: one pass over each element per
// step, for every optimizer, masters included.
//
// A group is the parameters of a step that share the optimizer kind and
// the types (`types` below); its launch walks a device table of `Rec`s, one
// a tensor, and a prefix table of chunk counts: block b updates chunk
// b - prefix[t] of tensor t, the largest t with prefix[t] <= b.  The
// learning rate is read through a pointer to the optimizer's fp32 device
// scalar, so that a captured step reads the rate its scheduler set before
// the replay; the hyperparameters are launch arguments, fixed for the
// optimizer's life.
//
// What bounds it on an H100: bytes.  Each element's parameter (or master),
// gradient and slots are read once and written once, a few tens of fp32
// operations against 12-36 bytes in fp32, far under the 20 flops a byte
// at which 67 TFLOP/s would bind.  Each thread moves 16-byte vectors (4
// fp32, 8 bf16 or fp16; a 16-bit gradient under an fp32 master 8 bytes),
// with a scalar tail; a tensor whose pointers are not all 16-byte aligned
// goes element by element.  The unscale pass below is bound by bytes as
// well: each gradient element read once and written once (8 B in fp32).
//
// Arithmetic: fp32 in registers, each operation rounded as the per-leaf
// PyTorch code rounds it (`__fmul_rn` and friends: nvcc would contract
// a*b + c into an FMA, which the per-leaf path, one operation a pass,
// never does), in the order of each class's `_update`.  Outputs are
// rounded once, to nearest even, when stored: a 16-bit parameter without
// a master and its 16-bit slots round once, not after every operation as
// the per-leaf path does in bf16 (PERF.md §6 gives the difference).
// Under a master the 16-bit parameter is written from the new master
// (`__float2bfloat16_rn`, `__float2half_rn`), so it equals the master
// cast to its type bit for bit.
//
// The trust-ratio optimizers need each tensor's norms first: `mt_norms`
// writes one partial per block (LarsMomentum: ||w||^2 and ||g||^2; Lamb:
// ||w||^2 and ||r||^2, after computing and storing the new moments), then
// a second launch folds each tensor's partials in block order.  No float
// atomics: two runs, and a captured step against an uncaptured one, agree
// bit for bit.  `mt_pows` advances each tensor's beta powers after the
// update pass has read them, one thread a tensor: the blocks of a tensor
// all read the old power, so none may write it.
//
// The row-sparse update (the reference's `_update_sparse`,
// paddle_tpu/optimizer/optimizers.py:350 SGD, :455 Adam, :499 AdamW, XLA
// scatters): `mt_update_rows` steps only the rows a merged SelectedRows
// gradient touches, through each kind's functor below, so a touched row
// moves exactly as the dense pass would move it with that gradient, and an
// untouched row, its slots and its 16-bit parameter keep every bit (Adam's
// lazy rows; AdamW decays touched rows only).  Bound by bytes: per touched
// element the parameter, the slots and the 16-bit parameter read and
// written, the value read, and a row index per row.
//
// Loss scaling under fp16 AMP (the reference's jitted step,
// paddle_tpu/hapi/model.py:296-331, and ops/amp_ops.py:16
// check_finite_and_unscale, both XLA): `mt_unscale` multiplies every
// gradient of a group in place by inv = 1/scale, read from the fp32 device
// scalar of the scale and rounded to the gradient's type, as the jitted
// step's `g * inv.astype(g.dtype)` does, and sets a device flag when any
// gradient element is not finite.  It is bound by bytes (8 B an fp32
// element): on the GPT's 132 M fp32 gradients, timed alone on an H100
// (700 W), 0.3696 ms, 85.5% of that bound and 7.4% under PyTorch's own
// `_amp_foreach_non_finite_check_and_unscale_` (PERF.md §6).  A thread
// holds four 16-byte vectors in flight (with the fold below, 0.5-1.8%
// faster than one and a fill launch); persistent blocks striding over
// the chunks measured slower, so a block takes one chunk.  The flag needs
// no clearing launch: each block counts itself, and its finding, in one
// atomic add to a 64-bit fold word; the last block to count writes the
// flag (the first group of a call overwrites it, later ones OR into it)
// and zeroes the word, so a captured launch replays from the state it was
// captured in.
// The result does not depend on the order of the blocks, and an integer
// atomic on a counter leaves every float bit as the plain version's.
// `mt_update`, `mt_norms` and `mt_pows` take that flag as `skip`: set, they
// return before writing anything, so parameters, masters, slots and powers
// keep their values, the reference's `jnp.where(found_inf, old, new)` over
// (params, opt_state), with no read of the flag on the host.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// the kernel's kinds (ops/multi_tensor_update.py KINDS)
enum Kind {
  SGD = 0,
  MOMENTUM,
  LARS,
  ADAM,
  ADAMW,
  ADAMAX,
  ADAGRAD,
  ADADELTA,
  RMSPROP,
  RMSPROP_CENTERED,
  LAMB,
  FTRL,
  DECAYED_ADAGRAD,
};

// One tensor of a group (ops/multi_tensor_update.py `_Rec`, field for
// field).
struct Rec {
  void* w;          // the parameter, or its fp32 master
  const void* g;    // the gradient, in the parameter's type
  void* p16;        // the 16-bit parameter written from the master, or null
  void* s[3];       // the element slots in the kind's order, null past them
  float* pw[2];     // the fp32 beta powers (beta1_pow, beta2_pow), or null
  long long n;      // elements
  float lr_scale;   // optimize_attr["learning_rate"]
  float reg_coeff;  // the regularizer's coefficient
  float decay;      // AdamW: the weight decay of this name (0: none)
  int reg;          // 0 none, 1 L1Decay, 2 L2Decay
  int plain;        // LarsMomentum: a name it excludes (plain momentum)
  int vec;          // every pointer 16-byte aligned: vector loads
};
static_assert(sizeof(Rec) == 96, "Rec must match ops/multi_tensor_update.py");

// The optimizer's hyperparameters (each kind's layout: Op<K> below) and
// its flags (Momentum: Nesterov; Ftrl: lr_power other than -0.5).
struct Hyper {
  float h[8];
  int flags;
};

// What a block computes once for its tensor.
struct Ctx {
  float lr;     // the rate times the tensor's lr scale
  float a, b, c;
  int on;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float sgn(float a) {
  return a > 0.f ? 1.f : (a < 0.f ? -1.f : a);  // torch.sign, NaN kept
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
// v as a slot of type T stores it
template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_f(from_f<T>(v)); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const void* base, long long i,
                                     float (&out)[V]) {
  const Pack<T, V> p =
      *reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(base) + i);
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = to_f(p.v[v]);
}

template <typename T, int V>
__device__ __forceinline__ void store(void* base, long long i,
                                      const float (&in)[V]) {
  Pack<T, V> p;
#pragma unroll
  for (int v = 0; v < V; ++v) p.v[v] = from_f<T>(in[v]);
  *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(base) + i) = p;
}

// types (ops/multi_tensor_update.py _TYPES): 0 fp32 parameter, gradient
// and slots; 1 bf16 parameter and gradient over an fp32 master, fp32
// slots; 2 bf16 parameter, gradient and slots; 3 and 4 as 1 and 2 in
// fp16.  W is the type of the tensor updated (and of its slots), G the
// gradient's and the parameter's.
template <typename W_, typename G_>
struct TypesOf {
  using W = W_;
  using G = G_;
  static constexpr bool master = !std::is_same<W_, G_>::value;
};
template <int TC>
struct Types;
template <>
struct Types<0> : TypesOf<float, float> {};
template <>
struct Types<1> : TypesOf<float, __nv_bfloat16> {};
template <>
struct Types<2> : TypesOf<__nv_bfloat16, __nv_bfloat16> {};
template <>
struct Types<3> : TypesOf<float, __half> {};
template <>
struct Types<4> : TypesOf<__half, __half> {};

// The regularizer's gradient added to g (regularizer.py L1Decay, L2Decay;
// read on the master where there is one).
__device__ __forceinline__ float regularized(const Rec& r, float w, float g) {
  if (r.reg == 1) return add(g, mul(r.reg_coeff, sgn(w)));
  if (r.reg == 2) return add(g, mul(r.reg_coeff, w));
  return g;
}

// ---------------------------------------------------------------------------
// One functor per kind, each in the op order of its class's `_update`
// (paddle_tpu_torch/optimizer/optimizers.py).  NS: element slots; GRAD: the
// update pass reads the gradient; SLOTS: it writes the slots back.
// `tensor` fills the block's Ctx, `elem` steps one element.
// ---------------------------------------------------------------------------
template <int K>
struct Op;

struct NoNorms {
  __device__ static void tensor(const Hyper&, const Rec&, const float*,
                                Ctx&) {}
};

// SGD._update: w - lr·g
template <>
struct Op<SGD> : NoNorms {
  static constexpr int NS = 0;
  static constexpr bool GRAD = true, SLOTS = false;
  __device__ static void elem(const Hyper&, const Ctx& c, float& w, float g,
                              float*) {
    w = sub(w, mul(c.lr, g));
  }
};

// Momentum._update: v = μ·v + g; w - lr·v, or w - lr·(g + μ·v) (flags 1)
// h: μ
template <>
struct Op<MOMENTUM> : NoNorms {
  static constexpr int NS = 1;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float v = add(mul(h.h[0], s[0]), g);
    s[0] = v;
    w = (h.flags & 1) ? sub(w, mul(c.lr, add(g, mul(h.h[0], v))))
                      : sub(w, mul(c.lr, v));
  }
};

// LarsMomentum._update: trust = coeff·||w|| / (||g|| + wd·||w|| + eps)
// (1 where a norm is 0); v = μ·v + lr·trust·(g + wd·w); w - v.  An
// excluded name: v = μ·v + lr·g.  h: μ, coeff, wd, eps
template <>
struct Op<LARS> {
  static constexpr int NS = 1;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void tensor(const Hyper& h, const Rec& r,
                                const float* norm, Ctx& c) {
    c.on = r.plain;
    if (r.plain) return;
    const float wn = root(norm[0]), gn = root(norm[1]);
    const float local =
        (wn > 0.f && gn > 0.f)
            ? dvd(mul(h.h[1], wn), add(add(gn, mul(h.h[2], wn)), h.h[3]))
            : 1.f;
    c.a = mul(c.lr, local);
  }
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float v = c.on ? add(mul(h.h[0], s[0]), mul(c.lr, g))
                         : add(mul(h.h[0], s[0]),
                               mul(c.a, add(g, mul(h.h[2], w))));
    s[0] = v;
    w = sub(w, v);
  }
  // the norms pass: ||w||², ||g||²
  __device__ static void norm_tensor(const Hyper&, const Rec&, Ctx&) {}
  template <typename TW>
  __device__ static void norm_elem(const Hyper&, const Ctx&, float w,
                                   float g, float*, float& a, float& b) {
    a += w * w;
    b += g * g;
  }
};

// Adam._update with the bias correction folded into the rate:
// m1 = β1·m1 + (1-β1)·g; m2 = β2·m2 + (1-β2)·g²;
// w - (lr·sqrt(1-β2ᵗ)/(1-β1ᵗ))·m1 / (sqrt(m2) + eps).
// h: β1, 1-β1, β2, 1-β2, eps
template <>
struct Op<ADAM> {
  static constexpr int NS = 2;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void tensor(const Hyper& h, const Rec& r, const float*,
                                Ctx& c) {
    const float b1p = mul(*r.pw[0], h.h[0]), b2p = mul(*r.pw[1], h.h[2]);
    c.a = dvd(mul(c.lr, root(sub(1.f, b2p))), sub(1.f, b1p));
  }
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float m1 = add(mul(h.h[0], s[0]), mul(h.h[1], g));
    const float m2 = add(mul(h.h[2], s[1]), mul(h.h[3], mul(g, g)));
    s[0] = m1;
    s[1] = m2;
    w = sub(w, dvd(mul(c.a, m1), add(root(m2), h.h[4])));
  }
};

// AdamW._update: w·(1 - lr·wd) for a name the decay function takes, then
// Adam.  h: as Adam
template <>
struct Op<ADAMW> {
  static constexpr int NS = 2;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void tensor(const Hyper& h, const Rec& r,
                                const float* norm, Ctx& c) {
    Op<ADAM>::tensor(h, r, norm, c);
    c.on = r.decay != 0.f;
    c.b = sub(1.f, mul(c.lr, r.decay));
  }
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    if (c.on) w = mul(w, c.b);
    Op<ADAM>::elem(h, c, w, g, s);
  }
};

// Adamax._update: m = β1·m + (1-β1)·g; u = max(β2·u, |g|);
// w - (lr/(1-β1ᵗ))·m / (u + eps).  h: β1, 1-β1, β2, eps
template <>
struct Op<ADAMAX> {
  static constexpr int NS = 2;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void tensor(const Hyper& h, const Rec& r, const float*,
                                Ctx& c) {
    c.a = dvd(c.lr, sub(1.f, mul(*r.pw[0], h.h[0])));
  }
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float m = add(mul(h.h[0], s[0]), mul(h.h[1], g));
    const float u = fmaxf(mul(h.h[2], s[1]), fabsf(g));
    s[0] = m;
    s[1] = u;
    w = sub(w, dvd(mul(c.a, m), add(u, h.h[3])));
  }
};

// Adagrad._update: acc += g²; w - lr·g/(sqrt(acc) + eps).  h: eps
template <>
struct Op<ADAGRAD> : NoNorms {
  static constexpr int NS = 1;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float acc = add(s[0], mul(g, g));
    s[0] = acc;
    w = sub(w, dvd(mul(c.lr, g), add(root(acc), h.h[0])));
  }
};

// Adadelta._update: E[g²] = ρ·E[g²] + (1-ρ)·g²;
// Δ = -sqrt(E[Δ²] + eps)/sqrt(E[g²] + eps)·g; E[Δ²] = ρ·E[Δ²] + (1-ρ)·Δ²;
// w + lr·Δ.  h: ρ, 1-ρ, eps
template <>
struct Op<ADADELTA> : NoNorms {
  static constexpr int NS = 2;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float g2 = add(mul(h.h[0], s[0]), mul(h.h[1], mul(g, g)));
    const float upd =
        mul(dvd(-root(add(s[1], h.h[2])), root(add(g2, h.h[2]))), g);
    const float u2 = add(mul(h.h[0], s[1]), mul(h.h[1], mul(upd, upd)));
    s[0] = g2;
    s[1] = u2;
    w = add(w, mul(c.lr, upd));
  }
};

// RMSProp._update: E[g²] = ρ·E[g²] + (1-ρ)·g² (centered: less E[g]²);
// mom = μ·mom + lr·g/sqrt(... + eps); w - mom.  Slots mean_square,
// momentum_acc (, mean_grad).  h: ρ, 1-ρ, eps, μ
template <bool CENTERED>
struct RmsProp : NoNorms {
  static constexpr int NS = CENTERED ? 3 : 2;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float ms = add(mul(h.h[0], s[0]), mul(h.h[1], mul(g, g)));
    float denom;
    if (CENTERED) {
      const float mg = add(mul(h.h[0], s[2]), mul(h.h[1], g));
      denom = root(add(sub(ms, mul(mg, mg)), h.h[2]));
      s[2] = mg;
    } else {
      denom = root(add(ms, h.h[2]));
    }
    const float mom = add(mul(h.h[3], s[1]), dvd(mul(c.lr, g), denom));
    s[0] = ms;
    s[1] = mom;
    w = sub(w, mom);
  }
};
template <>
struct Op<RMSPROP> : RmsProp<false> {};
template <>
struct Op<RMSPROP_CENTERED> : RmsProp<true> {};

// Lamb._update: Adam's moments; r = (m1/(1-β1ᵗ)) / (sqrt(m2/(1-β2ᵗ)) + eps)
// + wd·w; trust = ||w||/||r|| (1 where a norm is 0); w - (lr·trust)·r.
// The norms pass computes and stores the moments and sums ||w||², ||r||²;
// the update pass reads w and the stored moments, no gradient, and
// recomputes r from them.  h: β1, 1-β1, β2, 1-β2, eps, wd
template <>
struct Op<LAMB> {
  static constexpr int NS = 2;
  static constexpr bool GRAD = false, SLOTS = false;
  __device__ static void norm_tensor(const Hyper& h, const Rec& r, Ctx& c) {
    c.a = sub(1.f, mul(*r.pw[0], h.h[0]));
    c.b = sub(1.f, mul(*r.pw[1], h.h[2]));
  }
  __device__ static float ratio(const Hyper& h, const Ctx& c, float w,
                                float m1, float m2) {
    return add(dvd(dvd(m1, c.a), add(root(dvd(m2, c.b)), h.h[4])),
               mul(h.h[5], w));
  }
  template <typename TW>
  __device__ static void norm_elem(const Hyper& h, const Ctx& c, float w,
                                   float g, float* s, float& a, float& b) {
    // the stored moments, which the update pass reads back
    s[0] = rounded<TW>(add(mul(h.h[0], s[0]), mul(h.h[1], g)));
    s[1] = rounded<TW>(add(mul(h.h[2], s[1]), mul(h.h[3], mul(g, g))));
    const float r = ratio(h, c, w, s[0], s[1]);
    a += w * w;
    b += r * r;
  }
  __device__ static void tensor(const Hyper& h, const Rec& r,
                                const float* norm, Ctx& c) {
    norm_tensor(h, r, c);
    const float wn = root(norm[0]), rn = root(norm[1]);
    c.c = mul(c.lr, (wn > 0.f && rn > 0.f) ? dvd(wn, rn) : 1.f);
  }
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w, float,
                              float* s) {
    w = sub(w, mul(c.c, ratio(h, c, w, s[0], s[1])));
  }
};

// Ftrl._update: n' = n + g²; σ = (n'^-p - n^-p)/lr (square roots at p
// -0.5); z' = z + g - σ·w; w = (l1·sign(z') - z')/(n'^-p/lr + 2·l2) where
// |z'| > l1, else 0.  h: l1, 2·l2, -p; flags 1: p other than -0.5
template <>
struct Op<FTRL> : NoNorms {
  static constexpr int NS = 2;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float nsq = add(s[0], mul(g, g));
    const float pn = (h.flags & 1) ? powf(nsq, h.h[2]) : root(nsq);
    const float po = (h.flags & 1) ? powf(s[0], h.h[2]) : root(s[0]);
    const float sigma = dvd(sub(pn, po), c.lr);
    const float y = add(dvd(pn, c.lr), h.h[1]);
    const float lin = sub(add(s[1], g), mul(sigma, w));
    const float x = sub(mul(h.h[0], sgn(lin)), lin);
    w = fabsf(lin) > h.h[0] ? dvd(x, y) : 0.f;
    s[0] = nsq;
    s[1] = lin;
  }
};

// DecayedAdagrad._update: m = d·m + (1-d)·g²; w - lr·g/(sqrt(m) + eps).
// h: d, 1-d, eps
template <>
struct Op<DECAYED_ADAGRAD> : NoNorms {
  static constexpr int NS = 1;
  static constexpr bool GRAD = true, SLOTS = true;
  __device__ static void elem(const Hyper& h, const Ctx& c, float& w,
                              float g, float* s) {
    const float m = add(mul(h.h[0], s[0]), mul(h.h[1], mul(g, g)));
    s[0] = m;
    w = sub(w, dvd(mul(c.lr, g), add(root(m), h.h[2])));
  }
};

// ---------------------------------------------------------------------------
// The passes
// ---------------------------------------------------------------------------
__device__ __forceinline__ int tensor_of(const int* prefix, int n, int b) {
  int lo = 0, hi = n - 1;  // the last t with prefix[t] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// V elements from i on: load, step, store.  The gradient is read from
// element ig on: i itself in the dense pass, the element of the merged
// values in the rows pass
template <int K, int TC, int V>
__device__ __forceinline__ void update_at(const Rec& r, long long i,
                                          long long ig, const Hyper& h,
                                          const Ctx& c) {
  using T = Types<TC>;
  using O = Op<K>;
  constexpr int NS = O::NS;
  float w[V], g[V], s[NS > 0 ? NS : 1][V];
  load<typename T::W, V>(r.w, i, w);
  if (O::GRAD) load<typename T::G, V>(r.g, ig, g);
#pragma unroll
  for (int k = 0; k < NS; ++k) load<typename T::W, V>(r.s[k], i, s[k]);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float sv[NS > 0 ? NS : 1];
#pragma unroll
    for (int k = 0; k < NS; ++k) sv[k] = s[k][v];
    O::elem(h, c, w[v], O::GRAD ? regularized(r, w[v], g[v]) : 0.f, sv);
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k][v] = sv[k];
  }
  store<typename T::W, V>(r.w, i, w);
  if (O::SLOTS) {
#pragma unroll
    for (int k = 0; k < NS; ++k) store<typename T::W, V>(r.s[k], i, s[k]);
  }
  if (T::master) store<typename T::G, V>(r.p16, i, w);
}

// the skip flag (null: never skip)
__device__ __forceinline__ bool skipped(const unsigned char* skip) {
  return skip != nullptr && *skip != 0;
}

template <int K, int TC>
__global__ void __launch_bounds__(THREADS)
    mt_update_kernel(const Rec* recs, const int* prefix, int n, int chunk,
                     const float* lr, Hyper h, const float* norms,
                     const unsigned char* skip) {
  constexpr int V = 16 / sizeof(typename Types<TC>::W);
  if (skipped(skip)) return;
  const int t = tensor_of(prefix, n, blockIdx.x);
  const Rec r = recs[t];
  Ctx c{};
  c.lr = mul(*lr, r.lr_scale);
  Op<K>::tensor(h, r, norms ? norms + 2 * t : nullptr, c);
  const long long start = (long long)(blockIdx.x - prefix[t]) * chunk;
  const long long end = min(r.n, start + chunk);
  if (r.vec) {
    for (long long i = start + (long long)threadIdx.x * V; i < end;
         i += (long long)THREADS * V) {
      if (i + V <= end) {
        update_at<K, TC, V>(r, i, i, h, c);
      } else {
        for (long long j = i; j < end; ++j)
          update_at<K, TC, 1>(r, j, j, h, c);
      }
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += THREADS)
      update_at<K, TC, 1>(r, i, i, h, c);
  }
}

// The rows pass: what a row-sparse gradient (SelectedRows, merged: unique
// rows, each row's slices summed) updates.  A record's `g` holds the
// merged values, R rows of D elements in the parameter's type, `n` is R·D,
// and its `RowsAux` the rows (R int64, unique) and D.  Element e of the
// values steps element rows[e / D]·D + e % D of the parameter (or master),
// its slots and its 16-bit parameter, through the same functor as the
// dense pass.  Vectors run along D when D is a multiple of V (every
// vector then lies in one row) and the pointers are aligned; else element
// by element.  Rows are unique, so no two threads write one element: no
// atomics, and the result depends on no order of the blocks.
struct RowsAux {
  const long long* rows;  // the merged rows, unique
  long long dim;          // D, the elements of a row
};

template <int K, int TC>
__global__ void __launch_bounds__(THREADS)
    mt_update_rows_kernel(const Rec* recs, const RowsAux* aux,
                          const int* prefix, int n, int chunk,
                          const float* lr, Hyper h,
                          const unsigned char* skip) {
  constexpr int V = 16 / sizeof(typename Types<TC>::W);
  if (skipped(skip)) return;
  const int t = tensor_of(prefix, n, blockIdx.x);
  const Rec r = recs[t];
  const long long* rows = aux[t].rows;
  const long long D = aux[t].dim;
  Ctx c{};
  c.lr = mul(*lr, r.lr_scale);
  Op<K>::tensor(h, r, nullptr, c);
  const long long start = (long long)(blockIdx.x - prefix[t]) * chunk;
  const long long end = min(r.n, start + chunk);
  if (r.vec) {
    for (long long e = start + (long long)threadIdx.x * V; e < end;
         e += (long long)THREADS * V) {
      const long long row = e / D;
      update_at<K, TC, V>(r, rows[row] * D + (e - row * D), e, h, c);
    }
  } else {
    for (long long e = start + threadIdx.x; e < end; e += THREADS) {
      const long long row = e / D;
      update_at<K, TC, 1>(r, rows[row] * D + (e - row * D), e, h, c);
    }
  }
}

// a and b summed over the block, in a fixed order; the result in thread 0
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[WARPS], sb[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < WARPS ? sa[lane] : 0.f;
    b = lane < WARPS ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

template <int K, int TC, int V>
__device__ __forceinline__ void norms_at(const Rec& r, long long i,
                                         const Hyper& h, const Ctx& c,
                                         float& a, float& b) {
  using T = Types<TC>;
  using O = Op<K>;
  constexpr int NS = K == LAMB ? 2 : 0;  // Lamb stores its moments here
  float w[V], g[V], s[NS > 0 ? NS : 1][V];
  load<typename T::W, V>(r.w, i, w);
  load<typename T::G, V>(r.g, i, g);
#pragma unroll
  for (int k = 0; k < NS; ++k) load<typename T::W, V>(r.s[k], i, s[k]);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float sv[2];
#pragma unroll
    for (int k = 0; k < NS; ++k) sv[k] = s[k][v];
    O::template norm_elem<typename T::W>(h, c, w[v],
                                         regularized(r, w[v], g[v]), sv, a,
                                         b);
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k][v] = sv[k];
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) store<typename T::W, V>(r.s[k], i, s[k]);
}

// one block a chunk: its two partial sums of squares
template <int K, int TC>
__global__ void __launch_bounds__(THREADS)
    mt_norms_kernel(const Rec* recs, const int* prefix, int n, int chunk,
                    Hyper h, float* partials, const unsigned char* skip) {
  constexpr int V = 16 / sizeof(typename Types<TC>::W);
  if (skipped(skip)) return;  // Lamb would store its moments
  const int t = tensor_of(prefix, n, blockIdx.x);
  const Rec r = recs[t];
  Ctx c{};
  Op<K>::norm_tensor(h, r, c);
  float a = 0.f, b = 0.f;
  if (!r.plain) {  // an excluded LarsMomentum name needs no norms
    const long long start = (long long)(blockIdx.x - prefix[t]) * chunk;
    const long long end = min(r.n, start + chunk);
    if (r.vec) {
      for (long long i = start + (long long)threadIdx.x * V; i < end;
           i += (long long)THREADS * V) {
        if (i + V <= end) {
          norms_at<K, TC, V>(r, i, h, c, a, b);
        } else {
          for (long long j = i; j < end; ++j)
            norms_at<K, TC, 1>(r, j, h, c, a, b);
        }
      }
    } else {
      for (long long i = start + threadIdx.x; i < end; i += THREADS)
        norms_at<K, TC, 1>(r, i, h, c, a, b);
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = b;
  }
}

// one block a tensor: its partials folded in block order
__global__ void __launch_bounds__(THREADS)
    mt_fold_kernel(const int* prefix, const float* partials, float* norms,
                   const unsigned char* skip) {
  if (skipped(skip)) return;
  const int t = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (int i = prefix[t] + threadIdx.x; i < prefix[t + 1]; i += THREADS) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    norms[2 * t] = a;
    norms[2 * t + 1] = b;
  }
}

// one thread a tensor: β1ᵗ⁺¹ = β1ᵗ·β1, β2ᵗ⁺¹ = β2ᵗ·β2
__global__ void mt_pows_kernel(const Rec* recs, int n, float b1, float b2,
                               const unsigned char* skip) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n || skipped(skip)) return;
  float* p1 = recs[t].pw[0];
  float* p2 = recs[t].pw[1];
  if (p1) *p1 = mul(*p1, b1);
  if (p2) *p2 = mul(*p2, b2);
}

struct Launch {
  const Rec* recs;
  const int* prefix;
  int n, nchunks, chunk;
  const float* lr;
  Hyper h;
  float* norms;
  float* partials;
  const unsigned char* skip;
  cudaStream_t s;
};

template <int K, int TC>
void launch_update(const Launch& a) {
  mt_update_kernel<K, TC><<<a.nchunks, THREADS, 0, a.s>>>(
      a.recs, a.prefix, a.n, a.chunk, a.lr, a.h, a.norms, a.skip);
}

template <int K, int TC>
void launch_norms(const Launch& a) {
  mt_norms_kernel<K, TC><<<a.nchunks, THREADS, 0, a.s>>>(
      a.recs, a.prefix, a.n, a.chunk, a.h, a.partials, a.skip);
  mt_fold_kernel<<<a.n, THREADS, 0, a.s>>>(a.prefix, a.partials, a.norms,
                                           a.skip);
}

template <int K>
bool update_types(const Launch& a, int types) {
  switch (types) {
    case 0: launch_update<K, 0>(a); return true;
    case 1: launch_update<K, 1>(a); return true;
    case 2: launch_update<K, 2>(a); return true;
    case 3: launch_update<K, 3>(a); return true;
    case 4: launch_update<K, 4>(a); return true;
    default: return false;
  }
}

template <int K, int TC>
void launch_rows(const Launch& a, const RowsAux* aux) {
  mt_update_rows_kernel<K, TC><<<a.nchunks, THREADS, 0, a.s>>>(
      a.recs, aux, a.prefix, a.n, a.chunk, a.lr, a.h, a.skip);
}

template <int K>
bool rows_types(const Launch& a, const RowsAux* aux, int types) {
  switch (types) {
    case 0: launch_rows<K, 0>(a, aux); return true;
    case 1: launch_rows<K, 1>(a, aux); return true;
    case 2: launch_rows<K, 2>(a, aux); return true;
    case 3: launch_rows<K, 3>(a, aux); return true;
    case 4: launch_rows<K, 4>(a, aux); return true;
    default: return false;
  }
}

template <int K>
bool norms_types(const Launch& a, int types) {
  switch (types) {
    case 0: launch_norms<K, 0>(a); return true;
    case 1: launch_norms<K, 1>(a); return true;
    case 2: launch_norms<K, 2>(a); return true;
    case 3: launch_norms<K, 3>(a); return true;
    case 4: launch_norms<K, 4>(a); return true;
    default: return false;
  }
}

bool update_kind(const Launch& a, int kind, int types) {
  switch (kind) {
    case SGD: return update_types<SGD>(a, types);
    case MOMENTUM: return update_types<MOMENTUM>(a, types);
    case LARS: return update_types<LARS>(a, types);
    case ADAM: return update_types<ADAM>(a, types);
    case ADAMW: return update_types<ADAMW>(a, types);
    case ADAMAX: return update_types<ADAMAX>(a, types);
    case ADAGRAD: return update_types<ADAGRAD>(a, types);
    case ADADELTA: return update_types<ADADELTA>(a, types);
    case RMSPROP: return update_types<RMSPROP>(a, types);
    case RMSPROP_CENTERED: return update_types<RMSPROP_CENTERED>(a, types);
    case LAMB: return update_types<LAMB>(a, types);
    case FTRL: return update_types<FTRL>(a, types);
    case DECAYED_ADAGRAD: return update_types<DECAYED_ADAGRAD>(a, types);
    default: return false;
  }
}

Launch launch_args(const void* recs, const int* prefix, int n, int nchunks,
                   int chunk, const float* lr, const float* hyper, int flags,
                   float* norms, float* partials, const void* skip,
                   void* stream) {
  Launch a{static_cast<const Rec*>(recs),
           prefix,
           n,
           nchunks,
           chunk,
           lr,
           {},
           norms,
           partials,
           static_cast<const unsigned char*>(skip),
           static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 8; ++i) a.h.h[i] = hyper[i];
  a.h.flags = flags;
  return a;
}

bool shape_ok(int n, int nchunks, int chunk) {
  return n > 0 && nchunks > 0 && chunk > 0 && chunk % (THREADS * 8) == 0;
}

// ---------------------------------------------------------------------------
// The unscale pass: the gradients of a group (Rec.w, Rec.n, Rec.vec; the
// other fields unread) times inv = 1/scale in their type G, in place
// ---------------------------------------------------------------------------
// not finite: the exponent's bits all set (inf, nan)
__device__ __forceinline__ bool not_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// 16-byte vectors a thread loads before it multiplies and stores any
constexpr int UNSCALE_UNROLL = 4;

// V values of one vector times inv, in place in registers; whether one of
// them was not finite before the multiply
template <typename G, int V>
__device__ __forceinline__ bool unscale_pack(Pack<G, V>& p, float inv) {
  bool bad = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float g = to_f(p.v[v]);
    bad |= not_finite(g);
    p.v[v] = from_f<G>(mul(g, inv));  // exact for 16-bit G, rounded once
  }
  return bad;
}

template <typename G, int V>
__device__ __forceinline__ bool unscale_at(G* w, long long i, float inv) {
  Pack<G, V> p = *reinterpret_cast<const Pack<G, V>*>(w + i);
  const bool bad = unscale_pack<G, V>(p, inv);
  *reinterpret_cast<Pack<G, V>*>(w + i) = p;
  return bad;
}

// One launch over the chunks of a group, one block a chunk.  The blocks'
// findings reach `found` through `fold`, one
// 64-bit word, zero between launches: each block adds 1 to its low half
// and, if it saw a value that is not finite, 1 to its high half, in one
// atomic add, so the block that brings the low half to gridDim.x knows it
// is the last and sees every finding.  It writes found = (first ? 0 :
// found) | (high half > 0) and zeroes the word, so a captured launch
// replays from the same state.  The flag depends on no order of the
// blocks.
template <typename G>
__global__ void __launch_bounds__(THREADS)
    mt_unscale_kernel(const Rec* __restrict__ recs,
                      const int* __restrict__ prefix, int n, int chunk,
                      const float* __restrict__ scale, unsigned char* found,
                      unsigned long long* fold, int first) {
  constexpr int V = 16 / sizeof(G);
  constexpr long long STEP = (long long)THREADS * V;
  const float inv = rounded<G>(dvd(1.f, *scale));
  const int t = tensor_of(prefix, n, blockIdx.x);
  G* w = static_cast<G*>(recs[t].w);
  const long long start = (long long)(blockIdx.x - prefix[t]) * chunk;
  const long long end = min(recs[t].n, start + chunk);
  bool bad = false;
  if (recs[t].vec) {
    long long i = start + (long long)threadIdx.x * V;
    // UNSCALE_UNROLL vectors in flight: all loaded before any is stored
    for (; i + (UNSCALE_UNROLL - 1) * STEP + V <= end;
         i += UNSCALE_UNROLL * STEP) {
      Pack<G, V> p[UNSCALE_UNROLL];
#pragma unroll
      for (int u = 0; u < UNSCALE_UNROLL; ++u)
        p[u] = *reinterpret_cast<const Pack<G, V>*>(w + i + u * STEP);
#pragma unroll
      for (int u = 0; u < UNSCALE_UNROLL; ++u) {
        bad |= unscale_pack<G, V>(p[u], inv);
        *reinterpret_cast<Pack<G, V>*>(w + i + u * STEP) = p[u];
      }
    }
    // the chunk's last vectors one at a time, its tail value by value
    for (; i < end; i += STEP) {
      if (i + V <= end) {
        bad |= unscale_at<G, V>(w, i, inv);
      } else {
        for (long long j = i; j < end; ++j) bad |= unscale_at<G, 1>(w, j, inv);
      }
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += THREADS)
      bad |= unscale_at<G, 1>(w, i, inv);
  }
  const bool any = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    const unsigned long long mine = 1ull + (any ? 1ull << 32 : 0ull);
    const unsigned long long before = atomicAdd(fold, mine);
    if ((unsigned)before == gridDim.x - 1) {  // the last block to finish
      *fold = 0ull;
      const bool seen = (before + mine) >> 32 != 0;
      *found = (unsigned char)((!first && *found) || seen);
    }
  }
}

}  // namespace

// The update pass of one group: `recs` (n Recs) and `prefix` (n + 1 chunk
// offsets, prefix[n] = nchunks) in device memory, `lr` the fp32 device
// scalar, `hyper` 8 floats on the host, `norms` 2n floats from mt_norms
// (LarsMomentum, Lamb; else unread).  kind: the Kind enum; types: 0 fp32,
// 1 bf16 over fp32 masters, 2 bf16, 3 fp16 over fp32 masters, 4 fp16.
// chunk: elements a block, a multiple of 2048.  skip: a bool in device
// memory (set: write nothing), or null.  Returns a cudaError_t (0 =
// launched).
extern "C" int mt_update(const void* recs, const int* prefix, int n,
                         int nchunks, int chunk, int kind, int types,
                         const float* lr, const float* hyper, int flags,
                         const float* norms, const void* skip,
                         void* stream) {
  cudaGetLastError();  // launch errors below are this call's own
  if (!shape_ok(n, nchunks, chunk)) return (int)cudaErrorInvalidValue;
  const Launch a = launch_args(recs, prefix, n, nchunks, chunk, lr, hyper,
                               flags, const_cast<float*>(norms), nullptr,
                               skip, stream);
  if (!update_kind(a, kind, types)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The rows pass of one group of row-sparse gradients (SGD, Adam and
// AdamW, the reference's SelectedRows updates): `recs` (n Recs, each `g`
// the merged values and `n` rows·D) and `aux` (n RowsAux) in device
// memory, `prefix` as mt_update's over the values' elements; the other
// arguments as mt_update's.  The powers are not advanced here: mt_pows
// does it over the same Recs after this launch.
extern "C" int mt_update_rows(const void* recs, const void* aux,
                              const int* prefix, int n, int nchunks,
                              int chunk, int kind, int types,
                              const float* lr, const float* hyper, int flags,
                              const void* skip, void* stream) {
  cudaGetLastError();
  if (!shape_ok(n, nchunks, chunk)) return (int)cudaErrorInvalidValue;
  const Launch a = launch_args(recs, prefix, n, nchunks, chunk, lr, hyper,
                               flags, nullptr, nullptr, skip, stream);
  const RowsAux* x = static_cast<const RowsAux*>(aux);
  bool ok = false;
  if (kind == SGD) ok = rows_types<SGD>(a, x, types);
  if (kind == ADAM) ok = rows_types<ADAM>(a, x, types);
  if (kind == ADAMW) ok = rows_types<ADAMW>(a, x, types);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The norms pass of LarsMomentum and Lamb (Lamb also stores its new
// moments): per chunk two partial sums of squares into `partials`
// (2·nchunks floats), then one block a tensor folds them into `norms`
// (2n floats).  Two launches; skip as mt_update's.
extern "C" int mt_norms(const void* recs, const int* prefix, int n,
                        int nchunks, int chunk, int kind, int types,
                        const float* hyper, int flags, float* partials,
                        float* norms, const void* skip, void* stream) {
  cudaGetLastError();
  if (!shape_ok(n, nchunks, chunk)) return (int)cudaErrorInvalidValue;
  const Launch a = launch_args(recs, prefix, n, nchunks, chunk, nullptr,
                               hyper, flags, norms, partials, skip, stream);
  bool ok = false;
  if (kind == LARS) ok = norms_types<LARS>(a, types);
  if (kind == LAMB) ok = norms_types<LAMB>(a, types);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Each tensor's beta powers advanced once: beta1_pow ·= b1, beta2_pow ·= b2
// (a null pointer in the Rec is left alone); skip as mt_update's.
extern "C" int mt_pows(const void* recs, int n, float b1, float b2,
                       const void* skip, void* stream) {
  cudaGetLastError();
  if (n <= 0) return (int)cudaErrorInvalidValue;
  mt_pows_kernel<<<(n + 127) / 128, 128, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Rec*>(recs), n, b1, b2,
      static_cast<const unsigned char*>(skip));
  return (int)cudaGetLastError();
}

// The unscale pass of one group of gradients: `recs` (n Recs whose `w` is
// the gradient) and `prefix` as mt_update's; dtype, the gradients' type: 0
// float32, 1 bfloat16, 2 float16; `scale` the fp32 device scalar of the
// loss scale; `found` a bool in device memory: with `first` it becomes
// whether an element of this group is not finite, else it is also set
// when one is (never cleared); `fold` one uint64 in device memory, zero
// before the first launch, left zero by every launch.  One launch, one
// block a chunk.
extern "C" int mt_unscale(const void* recs, const int* prefix, int n,
                          int nchunks, int chunk, int dtype,
                          const float* scale, void* found, void* fold,
                          int first, void* stream) {
  cudaGetLastError();
  if (!shape_ok(n, nchunks, chunk)) return (int)cudaErrorInvalidValue;
  const Rec* r = static_cast<const Rec*>(recs);
  unsigned char* f = static_cast<unsigned char*>(found);
  auto* w = static_cast<unsigned long long*>(fold);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      mt_unscale_kernel<float><<<nchunks, THREADS, 0, s>>>(
          r, prefix, n, chunk, scale, f, w, first);
      break;
    case 1:
      mt_unscale_kernel<__nv_bfloat16><<<nchunks, THREADS, 0, s>>>(
          r, prefix, n, chunk, scale, f, w, first);
      break;
    case 2:
      mt_unscale_kernel<__half><<<nchunks, THREADS, 0, s>>>(
          r, prefix, n, chunk, scale, f, w, first);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Where `p` lies and the address a kernel reads it at (the optimizer
// slots of an offloaded state are pinned host memory, read in place):
// `type` the cudaMemoryType (0 unregistered host, 1 host, 2 device, 3
// managed), `dev` the device pointer (null for unregistered memory).
extern "C" int mt_device_pointer(const void* p, int* type, void** dev) {
  cudaGetLastError();
  cudaPointerAttributes a;
  const cudaError_t e = cudaPointerGetAttributes(&a, p);
  if (e != cudaSuccess) return (int)e;
  *type = (int)a.type;
  *dev = a.devicePointer;
  return 0;
}

extern "C" const char* multi_tensor_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
