"""The eager core's op table: one case per ported tensor function,
method and operator, with seeded numpy inputs, the keywords, the inputs
whose gradients are compared and the tolerance class (``"ew"``:
elementwise and shape ops, ``"red"``: products and reductions).

A case's callable comes from a package (:meth:`Case.fn`), so one table
holds the port against the reference in the CPU tests
(``tests/test_torch_ops_parity.py``) and the port on the card against
the port on the CPU (``chip_smoke.py`` phase 20d).  It imports numpy
only.
"""
import numpy as np

rs = np.random.RandomState(0)
f32 = np.float32
A = rs.randn(3, 4).astype(f32)
B = rs.randn(3, 4).astype(f32)
P = (rs.rand(3, 4) + 0.5).astype(f32)
U = rs.uniform(-0.9, 0.9, (3, 4)).astype(f32)
Q = rs.uniform(0.1, 0.9, (3, 4)).astype(f32)
G = (rs.rand(3, 4) * 2 + 1.1).astype(f32)
I = rs.randint(0, 5, (3, 4)).astype(np.int64)          # noqa: E741
J = rs.randint(1, 5, (3, 4)).astype(np.int64)
M = rs.rand(3, 4) > 0.5
M2 = rs.rand(3, 4) > 0.5
V = rs.randn(4).astype(f32)
V2 = rs.randn(3).astype(f32)
W = rs.randn(4, 5).astype(f32)
S3 = rs.randn(2, 3, 4).astype(f32)
S4 = rs.randn(2, 4, 3, 3).astype(f32)
SQ = rs.randn(4, 4).astype(f32)
N = A.copy()
N[0, 0], N[1, 2], N[2, 3] = np.nan, np.inf, -np.inf
IDX = np.array([2, 0, 3], np.int64)
ROWS = np.array([2, 0], np.int64)
TAKE = np.array([[0, 3], [1, 1], [2, 0]], np.int64)
TAKE_UNIQUE = np.array([[0, 3], [1, 2], [2, 0]], np.int64)
SORTED = np.array([0.1, 0.5, 0.9, 1.3], f32)
VALS = np.array([0.05, 0.7, 1.0, 2.0], f32)
LBL = rs.randint(0, 4, (3, 1)).astype(np.int64)
SOFT = np.abs(rs.randn(3, 4)).astype(f32)
SOFT = SOFT / SOFT.sum(1, keepdims=True)
QKV = [rs.randn(2, 8, 2, 16).astype(f32) for _ in range(3)]
MASK = np.where(rs.rand(2, 2, 8, 8) > 0.3, 0.0, -1e4).astype(f32)


class Case:
    def __init__(self, kind, name, *args, grad=(), tol="ew", kw=None,
                 label=""):
        self.kind, self.name, self.args = kind, name, args
        self.grad, self.tol, self.kw = grad, tol, kw or {}
        self.id = f"{kind}:{name}{':' + label if label else ''}"

    def fn(self, m):
        """The case's callable in the package ``m`` (the reference's
        ``paddle_tpu`` or the port): a tensor function, an
        ``nn.functional`` function, a method, or an expression."""
        if self.kind == "fn":
            return getattr(m, self.name)
        if self.kind == "F":
            return getattr(m.nn.functional, self.name)
        if self.kind == "method":
            name = self.name

            def call(x, *rest, **kw):
                return getattr(x, name)(*rest, **kw)
            return call
        return self.name(m)


def fn(name, *args, **k):
    return Case("fn", name, *args, **k)


def nf(name, *args, **k):
    return Case("F", name, *args, **k)


def lam(label, f, *args, **k):
    c = Case("op", f, *args, **k)
    c.id = f"op:{label}"
    return c


# -- math --------------------------------------------------------------------
CASES = [fn(n, x, grad=(0,), label=lbl) for n, x, lbl in [
    ("abs", A, ""), ("neg", A, ""), ("sign", A, ""), ("sqrt", P, ""),
    ("rsqrt", P, ""), ("square", A, ""), ("exp", A, ""), ("expm1", A, ""),
    ("log", P, ""), ("log2", P, ""), ("log10", P, ""), ("log1p", P, ""),
    ("floor", A, ""), ("ceil", A, ""), ("round", A, ""), ("trunc", A, ""),
    ("sin", A, ""), ("cos", A, ""), ("tan", U, ""), ("asin", U, ""),
    ("acos", U, ""), ("atan", A, ""), ("sinh", A, ""), ("cosh", A, ""),
    ("tanh", A, ""), ("asinh", A, ""), ("acosh", G, ""), ("atanh", U, ""),
    ("erf", A, ""), ("erfinv", U, ""), ("digamma", P, ""),
    ("lgamma", P, ""), ("rad2deg", A, ""), ("deg2rad", A, ""),
    ("frac", A, ""), ("reciprocal", P, ""), ("conj", A, ""),
    ("real", A, ""), ("imag", A, "")]]
CASES += [fn(n, I, label="int") for n in (
    "abs", "neg", "square", "floor", "sqrt", "exp", "reciprocal")]
CASES += [fn("angle", A)]
CASES += [fn(n, x, y, grad=g, label=lbl) for n, x, y, g, lbl in [
    ("add", A, B, (0, 1), ""), ("subtract", A, B, (0, 1), ""),
    ("multiply", A, B, (0, 1), ""), ("divide", A, P, (0, 1), ""),
    ("floor_divide", A, P, (), ""), ("remainder", A, P, (0, 1), ""),
    ("mod", A, P, (0, 1), ""), ("pow", P, A, (0, 1), ""),
    ("matpow", P, A, (0, 1), ""), ("maximum", A, B, (0, 1), ""),
    ("minimum", A, B, (0, 1), ""), ("fmax", A, B, (0, 1), ""),
    ("fmin", A, B, (0, 1), ""), ("atan2", A, B, (0, 1), ""),
    ("heaviside", A, B, (), ""), ("logaddexp", A, B, (0, 1), ""),
    ("add", A, 2.5, (0,), "scalar"), ("subtract", 2.0, A, (1,), "lscalar"),
    ("add", I, 2, (), "int_scalar"), ("multiply", I, 0.5, (), "int_float"),
    ("divide", I, J, (), "int_int"), ("floor_divide", I, J, (), "int_int"),
    ("remainder", I, J, (), "int_int"), ("pow", I, 2, (), "int_int"),
    ("add", M, I, (), "bool_int"), ("multiply", I, A, (1,), "int_float_t"),
    ("kron", A[:2, :2], B[:2, :3], (0, 1), ""),
    ("outer", V, V2, (0, 1), ""), ("inner", A, B, (0, 1), "")]]
CASES += [
    fn("clip", A, grad=(0,), kw=dict(min=-0.5, max=0.5)),
    fn("clip", I, kw=dict(min=1, max=3), label="int"),
    fn("clip", A, grad=(0,), kw=dict(min=0.1), label="min_only"),
    fn("scale", A, grad=(0,), kw=dict(scale=2.0, bias=1.0)),
    fn("scale", A, grad=(0,), kw=dict(scale=2.0, bias=1.0,
                                       bias_after_scale=False),
       label="before"),
    fn("scale", I, kw=dict(scale=0.5), label="int"),
    fn("lerp", A, B, 0.3, grad=(0, 1)),
    fn("lerp", A, B, Q, grad=(0, 1, 2), label="tensor_weight"),
    fn("addmm", SQ[:3, :4] * 0 + A, A, W[:, :4], grad=(0, 1, 2), tol="red",
       kw=dict(beta=0.5, alpha=2.0)),
    fn("stanh", A, grad=(0,)),
    fn("logit", Q, grad=(0,)),
    fn("logit", Q, grad=(0,), kw=dict(eps=0.2), label="eps"),
    fn("nan_to_num", N),
    fn("nan_to_num", N, kw=dict(nan=1.0, posinf=9.0, neginf=-9.0),
       label="values"),
    fn("trace", SQ, grad=(0,), tol="red"),
    fn("trace", SQ, grad=(0,), tol="red", kw=dict(offset=1), label="off"),
    fn("diff", A, grad=(0,)),
    fn("diff", A, grad=(0,), kw=dict(n=2, axis=0), label="n2"),
]
CASES += [fn(n, A, B, label="inplace") for n in ("add_", "subtract_",
                                                 "multiply_")]
CASES += [fn("clip_", A, kw=dict(min=-0.2, max=0.3), label="inplace")]

# -- reductions --------------------------------------------------------------
R = dict(tol="red")
CASES += [
    fn("sum", A, grad=(0,), **R), fn("sum", A, grad=(0,), kw=dict(axis=1),
                                     label="ax1", **R),
    fn("sum", A, grad=(0,), kw=dict(axis=[0, 1], keepdim=True),
       label="keep", **R),
    fn("sum", I, label="int", **R), fn("sum", M, label="bool", **R),
    fn("sum", A, kw=dict(axis=0, dtype="float16"), label="dtype", **R),
    fn("mean", A, grad=(0,), kw=dict(axis=0), **R),
    fn("mean", I, label="int", **R),
    fn("max", A, grad=(0,), kw=dict(axis=1), **R),
    fn("min", A, grad=(0,), kw=dict(axis=0, keepdim=True), **R),
    fn("amax", A, grad=(0,), **R), fn("amin", A, grad=(0,), kw=dict(axis=1),
                                      **R),
    fn("prod", P, grad=(0,), kw=dict(axis=1), **R),
    fn("prod", P, grad=(0,), label="all", **R),
    fn("prod", S3 + 2, grad=(0,), kw=dict(axis=[0, 2]), label="tuple", **R),
    fn("prod", I, kw=dict(axis=1), label="int", **R),
    fn("nansum", N[:, :2], kw=dict(axis=1), **R),
    fn("nanmean", np.where(np.isfinite(N), N, np.nan).astype(f32),
       kw=dict(axis=1), **R),
    fn("all", M, kw=dict(axis=1)), fn("any", M), fn("all", I, label="int"),
    fn("argmax", A, kw=dict(axis=1)), fn("argmax", A, label="flat"),
    fn("argmin", A, kw=dict(axis=0, keepdim=True)),
    fn("cumsum", A, grad=(0,), kw=dict(axis=1), **R),
    fn("cumsum", A, grad=(0,), label="flat", **R),
    fn("cumsum", I, kw=dict(axis=1), label="int", **R),
    fn("cumprod", P, grad=(0,), kw=dict(dim=1), **R),
    fn("logsumexp", A, grad=(0,), kw=dict(axis=1), **R),
    fn("logsumexp", A, grad=(0,), label="all", **R),
    fn("count_nonzero", I, kw=dict(axis=1)),
    fn("count_nonzero", I, kw=dict(axis=0, keepdim=True), label="keep"),
    fn("median", A, grad=(0,), kw=dict(axis=1), **R),
    fn("median", A, grad=(0,), label="flat_even", **R),
    fn("median", A[:, :3], grad=(0,), kw=dict(axis=1, keepdim=True),
       label="odd", **R),
    fn("quantile", A, grad=(0,), kw=dict(q=0.3, axis=1), **R),
    fn("std", A, grad=(0,), kw=dict(axis=1), **R),
    fn("std", A, grad=(0,), kw=dict(unbiased=False), label="biased", **R),
    fn("var", A, grad=(0,), kw=dict(axis=0, keepdim=True), **R),
    fn("kthvalue", A, kw=dict(k=2), **R),
    fn("kthvalue", A, kw=dict(k=1, axis=0, keepdim=True), label="ax0", **R),
    fn("mode", I), fn("mode", I, kw=dict(axis=0, keepdim=True),
                      label="ax0"),
]

# -- logic -------------------------------------------------------------------
CASES += [fn(n, x, y, label=lbl) for n, x, y, lbl in [
    ("equal", A, B, ""), ("equal", I, 2, "scalar"),
    ("equal", I, 2.5, "scalar_cast"), ("not_equal", I, J, ""),
    ("greater_than", A, 0.0, ""), ("greater_equal", I, J, ""),
    ("less_than", A, B, ""), ("less_equal", I, 2, ""),
    ("equal_all", A, A, ""), ("equal_all", A, B, "diff"),
    ("allclose", A, A + 1e-7, ""), ("isclose", A, B, ""),
    ("logical_and", M, M2, ""), ("logical_or", M, M2, ""),
    ("logical_xor", M, M2, ""), ("bitwise_and", I, J, ""),
    ("bitwise_or", I, J, ""), ("bitwise_xor", I, J, "")]]
CASES += [fn(n, x, label=lbl) for n, x, lbl in [
    ("logical_not", M, ""), ("bitwise_not", I, ""), ("isnan", N, ""),
    ("isinf", N, ""), ("isfinite", N, ""), ("is_empty", A, ""),
    ("is_empty", A[:0], "empty")]]

# -- manipulation ------------------------------------------------------------
CASES += [
    fn("reshape", A, grad=(0,), kw=dict(shape=[4, 3])),
    fn("reshape", A, grad=(0,), kw=dict(shape=[-1]), label="flat"),
    fn("transpose", S3, grad=(0,), kw=dict(perm=[2, 0, 1])),
    lam("concat", (lambda m: lambda x, y: m.concat([x, y], axis=1)), A, B,
        grad=(0, 1)),
    lam("concat_promote",
        (lambda m: lambda x, y: m.concat([x, y], axis=0)), A, I),
    lam("stack", (lambda m: lambda x, y: m.stack([x, y], axis=1)), A, B,
        grad=(0, 1)),
    fn("split", A, grad=(0,), kw=dict(num_or_sections=2, axis=1)),
    fn("split", A, grad=(0,), kw=dict(num_or_sections=[1, -1], axis=1),
       label="sections"),
    fn("chunk", A, grad=(0,), kw=dict(chunks=3, axis=0)),
    fn("squeeze", S3[:, :1, :], grad=(0,)),
    fn("squeeze", S3[:, :1, :], grad=(0,), kw=dict(axis=[1, 2]),
       label="axes"),
    fn("squeeze", A, grad=(0,), kw=dict(axis=0), label="noop"),
    fn("unsqueeze", A, grad=(0,), kw=dict(axis=[0, 2])),
    fn("unsqueeze", A, grad=(0,), kw=dict(axis=-1), label="neg"),
    fn("flatten", S3, grad=(0,), kw=dict(start_axis=1)),
    fn("expand", V, grad=(0,), kw=dict(shape=[3, 4])),
    fn("expand", A[:1], grad=(0,), kw=dict(shape=[3, -1]), label="keep"),
    fn("broadcast_to", V, grad=(0,), kw=dict(shape=[2, 4])),
    fn("expand_as", V, A, grad=(0,)),
    fn("tile", A, grad=(0,), kw=dict(repeat_times=[2, 1])),
    fn("tile", V, grad=(0,), kw=dict(repeat_times=[2, 2]), label="prepend"),
    fn("repeat_interleave", A, grad=(0,), kw=dict(repeats=2, axis=1)),
    fn("repeat_interleave", A, grad=(0,), kw=dict(repeats=2),
       label="flat"),
    fn("gather", A, IDX, grad=(0,), kw=dict(axis=1)),
    fn("gather", A, ROWS, grad=(0,), label="rows"),
    fn("gather_nd", A, TAKE[:, :2] % np.array([3, 4]), grad=(0,)),
    fn("scatter", A, ROWS, B[:2], grad=(0, 2)),
    fn("scatter", A, ROWS, B[:2], grad=(0, 2), kw=dict(overwrite=False),
       label="add"),
    fn("scatter_nd_add", A, np.array([[0, 1], [2, 3]], np.int64),
       np.array([1.0, 2.0], f32), grad=(0, 2)),
    fn("take_along_axis", A, TAKE, grad=(0,), kw=dict(axis=1)),
    # with duplicate indices, which assigned value wins is unspecified (as
    # in XLA's scatter); the add mode below takes them
    fn("put_along_axis", A, TAKE_UNIQUE, B[:, :2], grad=(0,),
       kw=dict(axis=1)),
    fn("put_along_axis", A, TAKE[:, :1], 1.5, grad=(0,),
       kw=dict(axis=1, reduce="add"), label="add"),
    fn("index_select", A, IDX, grad=(0,), kw=dict(axis=1)),
    fn("index_sample", A, TAKE, grad=(0,)),
    fn("masked_select", A, M),
    fn("slice", A, grad=(0,), kw=dict(axes=[0, 1], starts=[0, 1],
                                      ends=[2, 9])),
    fn("strided_slice", A, grad=(0,), kw=dict(axes=[1], starts=[3],
                                              ends=[0], strides=[-1])),
    fn("strided_slice", A, grad=(0,), kw=dict(axes=[0, 1], starts=[0, 0],
                                              ends=[3, 4], strides=[2, 3]),
       label="pos"),
    fn("flip", A, grad=(0,), kw=dict(axis=[0, 1])),
    fn("roll", A, grad=(0,), kw=dict(shifts=1, axis=1)),
    fn("roll", A, grad=(0,), kw=dict(shifts=2), label="flat"),
    fn("rot90", A, grad=(0,)),
    fn("unbind", A, grad=(0,), kw=dict(axis=1)),
    fn("unstack", A, grad=(0,)),
    fn("topk", A, grad=(0,), kw=dict(k=2)),
    fn("topk", A, grad=(0,), kw=dict(k=2, axis=0, largest=False),
       label="smallest"),
    fn("sort", A, grad=(0,), kw=dict(axis=1)),
    fn("sort", A, grad=(0,), kw=dict(axis=0, descending=True), label="desc"),
    fn("argsort", A, kw=dict(axis=1)),
    fn("argsort", I, kw=dict(axis=1, descending=True), label="ties_desc"),
    fn("unique", I),
    fn("unique", I, kw=dict(return_index=True, return_inverse=True,
                            return_counts=True), label="all"),
    fn("unique_consecutive", np.array([1, 1, 2, 2, 3, 1, 1], np.int64),
       kw=dict(return_inverse=True, return_counts=True)),
    fn("nonzero", M), fn("nonzero", M, kw=dict(as_tuple=True),
                         label="tuple"),
    fn("where", M, A, B, grad=(1, 2)),
    fn("where", M, label="nonzero"),
    fn("pad", A, grad=(0,), kw=dict(pad=[1, 1, 2, 0])),
    fn("pad", S4, grad=(0,), kw=dict(pad=[1, 2, 1, 0], mode="reflect"),
       label="reflect"),
    fn("pad", S4, grad=(0,), kw=dict(pad=[2, 1, 0, 1], mode="replicate"),
       label="replicate"),
    fn("pad", S4, grad=(0,), kw=dict(pad=[1, 2, 1, 1], mode="circular"),
       label="circular"),
    fn("pad", S4, grad=(0,), kw=dict(pad=[1, 1], value=0.5),
       label="partial"),
    fn("crop", A, grad=(0,), kw=dict(shape=[2, -1], offsets=[1, 1])),
    fn("shard_index", I, kw=dict(index_num=6, nshards=2, shard_id=1)),
    fn("as_complex", S3[..., :2]),
    fn("tensordot", S3, W, grad=(0, 1), tol="red", kw=dict(axes=1)),
    fn("searchsorted", SORTED, VALS),
    fn("searchsorted", SORTED, VALS, kw=dict(right=True), label="right"),
    fn("bincount", np.array([0, 1, 1, 3, 3, 3], np.int64)),
    fn("bincount", np.array([0, 1, 1, 3], np.int64),
       np.array([0.5, 1.0, 1.5, 2.0], f32), kw=dict(minlength=6),
       label="weights"),
    fn("cast", A, grad=(0,), kw=dict(dtype="float16")),
    fn("cast", A, kw=dict(dtype="int32"), label="int"),
    fn("cast", I, kw=dict(dtype="int64"), label="int64"),
    fn("moveaxis", S3, grad=(0,), kw=dict(source=0, destination=2)),
    fn("swapaxes", S3, grad=(0,), kw=dict(axis1=0, axis2=2)),
]
CASES += [lam("as_real", lambda m: lambda x: m.as_real(m.as_complex(x)),
              S3[..., :2])]

# -- activations -------------------------------------------------------------
CASES += [fn(n, A, grad=(0,), kw=kw, label=lbl) for n, kw, lbl in [
    ("relu", {}, ""), ("relu6", {}, ""), ("sigmoid", {}, ""),
    ("silu", {}, ""), ("swish", {}, ""), ("hardswish", {}, ""),
    ("hardsigmoid", {}, ""), ("hardtanh", {}, ""), ("hardshrink", {}, ""),
    ("softshrink", {}, ""), ("tanhshrink", {}, ""), ("leaky_relu", {}, ""),
    ("leaky_relu", dict(negative_slope=0.2), "slope"), ("elu", {}, ""),
    ("celu", dict(alpha=0.5), ""), ("selu", {}, ""), ("softplus", {}, ""),
    ("softplus", dict(beta=2, threshold=1), "beta"), ("softsign", {}, ""),
    ("mish", {}, ""), ("thresholded_relu", dict(threshold=0.5), ""),
    ("log_sigmoid", {}, ""), ("gelu", {}, ""),
    ("gelu", dict(approximate=True), "tanh"),
    ("softmax", dict(axis=1), ""), ("softmax", dict(axis=0), "ax0"),
    ("log_softmax", dict(axis=1), ""),
    ("temperature_softmax", dict(temperature=2.0), ""),
    ("glu", dict(axis=1), ""), ("rrelu", {}, "eval")]]
CASES += [
    fn("prelu", S4, np.array([0.25, 0.1, 0.3, 0.2], f32), grad=(0, 1)),
    fn("prelu", A, np.array([0.2], f32), grad=(0, 1), label="shared"),
    fn("maxout", S4, grad=(0,), kw=dict(groups=2, axis=1)),
    fn("relu_", A, label="inplace"),
    fn("softmax", A, grad=(0,), kw=dict(axis=1, dtype="float32"),
       label="dtype"),
]

# -- normalization -----------------------------------------------------------
LN_W, LN_B = rs.randn(4).astype(f32), rs.randn(4).astype(f32)
CASES += [
    lam("layer_norm", lambda m: lambda x, w, b: m.layer_norm(x, 4, w, b),
        S3, LN_W, LN_B, grad=(0, 1, 2), tol="red"),
    fn("layer_norm", S3, grad=(0,), tol="red",
       kw=dict(normalized_shape=[3, 4]), label="2d_noaffine"),
    fn("rms_norm", S3, LN_W, grad=(0, 1), tol="red"),
    fn("instance_norm", S4, LN_W, LN_B, grad=(0, 1, 2), tol="red",
       kw=dict(weight=None) if False else {}, label="noaffine"),
    fn("group_norm", S4, grad=(0,), tol="red", kw=dict(num_groups=2)),
    lam("group_norm_affine", lambda m: lambda x, w, b: m.group_norm(
        x, 2, weight=w, bias=b), S4, LN_W, LN_B, grad=(0, 1, 2), tol="red"),
    lam("instance_norm_affine", lambda m: lambda x, w, b: m.instance_norm(
        x, weight=w, bias=b), S4, LN_W, LN_B, grad=(0, 1, 2), tol="red"),
    fn("local_response_norm", S4, grad=(0,), tol="red", kw=dict(size=3)),
    fn("normalize", A, grad=(0,), tol="red"),
    fn("normalize", A, grad=(0,), tol="red", kw=dict(p=1, axis=0),
       label="p1"),
    lam("batch_norm_eval", lambda m: lambda x, w, b: m.batch_norm(
        x, m.to_tensor(np.zeros(4, f32)), m.to_tensor(np.ones(4, f32)), w,
        b), S4, LN_W, LN_B, grad=(0, 1, 2), tol="red"),
    lam("batch_norm_train", lambda m: lambda x, w, b: m.batch_norm(
        x, m.to_tensor(np.zeros(4, f32)), m.to_tensor(np.ones(4, f32)), w,
        b, training=True), S4, LN_W, LN_B, grad=(0, 1, 2), tol="red"),
]
# instance_norm's positional signature puts running stats first
CASES = [c for c in CASES if c.id != "fn:instance_norm:noaffine"]
CASES += [fn("instance_norm", S4, grad=(0,), tol="red", label="noaffine")]

# -- products ----------------------------------------------------------------
CASES += [
    fn("matmul", A, W, grad=(0, 1), tol="red"),
    fn("matmul", A, B, grad=(0, 1), tol="red",
       kw=dict(transpose_y=True), label="ty"),
    fn("matmul", A, B, grad=(0, 1), tol="red",
       kw=dict(transpose_x=True), label="tx"),
    fn("matmul", S3, W, grad=(0, 1), tol="red", label="batched"),
    fn("matmul", A, V, grad=(0, 1), tol="red", label="vec"),
    fn("matmul", I, J.T, tol="red", label="int"),
    fn("mm", A, W, grad=(0, 1), tol="red"),
    fn("bmm", S3, np.stack([W, W]), grad=(0, 1), tol="red"),
    fn("mv", A, V, grad=(0, 1), tol="red"),
    fn("dot", A, B, grad=(0, 1), tol="red"),
    fn("dot", I, J, tol="red", label="int"),
    fn("t", A, grad=(0,)), fn("transpose_matmul", A, grad=(0,)),
    fn("norm", A, grad=(0,), tol="red"),
    fn("norm", A, grad=(0,), tol="red", kw=dict(axis=1), label="p2ax"),
    fn("norm", A, grad=(0,), tol="red", kw=dict(p=1, axis=0), label="p1"),
    fn("norm", A, grad=(0,), tol="red", kw=dict(p=float("inf"), axis=1),
       label="inf"),
    fn("norm", A, tol="red", kw=dict(p=0, axis=1), label="p0"),
    fn("norm", S3, grad=(0,), tol="red", kw=dict(axis=[1, 2],
                                                 keepdim=True),
       label="fro_axes"),
    fn("dist", A, B, grad=(0, 1), tol="red"),
    fn("dist", A, B, grad=(0, 1), tol="red", kw=dict(p=1), label="p1"),
    fn("dist", A, B, grad=(0, 1), tol="red", kw=dict(p=float("inf")),
       label="inf"),
]

# -- nn functional -----------------------------------------------------------
EMB = rs.randn(6, 3).astype(f32)
BIL_W = rs.randn(2, 4, 4).astype(f32)
CASES += [
    nf("linear", S3, W, rs.randn(5).astype(f32), grad=(0, 1, 2), tol="red"),
    nf("linear", A, W, grad=(0, 1), tol="red", label="nobias"),
    nf("embedding", I, EMB, grad=(1,)),
    nf("embedding", I, EMB, grad=(1,), kw=dict(padding_idx=2),
       label="pad"),
    nf("dropout", A, grad=(0,), kw=dict(p=0.5, training=False),
       label="eval"),
    nf("dropout", A, grad=(0,), kw=dict(p=0.3, training=False,
                                        mode="downscale_in_infer"),
       label="downscale"),
    nf("dropout", A, grad=(0,), kw=dict(p=0.0), label="p0"),
    nf("dropout2d", S4, kw=dict(training=False)),
    nf("dropout3d", S4[None], kw=dict(training=False)),
    nf("alpha_dropout", A, kw=dict(training=False)),
    nf("bilinear", A, B, BIL_W, rs.randn(2).astype(f32), grad=(0, 1, 2, 3),
       tol="red"),
    nf("cosine_similarity", A, B, grad=(0, 1), tol="red"),
    nf("pairwise_distance", A, B, grad=(0, 1), tol="red"),
    nf("scaled_dot_product_attention", *QKV, grad=(0, 1, 2), tol="red"),
    nf("scaled_dot_product_attention", *QKV, grad=(0, 1, 2), tol="red",
       kw=dict(is_causal=True), label="causal"),
    nf("scaled_dot_product_attention", *QKV, MASK, grad=(0, 1, 2),
       tol="red", label="mask"),
    nf("cross_entropy", A, LBL, grad=(0,), tol="red"),
    nf("cross_entropy", A, LBL[:, 0], grad=(0,), tol="red",
       kw=dict(reduction="none"), label="flat_none"),
    nf("cross_entropy", A, SOFT, grad=(0,), tol="red",
       kw=dict(soft_label=True), label="soft"),
    nf("cross_entropy", A, LBL, rs.rand(4).astype(f32) + 0.5, grad=(0,),
       tol="red", label="weight"),
    nf("cross_entropy", A, np.array([[0], [-100], [3]], np.int64),
       grad=(0,), tol="red", label="ignore"),
    nf("cross_entropy", A, LBL, grad=(0,), tol="red",
       kw=dict(label_smoothing=0.1, reduction="sum"), label="smooth"),
    nf("softmax_with_cross_entropy", A, LBL, grad=(0,), tol="red"),
    nf("softmax_with_cross_entropy", A, SOFT, grad=(0,), tol="red",
       kw=dict(soft_label=True, return_softmax=True), label="soft"),
    nf("pad", A, grad=(0,), kw=dict(pad=[0, 1, 1, 0])),
    lam("elu_", lambda m: lambda x: m.nn.functional.elu_(x * 1.0), A),
    lam("softmax_", lambda m: lambda x: m.nn.functional.softmax_(x * 1.0),
        A),
]

# -- the rest of the losses and of nn_misc, and extras ------------------------
LOGP = (A - np.log(np.exp(A).sum(1, keepdims=True))).astype(f32)
PR = (np.exp(LOGP)).astype(f32)
SIGN = np.array([1., -1., 1.], f32)
IDS4 = LBL[:, 0]
CTC = (rs.randn(6, 2, 4).astype(f32), np.array([[1, 2], [3, 3]], np.int32),
       np.array([6, 5], np.int32), np.array([2, 2], np.int32))
HS = (rs.randn(3, 5).astype(f32), np.array([[0], [3], [2]], np.int64), 4,
      rs.randn(3, 5).astype(f32), rs.randn(3).astype(f32))
NCE_W = rs.randn(10, 4).astype(f32)
CSR = (np.array([0, 1, 3, 4, 6, 8, 10, 11, 12], np.int32),
       np.array([0, 0, 1, 2, 2, 3, 3, 4, 4, 5, 6, 7], np.int32))
CASES += [
    nf("one_hot", IDS4, kw=dict(num_classes=4)),
    nf("mse_loss", A, B, grad=(0, 1), tol="red"),
    nf("square_error_cost", A, B, grad=(0, 1)),
    nf("l1_loss", A, B, grad=(0,), tol="red", kw=dict(reduction="sum")),
    nf("nll_loss", LOGP, IDS4, rs.rand(4).astype(f32) + 0.5, grad=(0,),
       tol="red"),
    nf("binary_cross_entropy", Q, PR, grad=(0,), tol="red"),
    nf("binary_cross_entropy_with_logits", A, Q, grad=(0,), tol="red"),
    nf("kl_div", LOGP, PR, grad=(0,), tol="red",
       kw=dict(reduction="batchmean")),
    nf("smooth_l1_loss", A, B, grad=(0,), tol="red", kw=dict(delta=0.5)),
    nf("huber_loss", A, B, grad=(0,), tol="red", kw=dict(delta=0.5)),
    nf("margin_ranking_loss", V2, V2[::-1].copy(), SIGN, grad=(0, 1),
       tol="red", kw=dict(margin=0.1)),
    nf("hinge_embedding_loss", V2, SIGN, grad=(0,), tol="red"),
    nf("cosine_embedding_loss", A, B, SIGN, grad=(0, 1), tol="red"),
    nf("triplet_margin_loss", A, B, P, grad=(0, 1, 2), tol="red"),
    nf("label_smooth", SOFT, grad=(0,), kw=dict(epsilon=0.2)),
    nf("sigmoid_focal_loss", A, np.round(Q), grad=(0,), tol="red"),
    nf("log_loss", Q, np.round(PR), grad=(0,)),
    nf("ctc_loss", *CTC, grad=(0,), tol="red"),
    nf("dice_loss", PR[None], LBL[None], grad=(0,), tol="red"),
    nf("hsigmoid_loss", *HS, grad=(0, 3, 4), tol="red"),
    nf("margin_cross_entropy", U, IDS4, grad=(0,), tol="red",
       kw=dict(scale=4.0)),
    nf("sequence_mask", np.array([1, 3, 0], np.int32)),
    nf("diag_embed", A, grad=(0,), kw=dict(offset=1)),
    nf("affine_channel", S4, V, V[::-1].copy(), grad=(0, 1, 2)),
    nf("npair_loss", A, B, np.array([0, 1, 0], np.int64), grad=(0, 1),
       tol="red"),
    nf("temporal_shift", S4, grad=(0,), kw=dict(seg_num=2)),
    nf("sparse_attention", *[x.transpose(0, 2, 1, 3).copy()
                             for x in QKV], *CSR, grad=(0, 1, 2), tol="red"),
    nf("nce", A, I[:, :1], NCE_W, grad=(0, 2), tol="red",
       kw=dict(num_total_classes=10, num_neg_samples=3, seed=5)),
    fn("add_n", [A, B], label="list"),
    lam("add_n", lambda m: lambda x, y: m.add_n([x, y]), A, B,
        grad=(0, 1)),
    lam("broadcast_tensors", lambda m: lambda x, y: m.broadcast_tensors(
        [x, y]), A[:, :1], V[None], grad=(0, 1)),
    fn("diagflat", V, grad=(0,), kw=dict(offset=-1)),
    fn("diagonal", S3, grad=(0,), kw=dict(axis1=1, axis2=2)),
    fn("floor_mod", I, J),
    lam("multiplex", lambda m: lambda x, y, i: m.multiplex([x, y], i), A, B,
        np.array([[1], [0], [1]], np.int32), grad=(0, 1)),
    fn("scatter_nd", np.array([[1], [0], [1]], np.int32), A, [3, 4],
       grad=(1,), label="rows"),
    fn("rank", S3), fn("shape", S3),
]

# -- creation ----------------------------------------------------------------
CASES += [
    fn("zeros", [2, 3]), fn("zeros", [2, 3], kw=dict(dtype="int64"),
                            label="int"),
    fn("ones", [2], kw=dict(dtype="bool"), label="bool"), fn("ones", 3),
    fn("full", [2, 2], 1.5), fn("full", [2], 3, kw=dict(dtype="int32"),
                                label="int"),
    fn("empty", [2, 3]), fn("zeros_like", A), fn("ones_like", I),
    fn("full_like", A, 2.0), fn("full_like", I, 7, label="int"),
    fn("empty_like", A), fn("arange", 5), fn("arange", 0, 1, 0.25,
                                             label="float"),
    fn("arange", 1, 7, 2, kw=dict(dtype="float32"), label="dtype"),
    fn("linspace", 0, 1, 5), fn("eye", 3), fn("eye", 2, 3, label="rect"),
    fn("assign", A, grad=(0,)), fn("clone", A, grad=(0,)),
    fn("diag", V), fn("diag", SQ, label="2d"),
    fn("diag", V, kw=dict(offset=1, padding_value=2.0), label="pad"),
    fn("tril", A, grad=(0,)), fn("triu", A, grad=(0,), kw=dict(diagonal=1)),
    lam("meshgrid", lambda m: lambda x, y: m.meshgrid(x, y), V, V2),
    fn("numel", A),
]

# -- the method surface (the reference's ``_attach``) ------------------------
METHODS = {
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "abs", "neg", "sqrt", "rsqrt", "square", "exp",
    "log", "sign", "floor", "ceil", "round", "sin", "cos", "tan", "tanh",
    "clip", "scale", "reciprocal", "maximum", "minimum", "erf", "lerp",
    "trunc", "frac", "add_", "subtract_", "multiply_", "clip_", "sum",
    "mean", "max", "min", "prod", "all", "any", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "std", "var", "median", "reshape",
    "transpose", "squeeze", "unsqueeze", "flatten", "expand", "expand_as",
    "tile", "broadcast_to", "gather", "gather_nd", "scatter", "split",
    "chunk", "unbind", "flip", "roll", "topk", "sort", "argsort", "unique",
    "nonzero", "index_select", "masked_select", "take_along_axis",
    "put_along_axis", "moveaxis", "repeat_interleave", "equal", "not_equal",
    "greater_than", "greater_equal", "less_than", "less_equal",
    "logical_and", "logical_or", "logical_not", "logical_xor", "allclose",
    "isclose", "isnan", "isinf", "isfinite", "equal_all", "matmul", "mm",
    "bmm", "dot", "norm", "dist", "sigmoid", "softmax", "relu"}
_method_cases = []
for c in list(CASES):
    if c.kind == "fn" and c.name in METHODS and isinstance(
            c.args[0], np.ndarray) and c.name not in {
            m.name for m in _method_cases}:
        mc = Case("method", c.name, *c.args, grad=c.grad, tol=c.tol,
                  kw=c.kw)
        _method_cases.append(mc)
CASES += _method_cases
CASES += [Case("method", "reshape_", A, kw=dict(shape=[2, 6])),
          Case("method", "cast", A, kw=dict(dtype="int32")),
          Case("method", "astype", A, grad=(0,), kw=dict(dtype="float16")),
          Case("method", "clone", A,
                                               grad=(0,))]

# -- operators ---------------------------------------------------------------
OPS = [
    ("add", lambda m: lambda x, y: x + y, A, B, (0, 1)),
    ("radd", lambda m: lambda x: 2.0 + x, A, None, (0,)),
    ("sub", lambda m: lambda x, y: x - y, A, B, (0, 1)),
    ("rsub", lambda m: lambda x: 2.0 - x, A, None, (0,)),
    ("mul", lambda m: lambda x, y: x * y, A, B, (0, 1)),
    ("rmul", lambda m: lambda x: 3 * x, I, None, ()),
    ("truediv", lambda m: lambda x, y: x / y, A, P, (0, 1)),
    ("rtruediv", lambda m: lambda x: 1.0 / x, P, None, (0,)),
    ("int_truediv", lambda m: lambda x: x / 2, I, None, ()),
    ("floordiv", lambda m: lambda x, y: x // y, I, J, ()),
    ("mod", lambda m: lambda x: x % 3, I, None, ()),
    ("pow", lambda m: lambda x: x ** 2, A, None, (0,)),
    ("rpow", lambda m: lambda x: 2.0 ** x, A, None, (0,)),
    ("neg", lambda m: lambda x: -x, A, None, (0,)),
    ("abs", lambda m: lambda x: abs(x), A, None, (0,)),
    ("matmul", lambda m: lambda x, y: x @ y, A, W, (0, 1)),
    ("eq", lambda m: lambda x, y: x == y, I, J, ()),
    ("ne", lambda m: lambda x: x != 2, I, None, ()),
    ("lt", lambda m: lambda x, y: x < y, A, B, ()),
    ("le", lambda m: lambda x: x <= 0.5, A, None, ()),
    ("gt", lambda m: lambda x, y: x > y, A, B, ()),
    ("ge", lambda m: lambda x: x >= 1, I, None, ()),
    ("invert", lambda m: lambda x: ~x, M, None, ()),
    ("and", lambda m: lambda x, y: x & y, M, M2, ()),
    ("or", lambda m: lambda x, y: x | y, I, J, ()),
    ("xor", lambda m: lambda x, y: x ^ y, M, M2, ()),
    ("getitem", lambda m: lambda x: x[1:, ::2], A, None, (0,)),
    ("getitem_neg_step", lambda m: lambda x: x[::-1, 2], A, None, (0,)),
    ("getitem_mask", lambda m: lambda x, k: x[k], A, M, (0,)),
    ("getitem_ints", lambda m: lambda x, i: x[i], A,
     np.array([2, 0], np.int64), (0,)),
    ("getitem_none_ellipsis", lambda m: lambda x: x[None, ..., 1], S3, None,
     (0,)),
    ("T", lambda m: lambda x: x.T, S3, None, (0,)),
    ("bf16_scalar", lambda m: lambda x: x.astype("bfloat16") * 1.5 + 2, A,
     None, ()),
    ("int_plus_float_tensor", lambda m: lambda x, y: x + y, I, A, (1,)),
]
CASES += [lam(n, f, *((x,) if y is None else (x, y)), grad=g)
          for n, f, x, y, g in OPS]


