"""The port's op-test harness (the counterpart of ``tests/op_test.py`` and
``tests/gradcheck.py``): the same numpy inputs through a function of the
reference (``paddle_tpu``) and its counterpart in the port
(``paddle_tpu_torch``), forward value and dtype compared, then the
gradient of every differentiable input under the same seeded cotangent;
and a central-difference check of the port's gradients alone.

Both packages run on the CPU: the tests set the port's place with
``paddle_tpu_torch.set_device("cpu")``.
"""
from __future__ import annotations

import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dtype import canonical_dtype as ref_dtype_name
from paddle_tpu_torch.core.dtype import canonical_dtype as port_dtype_name

# the satellite's bounds: elementwise and shape ops, then products and
# reductions (integer, bool and shape results are compared exactly)
TOL = {"ew": dict(rtol=1e-5, atol=1e-6), "red": dict(rtol=1e-4, atol=1e-5)}


def leaves(out):
    """The tensors of an op's result (a tensor, or a tuple / list)."""
    if isinstance(out, (tuple, list)):
        return [o for item in out for o in leaves(item)]
    return [out]


def to_ref(v, grad=False):
    if isinstance(v, np.ndarray):
        return ref.to_tensor(v, stop_gradient=not grad)
    return v


def to_port(v, grad=False):
    if isinstance(v, np.ndarray):
        return port.to_tensor(v, stop_gradient=not grad)
    return v


def _floating(dtype_name: str) -> bool:
    return dtype_name in ("float32", "float16", "bfloat16", "float64")


def assert_same(r, p, tol="ew", what=""):
    """A reference result and a port result: the same dtype name, the
    same shape, values within ``TOL[tol]`` (exact for non-floating)."""
    rl, pl = leaves(r), leaves(p)
    assert len(rl) == len(pl), f"{what}: {len(rl)} vs {len(pl)} outputs"
    for i, (a, b) in enumerate(zip(rl, pl)):
        rn, pn = ref_dtype_name(a.dtype), port_dtype_name(b.dtype)
        assert rn == pn, f"{what} output {i}: dtype {rn} vs {pn}"
        ra, pa = np.asarray(a.numpy()), np.asarray(b.numpy())
        assert ra.shape == pa.shape, f"{what} output {i}: {ra.shape} vs " \
                                     f"{pa.shape}"
        if _floating(rn):
            np.testing.assert_allclose(pa.astype(np.float64),
                                       ra.astype(np.float64),
                                       err_msg=f"{what} output {i}",
                                       **TOL[tol])
        else:
            np.testing.assert_array_equal(pa, ra, err_msg=f"{what} "
                                                          f"output {i}")


def run_both(fn_ref, fn_port, args, kwargs=None, grad=(), tol="ew",
             what="", seed=0):
    """``fn(*args, **kwargs)`` in both packages on the same inputs (numpy
    arrays become tensors; indices in ``grad`` require grad), the results
    held to each other, then the gradients of the ``grad`` inputs under
    one cotangent per floating output (seeded normal)."""
    kwargs = kwargs or {}
    r_args = [to_ref(a, i in grad) for i, a in enumerate(args)]
    p_args = [to_port(a, i in grad) for i, a in enumerate(args)]
    r_out = fn_ref(*r_args, **kwargs)
    p_out = fn_port(*p_args, **kwargs)
    assert_same(r_out, p_out, tol, what)
    if not grad:
        return r_out, p_out
    rs = np.random.RandomState(seed)
    r_loss = p_loss = None
    for a, b in zip(leaves(r_out), leaves(p_out)):
        if not _floating(ref_dtype_name(a.dtype)) or a.stop_gradient:
            continue
        cot = rs.randn(*a.shape).astype(np.float32) if a.shape \
            else np.float32(rs.randn())
        rt = (a * ref.to_tensor(cot).astype(ref_dtype_name(a.dtype))).sum()
        pt = (b * port.to_tensor(cot).astype(port_dtype_name(b.dtype))).sum()
        r_loss = rt if r_loss is None else r_loss + rt
        p_loss = pt if p_loss is None else p_loss + pt
    assert p_loss is not None, f"{what}: no differentiable output"
    r_loss.backward()
    p_loss.backward()
    for i in grad:
        rg, pg = r_args[i].grad, p_args[i].grad
        assert (rg is None) == (pg is None), f"{what}: grad {i} presence"
        if rg is not None:
            np.testing.assert_allclose(
                np.asarray(pg.numpy(), np.float64),
                np.asarray(rg.numpy(), np.float64),
                err_msg=f"{what}: gradient of input {i}", **TOL[tol])
    return r_out, p_out


def numeric_grad_check(fn, arrays, eps=1e-3, rtol=2e-2, atol=2e-3,
                       seed=0):
    """The port's gradient of ``sum(fn(*xs) * cot)`` against central
    differences (the counterpart of ``tests/gradcheck.py``)."""
    rs = np.random.RandomState(seed)
    xs = [port.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*xs)
    cot = rs.randn(*out.shape).astype(np.float32)
    (out * port.to_tensor(cot)).sum().backward()
    for k, a in enumerate(arrays):
        num = np.zeros_like(a, dtype=np.float64)
        flat = a.reshape(-1)
        for j in range(flat.size):
            vals = []
            for sgn in (1, -1):
                b = flat.copy()
                b[j] += sgn * eps
                args = [port.to_tensor(b.reshape(a.shape)) if m == k else
                        port.to_tensor(arrays[m]) for m in range(len(arrays))]
                vals.append(float((fn(*args).numpy().astype(np.float64)
                                   * cot).sum()))
            num.reshape(-1)[j] = (vals[0] - vals[1]) / (2 * eps)
        np.testing.assert_allclose(xs[k].grad.numpy(), num, rtol=rtol,
                                   atol=atol)
