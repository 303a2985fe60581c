"""Fused optimizer update — the counterpart of
``paddle_tpu/optimizer/fused_update.py``: one launch per group of
parameters for every optimizer's step.

The reference fuses its eager step per stacked same-shape group with one
``jax.jit`` of ``vmap(_update)`` (``Momentum``, ``Adam``, ``AdamW``
only, no masters), and leaves its jitted ``Model`` step per-leaf on
purpose: there every optimizer's per-parameter chain, masters included,
is already one XLA program whose fusions make one pass an element
(``functional_apply``, ``optimizers.py:276-286``).  The port has one
``step()`` for both: ``Model.prepare(jit=True)`` captures the same
``step()`` that runs eagerly.  So its counterpart of both reference paths
is the same thing: one pass over each element per step, for all twelve
optimizers, masters included — the hand-written multi-tensor kernel of
:mod:`paddle_tpu_torch.ops.multi_tensor_update`.

:func:`fused_step` groups the live parameters (those with a gradient) by
type setup (parameter and gradient type, whether an fp32 master steps
them: the kind is the optimizer's), makes every slot and master through
``opt._slot`` first, and launches each group's table.  The tables are
built outside any capture and cached on the optimizer, keyed by the live
set's names, data pointers, types and per-tensor values (lr scale,
regularizer, AdamW's decay, LarsMomentum's exclusion): the first real
step builds them (``StepGraph`` runs one before it captures), a changed
live set or a renamed parameter (``Model.prepare`` names them) rebuilds
them, and a rebuild while a stream is capturing raises.

A gradient that is not in its parameter's type, or not contiguous, is
copied each step into a buffer of the optimizer's (made at the first
step, read by address like the tables); the kernel reads that.

A row-sparse gradient of an SGD, Adam or AdamW parameter is a record of
the rows pass (``mt_update_rows``), merged (unique rows, summed values)
after the dense groups are launched, since finding its unique rows waits
for the card: its tables are built every step, the rows changing with
the data, and launched after the dense groups'.  Any other
optimizer's is scattered into that buffer as a dense gradient, with the
coupled regularizer added on the touched rows first and none in its
record (the reference's ``_update_sparse`` default after
``optimizers.py:145-150``: a record's regularizer would decay every
row); the scatter writes each row once, so it is deterministic.

``step(found_inf=...)`` (fp16 loss scaling) hands every launch a device
bool: set, the launches write nothing (``ops/multi_tensor_update.py``).
The flag is a launch argument, read by address like the learning rate,
and not part of the tables' cache key.

It returns False — the caller then takes the per-leaf path — in the
reference's remaining cases only, decided before any launch and counted
in :data:`ROUTES`: ``FLAGS_fused_optimizer`` off (the flag registry,
``utils/flags.py``: ``set_flags`` or the environment at import; default
on), or a regularizer other
than ``L1Decay`` / ``L2Decay`` (the reference's ``"opaque"``).  A
subclass that overrides ``_update`` without describing its functor in
``_kernel_spec`` also takes the per-leaf path (the reference's
exact-type test sends every subclass there); one that overrides neither
runs on the kernel with the spec it inherits.  A kernel that fails to
build or launch raises; nothing falls back.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..core.selected_rows import merged_grad
from ..ops import multi_tensor_update as mtu
from ..utils.flags import get_flag

__all__ = ["fused_step", "supported", "ROUTES", "tables", "bound_tensors",
           "sparse_values", "scatter_rows"]

# steps by route (plain integers): "fused", and the per-leaf ones
ROUTES: Dict[str, int] = {"fused": 0, "per_leaf_flag": 0,
                          "per_leaf_regularizer": 0, "per_leaf_update": 0}


def _flag_on() -> bool:
    """``FLAGS_fused_optimizer`` from the flag registry (default on)."""
    return bool(get_flag("FLAGS_fused_optimizer"))


def _own_update(opt) -> bool:
    """Whether ``opt``'s class steps by an ``_update`` its kernel spec does
    not describe: one defined below the class that defines
    ``_kernel_spec``."""
    def owner(attr):
        return next(c for c in type(opt).__mro__ if attr in vars(c))
    return not issubclass(owner("_kernel_spec"), owner("_update"))


def supported(opt) -> bool:
    """Whether this optimizer may take the fused path at all: the flag on
    and a functor for its ``_update``.  Unlike the reference's (three
    types exactly, no masters), every optimizer of the port, its
    subclasses that keep its ``_update`` and masters are taken: see the
    module docstring."""
    return _flag_on() and not _own_update(opt)


def _regularizer(opt, p):
    """``(name, coeff)`` of the regularizer the update adds for ``p``:
    ``(None, 0.0)`` without one, ``("opaque", 0.0)`` for a type the kernel
    does not add."""
    reg = opt._regularizer_for(p)
    if reg is None or not reg.coeff:
        return None, 0.0
    name = type(reg).__name__
    from ..regularizer import L1Decay, L2Decay
    if type(reg) not in (L1Decay, L2Decay):
        return "opaque", 0.0
    return name, float(reg.coeff)


def _grad(opt, p):
    """``p``'s gradient as the kernel reads it: itself, or a copy in
    ``p``'s type, contiguous, in a buffer kept for the next steps."""
    g = p.grad
    if g.dtype == p.dtype and g.is_contiguous():
        return g
    bufs = opt.__dict__.setdefault("_fused_grads", {})
    buf = bufs.get(id(p))
    if buf is None or buf.shape != p.shape or buf.dtype != p.dtype:
        buf = bufs[id(p)] = torch.empty_like(
            p, memory_format=torch.contiguous_format)
    return buf.copy_(g)


def sparse_values(p, target, reg):
    """``(rows, values)`` of ``p``'s merged row-sparse gradient, the
    values in ``target``'s type with ``reg``'s gradient on the touched
    rows added (the reference's :145-150)."""
    g = p.grad
    rows, vals = g._indices()[0], g._values().to(target.dtype)
    if reg is not None and reg.coeff:
        vals = vals + reg.grad(target[rows])
    return rows, vals


def scatter_rows(like, rows, values, out=None):
    """``values`` written at ``rows`` into zeros shaped as ``like`` (into
    ``out`` when given): rows are unique, so each is written once."""
    if out is None:
        out = torch.zeros_like(like, memory_format=torch.contiguous_format)
    else:
        out.zero_()
    return out.index_copy_(0, rows, values.to(out.dtype))


def _dense_of_sparse(opt, p, reg):
    """The dense gradient of ``p``'s merged row-sparse one in a buffer of
    the optimizer's, in ``p``'s type, the regularizer on the touched rows
    added (on the master where there is one)."""
    target = opt._master_weights.get(id(p), p)
    rows, vals = sparse_values(p, target, reg)
    bufs = opt.__dict__.setdefault("_fused_grads", {})
    buf = bufs.get(id(p))
    if buf is None or buf.shape != p.shape or buf.dtype != p.dtype:
        buf = bufs[id(p)] = torch.empty_like(
            p, memory_format=torch.contiguous_format)
    return scatter_rows(p, rows, vals, out=buf)


def _records(opt, spec, live, regs, grads=None, rows=None
             ) -> List[mtu.Record]:
    out = []
    for i, ((name, p), (reg, coeff)) in enumerate(zip(live, regs)):
        slot = opt._slot(p)
        out.append(mtu.Record(
            name=name, param=p,
            grad=_grad(opt, p) if grads is None else grads[i],
            rows=None if rows is None else rows[i],
            master=opt._master_weights.get(id(p)),
            slots=tuple(slot[k] for k in spec.slots),
            pows=tuple(slot[k] for k in ("beta1_pow", "beta2_pow")[
                :len(spec.betas)]),
            lr_scale=float((getattr(p, "optimize_attr", None) or {}).get(
                "learning_rate", 1.0)),
            reg=reg, reg_coeff=coeff, **opt._kernel_record(name)))
    return out


def _key(spec, records) -> Tuple:
    def ptr(t):
        return 0 if t is None else t.data_ptr()
    return (spec,) + tuple(
        (r.name, ptr(r.param), ptr(r.grad), ptr(r.master),
         r.param.dtype, r.grad.dtype, r.param.numel(),
         tuple(ptr(t) for t in r.slots + r.pows), r.lr_scale, r.reg,
         r.reg_coeff, r.decay, r.plain) for r in records)


def _group(records) -> List[List[mtu.Record]]:
    """The records by type setup (device, parameter and gradient type,
    master type), in the order of their first member."""
    groups: Dict[Tuple, List[mtu.Record]] = {}
    for r in records:
        key = (r.param.device, r.param.dtype, r.grad.dtype,
               None if r.master is None else r.master.dtype)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def tables(opt) -> Tuple[mtu.Table, ...]:
    """The optimizer's cached group tables (empty before its first fused
    step)."""
    cached = getattr(opt, "_fused_tables", None)
    return () if cached is None else cached[1]


def bound_tensors(opt):
    """The tensors the fused step reads by address beyond the optimizer's
    state: the tables' device tensors and the gradient buffers."""
    for table in tables(opt):
        yield from table.tensors()
    yield from getattr(opt, "_fused_grads", {}).values()


def fused_step(opt, found_inf=None) -> bool:
    """The fused step over the optimizer's live parameters, after
    ``step()``'s clip, skipped on the device where ``found_inf`` (a bool
    tensor, or None) is set.  Returns False when the per-leaf path must
    take the step (the module docstring), True when it was taken."""
    if not _flag_on():
        ROUTES["per_leaf_flag"] += 1
        return False
    if _own_update(opt):
        ROUTES["per_leaf_update"] += 1
        return False
    live = opt._live()
    regs = [_regularizer(opt, p) for _, p in live]
    if any(reg == "opaque" for reg, _ in regs):
        ROUTES["per_leaf_regularizer"] += 1
        return False
    if len({id(p) for _, p in live}) != len(live):
        raise ValueError("a parameter is listed twice: the fused update "
                         "would step it twice at once")
    spec = opt._kernel_spec()
    rows_path = opt._sparse_rows and spec.kind in mtu.ROWS_KINDS
    dense, dense_regs, grads, sparse, sparse_regs = [], [], [], [], []
    for (name, p), (reg, coeff) in zip(live, regs):
        if not p.grad.is_sparse:
            dense.append((name, p))
            dense_regs.append((reg, coeff))
            grads.append(_grad(opt, p))
        elif rows_path:
            sparse.append((name, p))
            sparse_regs.append((reg, coeff))
        else:
            p.grad = merged_grad(p.grad)
            opt._slot(p)                # the master the regularizer reads
            dense.append((name, p))
            dense_regs.append((None, 0.0))
            grads.append(_dense_of_sparse(opt, p, opt._regularizer_for(p)))
    records = _records(opt, spec, dense, dense_regs, grads)
    key = _key(spec, records)
    groups = _group(records)
    cached = getattr(opt, "_fused_tables", None)
    if cached is None or cached[0] != key:
        cached = opt._fused_tables = (key, tuple(
            mtu.Table(spec, group) for group in groups))
    for table, group in zip(cached[1], groups):
        # this step's tensors, held for the launch only: a gradient the
        # caller drops after the step is not kept alive by the cache
        table.records = tuple(group)
        try:
            mtu.multi_tensor_update(spec, table, opt._lr(table.device),
                                    opt._update, found_inf=found_inf)
        finally:
            table.records = ()
    if sparse:
        # merged after the dense launches: finding the unique rows waits
        # for the card, which then has the dense update queued
        for _, p in sparse:
            p.grad = merged_grad(p.grad)
        values = [p.grad._values().to(p.dtype).contiguous()
                  for _, p in sparse]
        rows = [p.grad._indices()[0] for _, p in sparse]
        for group in _group(_records(opt, spec, sparse, sparse_regs, values,
                                     rows)):
            mtu.multi_tensor_update_rows(spec, mtu.RowsTable(spec, group),
                                         opt._lr(group[0].param.device),
                                         opt._update, found_inf=found_inf)
    opt._global_step += 1
    ROUTES["fused"] += 1
    return True
