"""The budget remat of ``Model``'s captured train step — the counterpart of
the reference's ``jax.checkpoint(loss_of,
policy=jax.checkpoint_policies.dots_saveable)``
(``paddle_tpu/hapi/model.py:283-290``): every product's output is kept
for the backward, everything else is recomputed there.

The regions are non-reentrant ``torch.utils.checkpoint`` regions whose
``context_fn`` is ``create_selective_checkpoint_contexts`` with
:func:`policy`: ``MUST_SAVE`` for the products (``aten.mm``, ``addmm``,
``bmm``, ``baddbmm``, ``_scaled_mm``), ``PREFER_RECOMPUTE`` for the rest.
The hand kernels' autograd Functions (attention, the fused epilogue) are
no aten products: their forwards run again in the recompute, as the
reference's custom-vjp Pallas calls do under ``jax.checkpoint``.

XLA schedules each recomputed value next to its use in the backward.
Eager autograd recomputes a region whole, at the first use of any of its
saved values, so one region over the forward and the loss would hold
every recomputed value at once, as many as no remat holds.  So
:func:`segments` makes each block of the network's outermost
``ModuleList`` or ``Sequential`` (the whole network where it has none) a
region, and :func:`checkpoint` the loss another; the rest of the forward
(embeddings, the final norm, the head's product) keeps its values.  The
values the backward reads are the same either way.

A region recomputes what its forward computed:

- its draws are replayed (:class:`~paddle_tpu_torch.random.DrawLog`):
  the fused epilogue's seeds (host draws or capture slots) and the port's
  dropout masks; other seeded ops (``torch.nn.Dropout``) are kept like
  the products, since the recompute cannot restore torch's generators
  inside a stream capture (``preserve_rng_state`` is off);
- it re-enters the forward's AMP state
  (:class:`~paddle_tpu_torch.amp.restored`): the recompute runs in the
  backward, outside ``auto_cast``;
- a block's parameters and buffers are inputs of its region, put back
  with ``torch.func.functional_call``: under O2 the forward saw the
  low-type views that ``Model`` builds, which are gone by the backward.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .. import amp as _amp
from .. import random as _random

__all__ = ["PRODUCTS", "policy", "checkpoint", "segments", "blocks"]

_aten = torch.ops.aten
# the products whose outputs the backward keeps (dots_saveable)
PRODUCTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                      _aten._scaled_mm))
# set while a region's body runs on this thread: a block met inside one
# runs as it is
_local = threading.local()


def policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products and the outputs of seeded ops on torch's own
    generators; recompute the rest.  The draws of the port's random state
    are replayed by the region's log instead (their ops do not run again
    in the recompute)."""
    if func.overloadpacket in PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    if torch.Tag.nondeterministic_seeded in func.tags and \
            not _random.drawing():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_CONTEXTS = functools.partial(create_selective_checkpoint_contexts, policy)


class _Region:
    """``fn`` as a checkpointed region's body: the first call (the forward)
    records its draws and AMP state, each later one (the recompute)
    replays them."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.log = None
        self.amp = None

    def __call__(self, *args, **kwargs):
        prev = getattr(_local, "inside", False)
        _local.inside = True
        try:
            if self.log is None:
                self.log, self.amp = _random.DrawLog(), _amp._amp_state()
                with self.log.recording():
                    return self.fn(*args, **kwargs)
            with self.log.replaying(), _amp.restored(self.amp):
                return self.fn(*args, **kwargs)
        finally:
            _local.inside = prev


def checkpoint(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one region: products kept, the rest
    recomputed in the backward with the forward's draws."""
    return torch.utils.checkpoint.checkpoint(
        _Region(fn), *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=_CONTEXTS, **kwargs)


def blocks(network: torch.nn.Module) -> List[torch.nn.Module]:
    """The regions of ``network``: the items of its outermost
    ``ModuleList`` / ``Sequential`` containers, in order; the network
    itself when it has none."""
    out, inside = [], set()
    for mod in network.modules():
        if id(mod) in inside:
            continue
        if isinstance(mod, (torch.nn.ModuleList, torch.nn.Sequential)):
            out.extend(mod)
            inside.update(id(m) for m in mod.modules())
    return out or [network]


def _block_forward(block: torch.nn.Module, forward: Callable) -> Callable:
    """``block``'s forward as a region whose inputs are also the block's
    parameters and buffers as the forward sees them."""
    names = [n for n, _ in block.named_parameters(remove_duplicate=False)] \
        + [n for n, _ in block.named_buffers(remove_duplicate=False)]

    def body(*flat, **kwargs):
        state = dict(zip(names, flat[:len(names)]))
        return torch.func.functional_call(block, state, flat[len(names):],
                                          kwargs)

    def region(*args, **kwargs):
        if getattr(_local, "inside", False):
            return forward(*args, **kwargs)
        state = [functools.reduce(getattr, n.split("."), block)
                 for n in names]
        return checkpoint(body, *state, *args, **kwargs)

    return region


@contextlib.contextmanager
def segments(network: torch.nn.Module):
    """While it is entered, each of ``network``'s :func:`blocks` runs as
    a region (its forward is replaced on the instance, then put back)."""
    patched = []
    try:
        for blk in blocks(network):
            had = "forward" in vars(blk)
            patched.append((blk, had, vars(blk).get("forward")))
            blk.forward = _block_forward(blk, blk.forward)
        yield
    finally:
        for blk, had, prev in reversed(patched):
            if had:
                blk.forward = prev
            else:
                del blk.forward
