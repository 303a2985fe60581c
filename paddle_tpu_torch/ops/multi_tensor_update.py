"""The optimizer update over many tensors in one launch — the kernel
behind :mod:`paddle_tpu_torch.optimizer.fused_update`, the counterpart of
``paddle_tpu/optimizer/fused_update.py`` (no Pallas kernel: the reference
runs the update as XLA fusions).

A :class:`Spec` describes an optimizer's kernel functor: its kind (one of
:data:`KINDS`), its hyperparameters in the functor's order, its flags, the
names of its element slots and the betas of its per-tensor powers.  A
:class:`Record` is one parameter of a step: the parameter, its gradient,
its fp32 master (or None), its slots and powers, and what varies per
tensor (the lr scale, an L1 or L2 regularizer, AdamW's decay for the
name, LarsMomentum's exclusion).  A :class:`Table` is one group of
records that share the types: on the card it holds the device table of
records, the prefix table of chunks and, for the trust-ratio kinds, the
norm buffers, made once and read by address, so that a captured step
replays them.

:func:`multi_tensor_update` launches ``csrc/multi_tensor_update.cu`` for a
table on the card (or raises) and computes :func:`multi_tensor_update_ref`,
its plain version, for CPU tensors.  The type setups the kernel takes:
fp32 parameters; bf16 or fp16 parameters over fp32 masters (fp32 slots);
bf16 or fp16 parameters without masters (slots in their type).  The
plain version also takes fp64 on the CPU, computing in fp64.
:data:`LAUNCHES` (by kind), :data:`NORM_LAUNCHES` and :data:`POW_LAUNCHES`
count launches.

Loss scaling under fp16 AMP adds a pass and a flag (the reference's
jitted step, ``paddle_tpu/hapi/model.py:296-331``, in XLA):
:func:`multi_tensor_unscale` multiplies a step's gradients in place by
``1/scale`` (read from the scale's fp32 device scalar and rounded to each
gradient's type, the jitted step's ``g * inv.astype(g.dtype)``) and sets a
device bool ``found_inf`` when any element is not finite, one launch per
group of one type (:class:`GradTable`, counted in
:data:`UNSCALE_LAUNCHES`); its plain version is
:func:`multi_tensor_unscale_ref`.  :func:`multi_tensor_update` takes that
flag as ``found_inf``: set, every launch returns before writing, so
parameters, masters, slots and powers keep their values (the reference's
``jnp.where(found_inf, old, new)``), and the plain version keeps them
through ``torch.where``.  Nothing reads the flag on the host.

Optimizer-state offload (``Model.prepare(offload=True)``) puts the slots
and powers of a group on the card in pinned host memory; parameters,
gradients and masters stay on the card, and a slot in host memory that is
not pinned is refused by name.  A host slot is addressed by the device
pointer ``cudaPointerGetAttributes`` gives for it (``mt_device_pointer``;
memory of another type raises).  Two routes, counted in
:data:`OFFLOAD_ROUTES`:

- ``"staged"`` (every kind without a norms pass): the group is cut into
  stages of at most :data:`STAGE_ELEMENTS` elements of each slot; a
  stage's slots are copied by the copy engines into one of
  :data:`STAGE_RING` device buffers on a side stream, the update kernel
  steps the stage there, and another side stream copies them back, so
  the two directions and the kernel overlap across stages; each stage is
  one launch of the update pass.  On the H100s measured it was never the
  slower route: 22% faster than in place where pinned copies both ways at
  once ran 32-34 GB/s each way, 4% where they ran 45.5 (``PERF.md`` §6,
  ``tools/offload_sweep.py``); the stage size and ring depth moved it
  under 4%.  The powers stay in place (8 bytes a tensor) and advance once,
  after every stage.
- ``"in_place"`` (LarsMomentum, Lamb: their norms pass, once over whole
  tensors, comes before the update; Lamb's stores the moments the update
  pass reads back): the kernel reads and writes the slots where they lie,
  over PCIe.
"""
from __future__ import annotations

import ctypes
import operator
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["KINDS", "Spec", "Record", "Table", "multi_tensor_update",
           "multi_tensor_update_ref", "LAUNCHES", "NORM_LAUNCHES",
           "POW_LAUNCHES", "CHUNK", "GradTable", "grad_tables", "GRAD_CODES",
           "multi_tensor_unscale", "multi_tensor_unscale_ref",
           "UNSCALE_LAUNCHES", "STAGE_ELEMENTS", "STAGE_RING",
           "OFFLOAD_ROUTES", "device_address", "stage_cuts"]

# the kernel's kinds, in the order of its Kind enum
KINDS = ("sgd", "momentum", "lars", "adam", "adamw", "adamax", "adagrad",
         "adadelta", "rmsprop", "rmsprop_centered", "lamb", "ftrl",
         "decayed_adagrad")
_NORM_KINDS = ("lars", "lamb")
# elements a block updates (a multiple of 256 threads x 8)
CHUNK = 32768
_REG = {None: 0, "L1Decay": 1, "L2Decay": 2}

# kernel launches since import (plain integers; tests and the smoke run
# reset them and read them back): the update pass by kind, the norms pass
# (two launches, counted once) and the powers' advance
LAUNCHES: Dict[str, int] = {}
NORM_LAUNCHES = 0
POW_LAUNCHES = 0
UNSCALE_LAUNCHES = 0
# offloaded groups' update launches by route (see the module docstring;
# a staged group launches once per stage)
OFFLOAD_ROUTES: Dict[str, int] = {"staged": 0, "in_place": 0}
# a stage's elements of each slot (a multiple of 8: aligned vectors), and
# the device buffers the stages take in turn (tools/offload_sweep.py times
# 1M-16M and 2-4)
STAGE_ELEMENTS = 1 << 22
STAGE_RING = 3
# the staged route for the kinds that can take it; chip_smoke.py patches
# it to False to time the in-place route beside it
_STAGE_OFFLOAD = True

_lib = None


@dataclass(frozen=True)
class Spec:
    """An optimizer's kernel functor: ``kind`` (:data:`KINDS`), ``hyper``
    (at most 8 numbers, the functor's ``h``), ``flags`` (Momentum 1:
    Nesterov; Ftrl 1: ``lr_power`` other than -0.5), ``slots`` (the
    element slots' names in the functor's order) and ``betas`` (the
    factor of each per-tensor power, ``beta1_pow`` then ``beta2_pow``)."""
    kind: str
    hyper: Tuple[float, ...] = ()
    flags: int = 0
    slots: Tuple[str, ...] = ()
    betas: Tuple[float, ...] = ()


@dataclass
class Record:
    """One parameter of a step.  ``slots`` and ``pows`` follow the Spec's
    ``slots`` and ``betas``; ``reg`` is None, ``"L1Decay"`` or
    ``"L2Decay"`` with ``reg_coeff``; ``decay`` AdamW's weight decay for
    this name (0.0: none); ``plain`` an excluded LarsMomentum name."""
    name: str
    param: torch.Tensor
    grad: torch.Tensor
    master: Optional[torch.Tensor]
    slots: Tuple[torch.Tensor, ...]
    pows: Tuple[torch.Tensor, ...] = ()
    lr_scale: float = 1.0
    reg: Optional[str] = None
    reg_coeff: float = 0.0
    decay: float = 0.0
    plain: bool = False

    @property
    def target(self) -> torch.Tensor:
        """The tensor the update steps: the master, else the parameter."""
        return self.param if self.master is None else self.master


class _Rec(ctypes.Structure):
    """``Rec`` of csrc/multi_tensor_update.cu, field for field."""
    _fields_ = [("w", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("p16", ctypes.c_void_p), ("s", ctypes.c_void_p * 3),
                ("pw", ctypes.c_void_p * 2), ("n", ctypes.c_longlong),
                ("lr_scale", ctypes.c_float), ("reg_coeff", ctypes.c_float),
                ("decay", ctypes.c_float), ("reg", ctypes.c_int),
                ("plain", ctypes.c_int), ("vec", ctypes.c_int)]


assert ctypes.sizeof(_Rec) == 96


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("multi_tensor_update")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mt_update.argtypes = [p, p, i, i, i, i, i, p, p, i, p, p, p]
        lib.mt_update.restype = i
        lib.mt_norms.argtypes = [p, p, i, i, i, i, i, p, i, p, p, p, p]
        lib.mt_norms.restype = i
        lib.mt_pows.argtypes = [p, i, ctypes.c_float, ctypes.c_float, p, p]
        lib.mt_pows.restype = i
        lib.mt_unscale.argtypes = [p, p, i, i, i, i, p, p, p, i, p]
        lib.mt_unscale.restype = i
        lib.mt_device_pointer.argtypes = [p, ctypes.POINTER(i),
                                          ctypes.POINTER(p)]
        lib.mt_device_pointer.restype = i
        lib.multi_tensor_update_error_string.argtypes = [i]
        lib.multi_tensor_update_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# the kernel's type setups: (parameter type, master type or None)
_TYPES = ((torch.float32, None), (torch.bfloat16, torch.float32),
          (torch.bfloat16, None), (torch.float16, torch.float32),
          (torch.float16, None))


def _types_code(r: Record) -> int:
    """The kernel's type setup of a record on the card (its index in
    ``_TYPES``); a TypeError naming the tensor otherwise."""
    key = (r.param.dtype, None if r.master is None else r.master.dtype)
    if key not in _TYPES:
        raise TypeError(
            f"multi_tensor_update: {r.name}: the kernel takes fp32 "
            f"parameters and bf16 or fp16 parameters with or without fp32 "
            f"masters; got a {key[0]} parameter with "
            f"{'no master' if key[1] is None else 'a ' + str(key[1]) + ' master'}")
    return _TYPES.index(key)


def _host_slot(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` is a slot of a group on the card kept in host
    memory (offload)."""
    return device.type == "cuda" and t.device.type == "cpu"


def _check(spec: Spec, records: Sequence[Record]) -> torch.device:
    """What the kernel and its plain version take alike; returns the
    records' device.  A slot or power of a group on the card may lie in
    pinned host memory."""
    if spec.kind not in KINDS:
        raise ValueError(f"multi_tensor_update: unknown kind {spec.kind!r}")
    if not records:
        raise ValueError("multi_tensor_update: an empty group")
    device = records[0].param.device
    for r in records:
        w = r.target
        tensors = {"parameter": r.param, "gradient": r.grad, "master":
                   r.master, **dict(zip(spec.slots, r.slots))}
        if len(r.slots) != len(spec.slots) or len(r.pows) != len(spec.betas):
            raise ValueError(f"multi_tensor_update: {r.name}: {len(r.slots)} "
                             f"slots and {len(r.pows)} powers where "
                             f"{spec.kind} has {len(spec.slots)} and "
                             f"{len(spec.betas)}")
        state = set(spec.slots)
        for what, t in list(tensors.items()) + [
                (f"power {k}", t) for k, t in enumerate(r.pows)]:
            if t is None:
                continue
            if (what in state or what.startswith("power")) and \
                    _host_slot(t, device):
                if not t.is_pinned():
                    raise ValueError(
                        f"multi_tensor_update: {r.name}'s {what} is in host "
                        f"memory that is not pinned; the kernel reads host "
                        f"slots in place, which needs pinned memory")
            elif t.device != device:
                raise ValueError(f"multi_tensor_update: {r.name}'s {what} is "
                                 f"on {t.device}, the group on {device}")
            if what.startswith("power"):
                continue
            if t.numel() != r.param.numel():
                raise ValueError(f"multi_tensor_update: {r.name}'s {what} "
                                 f"has {t.numel()} elements, the parameter "
                                 f"{r.param.numel()}")
            if not t.is_contiguous():
                raise ValueError(f"multi_tensor_update: {r.name}'s {what} "
                                 f"is not contiguous")
        if r.grad.dtype != r.param.dtype or any(s.dtype != w.dtype
                                                for s in r.slots):
            raise TypeError(f"multi_tensor_update: {r.name}: the gradient "
                            f"must be in the parameter's type and the slots "
                            f"in the {'master' if r.master is not None else 'parameter'}"
                            f"'s; got {r.grad.dtype}, "
                            f"{[s.dtype for s in r.slots]}")
        if any(t.dtype != torch.float32 or t.numel() != 1 for t in r.pows):
            raise TypeError(f"multi_tensor_update: {r.name}: the powers must "
                            f"be fp32 scalars")
        if r.reg not in _REG:
            raise ValueError(f"multi_tensor_update: {r.name}: regularizer "
                             f"{r.reg!r}; the kernel adds L1Decay and "
                             f"L2Decay")
    return device


class Table:
    """One group of records of one type setup, checked, and on the card its
    device tables (:meth:`tensors`), built here, outside any capture."""

    def __init__(self, spec: Spec, records: Sequence[Record]):
        self.spec = spec
        self.records = tuple(records)
        self.names = tuple(r.name for r in self.records)
        self.device = _check(spec, self.records)
        self.recs = self.prefix = self.partials = self.norms = None
        self.stages = self.ring = ()
        self.nchunks = sum(-(-r.param.numel() // CHUNK) for r in self.records)
        if self.device.type != "cuda":
            return
        codes = {_types_code(r) for r in self.records}
        if len(codes) != 1:
            raise TypeError(f"multi_tensor_update: a group of mixed type "
                            f"setups {sorted(codes)}")
        self.types = codes.pop()
        arr = (_Rec * len(self.records))()
        for rec, r in zip(arr, self.records):
            slots = [device_address(s) for s in r.slots]
            ptrs = [r.target.data_ptr(), r.grad.data_ptr()] + slots
            rec.w, rec.g = ptrs[0], ptrs[1]
            rec.p16 = r.param.data_ptr() if r.master is not None else None
            if rec.p16:
                ptrs.append(rec.p16)
            for k, s in enumerate(slots):
                rec.s[k] = s
            for k, t in enumerate(r.pows):
                rec.pw[k] = device_address(t)
            rec.n = r.param.numel()
            rec.lr_scale, rec.reg_coeff = r.lr_scale, r.reg_coeff
            rec.decay, rec.reg = r.decay, _REG[r.reg]
            rec.plain = int(r.plain)
            rec.vec = int(all(p % 16 == 0 for p in ptrs))
        self.recs, self.prefix = _upload("multi_tensor_update", arr,
                                         self.device)
        if _STAGE_OFFLOAD and spec.kind not in _NORM_KINDS and any(
                _host_slot(s, self.device) for r in self.records
                for s in r.slots):
            self._stage()
        if spec.kind in _NORM_KINDS:
            self.partials = torch.empty(2 * max(self.nchunks, 1),
                                        dtype=torch.float32,
                                        device=self.device)
            self.norms = torch.empty(2 * len(self.records),
                                     dtype=torch.float32, device=self.device)

    def _stage(self) -> None:
        """The staged route of an offloaded group: :attr:`stages`, each
        with its device table over :attr:`ring` buffers and the (host,
        device) slot ranges it copies each way."""
        E, nslots = STAGE_ELEMENTS, len(self.spec.slots)
        dtype = self.records[0].slots[0].dtype
        cuts = [[(self.records[i], start, n, pos) for i, start, n, pos in cut]
                for cut in stage_cuts([r.param.numel() for r in self.records],
                                      E)]
        self.ring = tuple(torch.empty(nslots * E, dtype=dtype,
                                      device=self.device)
                          for _ in range(min(STAGE_RING, len(cuts))))
        stages = []
        for i, cut in enumerate(cuts):
            buf = self.ring[i % len(self.ring)]
            arr = (_Rec * len(cut))()
            copies = []
            for rec, (r, start, n, pos) in zip(arr, cut):
                w, g = r.target, r.grad
                rec.w = w.data_ptr() + start * w.element_size()
                rec.g = g.data_ptr() + start * g.element_size()
                rec.p16 = (r.param.data_ptr() + start * r.param.element_size()
                           if r.master is not None else None)
                for k, slot in enumerate(r.slots):
                    dev = buf[k * E + pos:k * E + pos + n]
                    rec.s[k] = dev.data_ptr()
                    copies.append((slot.view(-1)[start:start + n], dev))
                for k, t in enumerate(r.pows):
                    rec.pw[k] = device_address(t)
                rec.n = n
                rec.lr_scale, rec.reg_coeff = r.lr_scale, r.reg_coeff
                rec.decay, rec.reg = r.decay, _REG[r.reg]
                rec.plain = int(r.plain)
                rec.vec = int(all(p % 16 == 0 for p in (
                    rec.w, rec.g, rec.p16 or 0, *rec.s[:nslots])))
            recs, prefix = _upload("multi_tensor_update", arr, self.device)
            stages.append(_Stage(recs, prefix, len(cut), sum(
                -(-n // CHUNK) for _, _, n, _ in cut), tuple(copies)))
        self.stages = tuple(stages)
        self.streams = tuple(torch.cuda.Stream(device=self.device)
                             for _ in range(2))

    def tensors(self):
        """The device tensors a launch reads by address."""
        return tuple(t for t in (self.recs, self.prefix, self.partials,
                                 self.norms) if t is not None) + tuple(
            self.ring) + tuple(t for st in self.stages
                               for t in (st.recs, st.prefix))


def stage_cuts(sizes: Sequence[int], elements: int):
    """Tensors of ``sizes`` elements cut into stages of at most
    ``elements`` (a multiple of 8) each, in order: per stage the ranges
    ``(tensor index, start, length, offset in the stage)``; each range
    starts at a multiple of 8 in its stage and in its tensor, so that
    aligned tensors keep aligned vectors."""
    cuts, cur, pos = [], [], 0
    for i, n in enumerate(sizes):
        start = 0
        while start < n:
            if pos >= elements:
                cuts.append(cur)
                cur, pos = [], 0
            take = min(n - start, elements - pos)
            cur.append((i, start, take, pos))
            start += take
            pos += -(-take // 8) * 8
    if cur:
        cuts.append(cur)
    return cuts


@dataclass(frozen=True)
class _Stage:
    """One stage of an offloaded group: its device table (``n`` records,
    ``nchunks`` chunks) and the (host range, device range) pairs of its
    slots."""
    recs: torch.Tensor
    prefix: torch.Tensor
    n: int
    nchunks: int
    copies: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


# cudaMemoryType of cudaPointerGetAttributes
_MEMORY_TYPES = {0: "unregistered host", 1: "host", 2: "device", 3: "managed"}


def device_address(t: torch.Tensor) -> int:
    """The address a kernel reads ``t`` at: its own for a tensor on the
    card; for pinned host memory the device pointer that
    ``cudaPointerGetAttributes`` gives for it (``mt_device_pointer``),
    which must be of host memory."""
    if t.device.type != "cpu":
        return t.data_ptr()
    kind, dev = ctypes.c_int(), ctypes.c_void_p()
    lib = _kernel()
    _raise(lib, "mt_device_pointer", lib.mt_device_pointer(
        t.data_ptr(), ctypes.byref(kind), ctypes.byref(dev)))
    if kind.value != 1 or not dev.value:
        raise ValueError(
            f"multi_tensor_update: a host slot at {t.data_ptr():#x} is "
            f"{_MEMORY_TYPES.get(kind.value, kind.value)} memory; the kernel "
            f"reads pinned host memory")
    return dev.value


def _upload(what: str, arr, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The records ``arr`` (a ctypes array of :class:`_Rec`) and the prefix
    table of their chunks, copied to ``device``: a host-to-device copy, so
    never while a CUDA graph is being captured."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what}: the device table would be built while a CUDA graph is "
            f"being captured (a host-to-device copy); run the step once "
            f"uncaptured first")
    prefix = [0]
    for rec in arr:
        prefix.append(prefix[-1] + -(-rec.n // CHUNK))
    return (torch.frombuffer(bytearray(arr), dtype=torch.uint8).to(device),
            torch.tensor(prefix, dtype=torch.int32).to(device))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_flag(name: str, flag: Optional[torch.Tensor],
                device: torch.device) -> None:
    if flag is not None and (flag.dtype != torch.bool or flag.numel() != 1
                             or flag.device != device):
        raise ValueError(f"{name}: found_inf must be one bool on {device}; "
                         f"got {tuple(flag.shape)} {flag.dtype} on "
                         f"{flag.device}")


def multi_tensor_update(spec: Spec, table: Table, lr: torch.Tensor,
                        update, found_inf: Optional[torch.Tensor] = None
                        ) -> None:
    """Step every record of ``table`` in place with the learning rate
    ``lr`` (a 0-d fp32 tensor on the table's device): parameters (or
    masters, and the 16-bit parameters from them), slots and powers.  On
    the card: the norms pass for LarsMomentum and Lamb, the update pass,
    and the powers' advance where the kind has powers; CPU tensors take
    :func:`multi_tensor_update_ref` with ``update``, the optimizer's
    ``_update``.  ``found_inf``, a bool on the table's device (or None),
    read on the device by every launch: when it is set nothing is
    written."""
    global NORM_LAUNCHES, POW_LAUNCHES
    _check_flag("multi_tensor_update", found_inf, table.device)
    if table.device.type == "cpu":
        multi_tensor_update_ref(spec, table.records, lr, update, found_inf)
        return
    if table.device.type != "cuda":
        raise ValueError(f"multi_tensor_update runs on CUDA or CPU, not "
                         f"{table.device}")
    if lr.dtype != torch.float32 or lr.numel() != 1 or \
            lr.device != table.device:
        raise ValueError(f"multi_tensor_update: the rate must be one fp32 "
                         f"on {table.device}")
    skip = _ptr(found_inf)
    lib = _kernel()
    kind = KINDS.index(spec.kind)
    hyper = (ctypes.c_float * 8)(*spec.hyper)
    n = len(table.records)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        if table.nchunks and spec.kind in _NORM_KINDS:
            _raise(lib, "mt_norms", lib.mt_norms(
                table.recs.data_ptr(), table.prefix.data_ptr(), n,
                table.nchunks, CHUNK, kind, table.types, hyper, spec.flags,
                table.partials.data_ptr(), table.norms.data_ptr(), skip,
                stream))
            NORM_LAUNCHES += 1
        if table.stages:
            _staged_update(lib, spec, table, lr, hyper, skip)
        elif table.nchunks:         # none: every tensor is empty
            _raise(lib, "mt_update", lib.mt_update(
                table.recs.data_ptr(), table.prefix.data_ptr(), n,
                table.nchunks, CHUNK, kind, table.types, lr.data_ptr(),
                hyper, spec.flags, _ptr(table.norms), skip, stream))
            LAUNCHES[spec.kind] = LAUNCHES.get(spec.kind, 0) + 1
            if any(_host_slot(s, table.device) for r in table.records
                   for s in r.slots):
                OFFLOAD_ROUTES["in_place"] += 1
        if spec.betas:
            b1, b2 = (tuple(spec.betas) + (1.0,))[:2]
            _raise(lib, "mt_pows", lib.mt_pows(table.recs.data_ptr(), n, b1,
                                               b2, skip, stream))
            POW_LAUNCHES += 1


def _staged_update(lib, spec: Spec, table: Table, lr, hyper, skip) -> None:
    """The update pass of an offloaded group, stage by stage (the module
    docstring): the copy in on one side stream, the kernel on the current
    stream, the copy out on the other side stream; a ring buffer is
    loaded again only once its copy out is done.  The current stream
    waits for both side streams at the end, so a step captured in a CUDA
    graph joins them.  Each stage counts as a launch of the update
    pass."""
    main = torch.cuda.current_stream(table.device)
    load, store = table.streams
    load.wait_stream(main)
    store.wait_stream(main)
    ring = len(table.ring)
    stored = []
    for i, st in enumerate(table.stages):
        with torch.cuda.stream(load):
            if i >= ring:
                load.wait_event(stored[i - ring])
            for host, dev in st.copies:
                dev.copy_(host, non_blocking=True)
            loaded = load.record_event()
        main.wait_event(loaded)
        _raise(lib, "mt_update", lib.mt_update(
            st.recs.data_ptr(), st.prefix.data_ptr(), st.n, st.nchunks,
            CHUNK, KINDS.index(spec.kind), table.types, lr.data_ptr(), hyper,
            spec.flags, None, skip, main.cuda_stream))
        LAUNCHES[spec.kind] = LAUNCHES.get(spec.kind, 0) + 1
        OFFLOAD_ROUTES["staged"] += 1
        updated = main.record_event()
        with torch.cuda.stream(store):
            store.wait_event(updated)
            for host, dev in st.copies:
                host.copy_(dev, non_blocking=True)
            stored.append(store.record_event())
    main.wait_stream(load)
    main.wait_stream(store)


def _raise(lib, what: str, err: int) -> None:
    if err:
        raise RuntimeError(
            f"multi_tensor_update: {what} launch failed: "
            f"{lib.multi_tensor_update_error_string(err).decode()} "
            f"(cudaError {err})")


# -- the plain version ---------------------------------------------------------
_POWS = ("beta1_pow", "beta2_pow")


def multi_tensor_update_ref(spec: Spec, records: Sequence[Record],
                            lr: torch.Tensor, update,
                            found_inf: Optional[torch.Tensor] = None
                            ) -> None:
    """Plain version of the kernel: ``update``, the optimizer's
    per-parameter ``_update`` (the per-leaf path's arithmetic), on copies
    of each record in fp32 (or wider for a wider parameter), each output
    rounded once to its type when it is stored, as the kernel stores it.
    Lamb's ratio reads its moments as their slots store them: the
    kernel's update pass reads them back.  AdamW takes the record's
    decay, which its decay function gave when the records were made.
    With ``found_inf`` set every output keeps its value
    (``torch.where`` on the device, no host read)."""
    _check(spec, records)
    _check_flag("multi_tensor_update_ref", found_inf,
                records[0].param.device)
    for r in records:
        w0 = r.target
        acc = torch.promote_types(w0.dtype, torch.float32)
        w = w0.to(acc)
        g = r.grad.to(acc)
        if r.reg == "L1Decay":
            g = g + r.reg_coeff * torch.sign(w)
        elif r.reg == "L2Decay":
            g = g + r.reg_coeff * w
        state = {k: t.to(acc) for k, t in zip(spec.slots, r.slots)}
        state.update(zip(_POWS, r.pows))
        kw = ({"stored": lambda t: t.to(w0.dtype).to(acc)}
              if spec.kind == "lamb" else
              {"decay": r.decay} if spec.kind == "adamw" else {})
        new_w, new_state = update(w, g, state, lr * r.lr_scale, r.name, **kw)
        for k, t in zip(spec.slots + _POWS, r.slots + r.pows):
            t.copy_(_kept(found_inf, t, new_state[k]))
        w0.copy_(_kept(found_inf, w0, new_w))
        if r.master is not None:
            r.param.copy_(_kept(found_inf, r.param, r.master))


def _kept(found_inf, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new``, or ``old`` where ``found_inf`` is set, in old's type."""
    new = new.to(old.dtype)
    return new if found_inf is None else torch.where(found_inf, old, new)


# -- the unscale pass ---------------------------------------------------------
# the gradient types the kernel takes, by its type code
GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class GradTable:
    """The gradients of one unscale launch: one type on one device,
    contiguous; on the card the device table of their records (``w`` the
    gradient), the prefix table of chunks and the launch's fold word (zero
    between launches), built here, outside any capture, and read by
    address."""

    def __init__(self, grads: Sequence[torch.Tensor]):
        self.device = grads[0].device
        self.dtype = grads[0].dtype
        for g in grads:
            if g.device != self.device or g.dtype != self.dtype:
                raise ValueError(f"multi_tensor_unscale: a group of "
                                 f"{self.dtype} on {self.device} holds a "
                                 f"{g.dtype} gradient on {g.device}")
            if not g.is_contiguous():
                raise ValueError("multi_tensor_unscale: gradients must be "
                                 "contiguous")
        self.n = len(grads)
        self.nchunks = sum(-(-g.numel() // CHUNK) for g in grads)
        self.recs = self.prefix = self.fold = None
        if self.device.type != "cuda":
            return
        if self.dtype not in GRAD_CODES:
            raise TypeError(f"multi_tensor_unscale: the kernel takes fp32, "
                            f"bf16 or fp16 gradients; got {self.dtype}")
        arr = (_Rec * self.n)()
        for rec, g in zip(arr, grads):
            rec.w, rec.n = g.data_ptr(), g.numel()
            rec.vec = int(g.data_ptr() % 16 == 0)
        self.recs, self.prefix = _upload("multi_tensor_unscale", arr,
                                         self.device)
        self.fold = torch.zeros(1, dtype=torch.int64, device=self.device)

    def tensors(self):
        """The device tensors a launch reads by address."""
        return tuple(t for t in (self.recs, self.prefix, self.fold)
                     if t is not None)


_DTYPE_OF = operator.attrgetter("dtype")


def grad_tables(grads: Sequence[torch.Tensor], cache: Optional[dict] = None
                ) -> Tuple[GradTable, ...]:
    """The gradients by type, one :class:`GradTable` each, in the order
    of their first member; kept in ``cache`` (a dict) keyed by the
    gradients' addresses, sizes and types (an address names its device),
    and rebuilt when the key changes."""
    key = (tuple(map(torch.Tensor.data_ptr, grads)),
           tuple(map(torch.Tensor.numel, grads)),
           tuple(map(_DTYPE_OF, grads)))
    if cache is not None and cache.get("key") == key:
        return cache["tables"]
    groups: Dict[Tuple, list] = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    tables = tuple(GradTable(group) for group in groups.values())
    if cache is not None:
        cache["key"], cache["tables"] = key, tables
    return tables


def multi_tensor_unscale(grads: Sequence[torch.Tensor], scale: torch.Tensor,
                         found_inf: torch.Tensor,
                         cache: Optional[dict] = None) -> None:
    """Every gradient times ``1/scale`` in place, in its type, and
    ``found_inf`` (a bool on their device) set to whether any element is
    not finite.  ``scale`` is an fp32 scalar on the gradients' device.
    CUDA tensors go through ``mt_unscale``, one launch per type (tables
    kept in ``cache``, see :func:`grad_tables`; the first launch writes
    the flag, the others OR into it); CPU tensors take
    :func:`multi_tensor_unscale_ref`."""
    global UNSCALE_LAUNCHES
    if not grads:
        found_inf.zero_()
        return
    device = grads[0].device
    _check_flag("multi_tensor_unscale", found_inf, device)
    if scale.dtype != torch.float32 or scale.numel() != 1 or \
            scale.device != device:
        raise ValueError(f"multi_tensor_unscale: the scale must be one fp32 "
                         f"on {device}")
    if device.type == "cpu":
        grad_tables(grads)                      # the same checks
        multi_tensor_unscale_ref(grads, scale, found_inf)
        return
    if device.type != "cuda":
        raise ValueError(f"multi_tensor_unscale runs on CUDA or CPU, not "
                         f"{device}")
    tables = grad_tables(grads, cache)
    lib = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        first = 1
        for t in tables:
            if not t.nchunks:                   # every gradient is empty
                continue
            _raise(lib, "mt_unscale", lib.mt_unscale(
                t.recs.data_ptr(), t.prefix.data_ptr(), t.n, t.nchunks,
                CHUNK, GRAD_CODES[t.dtype], scale.data_ptr(),
                found_inf.data_ptr(), t.fold.data_ptr(), first, stream))
            UNSCALE_LAUNCHES += 1
            first = 0
        if first:                               # nothing launched
            found_inf.zero_()


def multi_tensor_unscale_ref(grads: Sequence[torch.Tensor],
                             scale: torch.Tensor,
                             found_inf: torch.Tensor) -> None:
    """Plain version of the unscale pass: ``found_inf`` = any element not
    finite (read before the multiply), then each gradient times ``1/scale``
    rounded to its type, in place, as the reference's jitted step computes
    ``g * inv.astype(g.dtype)``."""
    inv = torch.reciprocal(scale.reshape(()).float())
    found = torch.zeros((), dtype=torch.bool, device=found_inf.device)
    for g in grads:
        found = found | ~torch.isfinite(g).all()
    for g in grads:
        g.mul_(inv.to(g.dtype))
    found_inf.copy_(found.reshape(found_inf.shape))
