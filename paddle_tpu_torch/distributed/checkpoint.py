"""Verified, atomic checkpoints — the counterpart of
``paddle_tpu/distributed/checkpoint.py``: :func:`save_state`,
:func:`load_state`, :func:`save_layer`, :func:`load_layer`,
:class:`AsyncCheckpointer`, :func:`verify_checkpoint`,
:func:`checkpoint_metadata`, :func:`derive_rank_seed`, :func:`wait_all`.

The commit protocol and its names are the reference's (:203-278): a tree
is written into ``<path>.tmp-commit``; every data file's size and sha256
go into ``_paddle_manifest.json`` (format 2, with the per-leaf layout),
the files and the manifest are fsynced, the directory is renamed into
place, and a ``_PADDLE_COMMITTED`` marker that pins the manifest's own
sha256 is written last.  Between the rename and the marker sit the
``ckpt.commit`` fail point and the ``ckpt.write`` chaos site.
:func:`verify_checkpoint` checks in the reference's order and with its
messages (:280-328), counting ``ckpt.verify_fail``.  So the reference's
``verify_checkpoint`` accepts a tree the port wrote, and both reject the
same corruptions.

The leaf files are the port's own: the reference stores its leaves
through orbax, which the port does not use.  Each leaf is one file,
``<index>.bin``, the raw bytes of its host copy in C order; the
manifest's layout entry of the leaf holds its path, shape, dtype, file
and kind (``"tensor"`` or ``"numpy"``).  bfloat16 has no numpy type and
is stored as its 16-bit pattern.  A tree is a nested dict / list of
``torch.Tensor`` leaves (any device), numpy arrays and scalars, and
Python numbers; :func:`load_state` returns it with CPU tensors and numpy
arrays.

:class:`AsyncCheckpointer` (the reference's :593-840, keep-N rotation,
background writes, verified restore with quarantine, GC that never
deletes the newest committed step) takes its snapshot without stalling
the loop: a tree's device tensors are copied into pinned host buffers on
a side stream, after an event recorded on the caller's stream, and the
caller's stream waits for the copy's event, so the next step's in-place
update cannot overwrite a tensor before it is read.  The writer thread
waits for that event and touches only host memory.  The staging buffers
are kept and reused, the most recently freed first, so a second block is
made only while two snapshots are in flight; at most two are, and a save
beyond that waits for the oldest write.  Pinned host
tensors (an offloaded optimizer's slots, which the card writes
asynchronously) are copied after the caller's stream is synchronised.

Single process, single device: ``load_state(reshard_mesh=...)``,
``load_state(shardings=...)`` and ``load_layer(mesh=...)`` raise until
the distributed port (``ROADMAP.md`` §A item 8, A5).
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..profiler import metrics as _metrics
from ..utils import chaos as _chaos
from ..utils import concurrency as _conc
from ..utils import resilience as _resilience

__all__ = ["save_state", "load_state", "save_layer", "load_layer",
           "AsyncCheckpointer", "wait_all", "verify_checkpoint",
           "checkpoint_metadata", "derive_rank_seed",
           "CheckpointCorruptError", "MANIFEST_NAME", "COMMITTED_NAME",
           "MANIFEST_FORMAT"]

MANIFEST_NAME = "_paddle_manifest.json"
COMMITTED_NAME = "_PADDLE_COMMITTED"
MANIFEST_FORMAT = 2   # v2: world_size / mesh_shape / per-leaf layout
FRAMEWORK = "paddle_tpu_torch"
# snapshots an AsyncCheckpointer holds in pinned memory at once
_STAGING_SLOTS = 2

_MESH = ("is not ported yet: the port checkpoints one process on one "
         "device (ROADMAP.md §A item 8, A5)")

_pending = []
# lazy: made at import, before any set_flags could arm the sanitizer
_plock = _conc.Lock(name="ckpt.pending", lazy=True)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint tree failed verification (torn write, flipped bytes,
    truncated file, or missing manifest/commit marker)."""


# ---------------------------------------------------------------------------
# manifest + atomic commit (the reference's :83-278)
# ---------------------------------------------------------------------------
def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _parallel(fn, items) -> list:
    """``[fn(x) for x in items]`` on up to 8 threads (hashing, file reads
    and writes and fsync release the interpreter lock)."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1, len(items)),
                            thread_name_prefix="paddle-ckpt-io") as ex:
        return list(ex.map(fn, items))


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems reject fsync on directories
    finally:
        os.close(fd)


def _walk_files(root: str):
    for base, _dirs, files in os.walk(root):
        for name in files:
            if name in (MANIFEST_NAME, COMMITTED_NAME):
                continue
            full = os.path.join(base, name)
            yield os.path.relpath(full, root), full


def _current_world() -> int:
    """The data-parallel world of this process: the launcher's
    PADDLE_TRAINERS_NUM when set, else ``torch.distributed``'s world size
    when a process group is up, else 1."""
    try:
        return int(os.environ["PADDLE_TRAINERS_NUM"])
    except (KeyError, ValueError):
        pass
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def derive_rank_seed(base_seed: int, rank: int) -> int:
    """Deterministic per-rank RNG seed for a cross-world resume (the
    reference's :131-146): rank 0 keeps the checkpointed seed, every other
    rank folds its new rank id in, crc32-keyed so that the derivation is
    the same in every process."""
    rank = int(rank)
    if rank == 0:
        return int(base_seed)
    import zlib
    fold = zlib.crc32(f"paddle_tpu.rank.{rank}".encode()) * 0x9E3779B1
    return (int(base_seed) ^ fold) & ((1 << 63) - 1)


def _write_manifest(root: str, step: Optional[int],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Hash every data file under ``root`` and write the manifest.
    Returns the manifest's own sha256 (recorded in the commit marker)."""
    def entry(item):
        rel, full = item
        meta = {"size": os.path.getsize(full), "sha256": _hash_file(full)}
        _fsync_file(full)  # data durable before the manifest claims it
        return rel, meta
    files = dict(_parallel(entry, sorted(_walk_files(root))))
    manifest = {
        "format": MANIFEST_FORMAT,
        "framework": FRAMEWORK,
        "step": None if step is None else int(step),
        "created": time.time(),
        "files": files,
    }
    if extra:
        manifest.update(extra)
    mpath = os.path.join(root, MANIFEST_NAME)
    blob = json.dumps(manifest, indent=1, sort_keys=True).encode()
    with open(mpath, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    return hashlib.sha256(blob).hexdigest()


def _commit(tmp: str, final: str, *, step: Optional[int],
            overwrite: bool, extra: Optional[Dict[str, Any]] = None
            ) -> float:
    """tmp dir -> fsync -> rename -> COMMITTED marker (the atomic-commit
    sequence; a crash at any point leaves either the old checkpoint, an
    intact tree stranded at ``final + '.old'``, or a detectably-
    uncommitted tree — never a silently torn one).  Returns the seconds
    the manifest took (its files' sha256s and fsyncs)."""
    t0 = time.perf_counter()
    manifest_sha = _write_manifest(tmp, step, extra)
    hashed = time.perf_counter() - t0
    _fsync_dir(tmp)
    aside = None
    if os.path.exists(final):
        if not overwrite:
            raise FileExistsError(final)
        aside = final + ".old"
        if os.path.exists(aside):
            shutil.rmtree(aside, ignore_errors=True)
        os.rename(final, aside)
    try:
        os.rename(tmp, final)
    except OSError:
        if os.path.exists(os.path.join(final, COMMITTED_NAME)):
            return hashed   # concurrent committer won the race
        if aside is not None and not os.path.exists(final):
            os.rename(aside, final)   # roll the old tree back in
        raise
    _fsync_dir(os.path.dirname(final))
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    # between the rename above and the marker below is the torn window a
    # verified load must detect; both hooks let tests/chaos cut it open
    _resilience.fail_point("ckpt.commit")
    if _chaos.active:
        _chaos.hit("ckpt.write")
    marker = {"step": None if step is None else int(step),
              "manifest_sha256": manifest_sha,
              "committed": time.time()}
    mpath = os.path.join(final, COMMITTED_NAME)
    with open(mpath, "w") as f:
        json.dump(marker, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(final)
    from ..profiler import flight as _flight
    if _flight.active:
        _flight.note("ckpt", "commit", step=marker["step"],
                     path=os.path.basename(final))
    return hashed


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Re-hash a checkpoint tree against its manifest.  Returns the
    manifest dict; raises :class:`CheckpointCorruptError` naming the
    first offending file (and counts ``ckpt.verify_fail``)."""
    path = os.path.abspath(path)

    def _fail(reason):
        _metrics.counter("ckpt.verify_fail",
                         "checkpoints rejected by manifest "
                         "verification").inc()
        raise CheckpointCorruptError(f"checkpoint {path}: {reason}")

    if not os.path.isdir(path):
        _fail("not a directory")
    if not os.path.exists(os.path.join(path, COMMITTED_NAME)):
        _fail(f"no {COMMITTED_NAME} marker (interrupted commit)")
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        _fail(f"missing {MANIFEST_NAME}")
    try:
        with open(mpath, "rb") as f:
            manifest_blob = f.read()
        manifest = json.loads(manifest_blob)
    except (OSError, json.JSONDecodeError) as e:
        _fail(f"unreadable manifest ({e})")
    # the commit marker pins the manifest's own hash: a manifest that was
    # rewritten (or copied in from another step) after commit is caught
    # here even when its entries are self-consistent
    try:
        with open(os.path.join(path, COMMITTED_NAME)) as f:
            marker = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        _fail(f"unreadable {COMMITTED_NAME} marker ({e})")
    expect = marker.get("manifest_sha256")
    if expect and hashlib.sha256(manifest_blob).hexdigest() != expect:
        _fail("manifest does not match the hash recorded at commit "
              "(manifest tampered or replaced)")
    entries = list(manifest.get("files", {}).items())
    # the hashes of the files whose size is right, on several threads; the
    # checks below still name the first offending file in manifest order
    hashable = [os.path.join(path, rel) for rel, meta in entries
                if os.path.isfile(os.path.join(path, rel))
                and os.path.getsize(os.path.join(path, rel)) == meta["size"]]
    digests = dict(zip(hashable, _parallel(_hash_file, hashable)))
    for rel, meta in entries:
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            _fail(f"missing file {rel!r}")
        size = os.path.getsize(full)
        if size != meta["size"]:
            _fail(f"file {rel!r} truncated/resized "
                  f"({size} bytes, manifest says {meta['size']})")
        if digests[full] != meta["sha256"]:
            _fail(f"file {rel!r} checksum mismatch (flipped bytes)")
    return manifest


def checkpoint_metadata(path: str) -> Optional[Dict[str, Any]]:
    """The manifest's step/framework metadata, or None if absent."""
    mpath = os.path.join(os.path.abspath(path), MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return {k: manifest.get(k)
            for k in ("step", "framework", "format", "created",
                      "world_size", "mesh_shape")}


# ---------------------------------------------------------------------------
# trees and leaves
# ---------------------------------------------------------------------------
def _flatten(tree, path=()) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf)]`` in the reference's pytree order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (i,))
        return out
    return [(path, tree)]


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _insert_path(root, path, value):
    """Place ``value`` into the nested dict/list skeleton at ``path``
    (str entries are dict keys, int entries are list indices)."""
    node = root
    for i, key in enumerate(path):
        last = i == len(path) - 1
        child_is_seq = not last and isinstance(path[i + 1], int)
        if isinstance(key, int):
            while len(node) <= key:
                node.append(None)
            if last:
                node[key] = value
            else:
                if node[key] is None:
                    node[key] = [] if child_is_seq else {}
                node = node[key]
        else:
            if last:
                node[key] = value
            else:
                node = node.setdefault(key, [] if child_is_seq else {})


_TORCH_TYPES = {str(t).split(".")[1]: t for t in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[1]
    return str(leaf.dtype)


def _as_host(leaf):
    """A leaf as it is written: a CPU tensor or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, dtype=np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int64)
    if isinstance(leaf, float):
        return np.asarray(leaf, dtype=np.float64)
    return np.asarray(leaf)


def _host_copy(leaf):
    """An owned host copy of ``leaf`` (a device tensor waits for the card;
    the asynchronous checkpointer stages instead, see :class:`_Staging`)."""
    leaf = _as_host(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _leaf_bytes(leaf) -> np.ndarray:
    """The leaf's bytes in C order, as a uint8 array (no copy where it
    lies contiguous)."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).numpy() if flat.numel() else \
            np.zeros(0, np.uint8)
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def _write_leaves(root: str, entries) -> Tuple[List[dict], int]:
    """Write each (path, host leaf) as ``<index>.bin`` under ``root``;
    returns the layout entries and the bytes written."""
    def write(item):
        name, leaf = item
        data = _leaf_bytes(leaf)
        with open(os.path.join(root, name), "wb") as f:
            f.write(memoryview(data))
        return data.nbytes
    names = [f"{i:05d}.bin" for i in range(len(entries))]
    total = sum(_parallel(write, zip(names, (v for _, v in entries))))
    layout = [{"path": list(path), "key": _keystr(path),
               "shape": [int(s) for s in leaf.shape],
               "dtype": _dtype_name(leaf), "spec": None, "file": name,
               "kind": ("tensor" if isinstance(leaf, torch.Tensor)
                        else "numpy")}
              for name, (path, leaf) in zip(names, entries)]
    return layout, total


def _read_leaf(root: str, entry: dict):
    """One leaf back from its file: a CPU tensor or a numpy array."""
    full = os.path.join(root, entry["file"])
    shape, dtype = tuple(entry["shape"]), entry["dtype"]
    if entry.get("kind") == "tensor":
        t = _TORCH_TYPES[dtype]
        raw = np.fromfile(full, dtype=np.uint8)
        out = torch.from_numpy(raw).view(t) if raw.size else \
            torch.empty(0, dtype=t)
        return out.reshape(shape)
    return np.fromfile(full, dtype=np.dtype(dtype)).reshape(shape)


def _tmp_path(path: str) -> str:
    """Stable (pid-free) tmp name, cleared when a crashed earlier attempt
    left it (the reference's :346-360)."""
    tmp = f"{path}.tmp-commit"
    try:
        if time.time() - os.path.getmtime(tmp) > 60.0:
            shutil.rmtree(tmp, ignore_errors=True)
    except OSError:
        pass
    return tmp


def _save_entries(path: str, entries, *, step: Optional[int],
                  overwrite: bool) -> Dict[str, float]:
    """Write host ``entries`` as a committed tree at ``path``; returns the
    write's seconds (leaves, manifest with its hashes, commit) and bytes."""
    t0 = time.perf_counter()
    tmp = _tmp_path(path)
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    layout, nbytes = _write_leaves(tmp, entries)
    t1 = time.perf_counter()
    extra = {"world_size": _current_world(), "mesh_shape": None,
             "layout": layout}
    hashed = _commit(tmp, path, step=step, overwrite=overwrite, extra=extra)
    t2 = time.perf_counter()
    return {"bytes": nbytes, "write_s": t1 - t0,
            "manifest_s": hashed,
            "commit_s": t2 - t1, "total_s": t2 - t0}


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
def save_state(path: str, tree: Dict[str, Any], *, overwrite: bool = True,
               use_async: bool = False, step: Optional[int] = None):
    """Save a tree of tensors and arrays with a verified atomic commit.
    The leaves are copied to the host before it returns; with
    ``use_async`` the files are written on a background thread and
    :func:`wait_all` (which finalizes the commit) joins it."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    _flush_pending(path)   # a prior async save to this path must land
    entries = [(p, _host_copy(v)) for p, v in _flatten(tree)]
    if not use_async:
        _save_entries(path, entries, step=step, overwrite=overwrite)
        return None
    box = {}

    def work():
        try:
            box["stats"] = _save_entries(path, entries, step=step,
                                         overwrite=overwrite)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait_all
            box["error"] = e
    t = _conc.spawn(work, name="paddle-ckpt-save")
    with _plock:
        _pending.append((t, box, path))
    return t


def _finalize(entry):
    t, box, _path = entry
    t.join()
    if "error" in box:
        raise box["error"]


def _flush_pending(path: str):
    """Land any pending async save targeting ``path`` before a new save
    reuses its commit tmp tree."""
    with _plock:
        mine = [e for e in _pending if e[2] == path]
        _pending[:] = [e for e in _pending if e[2] != path]
    for entry in mine:
        _finalize(entry)


def wait_all():
    """Block until every async save has landed AND committed.  One failing
    commit never strands the others: every pending save is finalized and
    the first error re-raised afterwards."""
    with _plock:
        pending, _pending[:] = list(_pending), []
    first_err = None
    for entry in pending:
        try:
            _finalize(entry)
        except BaseException as e:  # noqa: BLE001 — finalize the rest
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _read_manifest(path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: unreadable manifest ({e})") from None


def _check_template(path: str, layout, template) -> None:
    """The reference restores against a template and raises where the
    stored tree lacks its structure; the port checks that every leaf of
    ``template`` is stored, with its shape."""
    got = {tuple(e["path"]): tuple(e["shape"]) for e in layout}
    for p, v in _flatten(template):
        shape = tuple(v.shape) if isinstance(v, torch.Tensor) else \
            tuple(np.shape(v))
        if p not in got:
            raise ValueError(f"checkpoint {path} does not match the "
                             f"template: it lacks {_keystr(p)}")
        if got[p] != shape:
            raise ValueError(f"checkpoint {path}: {_keystr(p)} has shape "
                             f"{got[p]}, the template {shape}")


def load_state(path: str, template: Optional[Dict[str, Any]] = None,
               shardings: Optional[Dict[str, Any]] = None, *,
               verify: bool = False, reshard_mesh=None):
    """Restore a tree written by :func:`save_state` (CPU tensors, numpy
    arrays).  Every leaf of ``template`` must be stored, with its shape
    (``ValueError`` otherwise).  With ``verify=True`` the tree is
    checked against its manifest first and torn or corrupt checkpoints
    raise :class:`CheckpointCorruptError`."""
    if reshard_mesh is not None:
        raise NotImplementedError(f"load_state(reshard_mesh=...) {_MESH}")
    if shardings is not None:
        raise NotImplementedError(f"load_state(shardings=...) {_MESH}")
    path = os.path.abspath(path)
    if verify:
        verify_checkpoint(path)
    manifest = _read_manifest(path)
    layout = manifest.get("layout") or []
    if manifest.get("framework") != FRAMEWORK or any(
            "file" not in e for e in layout):
        raise ValueError(
            f"checkpoint {path} was written by "
            f"{manifest.get('framework')!r}, whose leaf files the port does "
            f"not read (it writes one raw file per leaf, {FRAMEWORK!r})")
    if template is not None:
        _check_template(path, layout, template)
    if not layout:
        return {}
    root: Any = [] if isinstance(layout[0]["path"][0], int) else {}
    leaves = _parallel(lambda e: _read_leaf(path, e), layout)
    for e, leaf in zip(layout, leaves):
        _insert_path(root, e["path"], leaf)
    return root


@torch.no_grad()
def copy_into(live: Dict[str, torch.Tensor], restored: Dict[str, Any],
              what: str = "state") -> None:
    """Copy each restored leaf into the live tensor of its name, in place
    (a captured step keeps reading the same addresses)."""
    missing = sorted(set(live) - set(restored))
    if missing:
        raise KeyError(f"the checkpoint's {what} lacks {missing[:5]}")
    for name, t in live.items():
        t.copy_(torch.as_tensor(restored[name]).to(dtype=t.dtype))


def save_layer(path: str, layer, optimizer=None, *, use_async: bool = False,
               step: Optional[int] = None):
    """Checkpoint a module (parameters and buffers by name) and optionally
    its optimizer's functional state."""
    from ..nn.layer_base import torch_view
    view = torch_view(layer)
    tree = {"params": dict(view.named_parameters()),
            "buffers": dict(view.named_buffers())}
    if optimizer is not None:
        tree["opt"] = optimizer.functional_state()
    return save_state(path, tree, use_async=use_async, step=step)


def load_layer(path: str, layer, optimizer=None, *, mesh=None,
               verify: bool = False):
    """Restore into a live module (and optimizer), in place."""
    if mesh is not None:
        raise NotImplementedError(f"load_layer(mesh=...) {_MESH}")
    restored = load_state(path, verify=verify)
    from ..nn.layer_base import torch_view
    view = torch_view(layer)
    copy_into(dict(view.named_parameters()), restored["params"],
              "parameters")
    copy_into(dict(view.named_buffers()), restored.get("buffers", {}),
              "buffers")
    if optimizer is not None and "opt" in restored:
        optimizer.load_functional_state(restored["opt"])
    return restored


# ---------------------------------------------------------------------------
# step-managed async checkpointing
# ---------------------------------------------------------------------------
class _Staging:
    """One snapshot's host buffers: views into one pinned block (one host
    allocation of the tree's bytes, kept across saves and made again only
    when the tree's leaves change)."""

    ALIGN = 64

    def __init__(self):
        self.key = None
        self.views: Dict[tuple, torch.Tensor] = {}

    def prepare(self, tensors) -> None:
        """Lay out ``[(path, tensor)]`` in the block."""
        key = tuple((p, tuple(t.shape), t.dtype) for p, t in tensors)
        if key == self.key:
            return
        offsets, total = [], 0
        for _, t in tensors:
            offsets.append(total)
            n = t.numel() * t.element_size()
            total += -(-n // self.ALIGN) * self.ALIGN
        self.views = {}               # the old block goes first
        block = torch.empty(max(total, 1), dtype=torch.uint8,
                            pin_memory=torch.cuda.is_available())
        for (p, t), off in zip(tensors, offsets):
            n = t.numel() * t.element_size()
            self.views[p] = block[off:off + n].view(t.dtype).view(t.shape)
        self.key = key

    def release(self) -> None:
        self.key, self.views = None, {}


class AsyncCheckpointer:
    """Step-managed async checkpointing: keep-N rotation + background
    writes + verified restore (the reference's :593-840).

    Layout: ``directory/<step>/`` per step, each a committed
    :func:`save_state` tree.  ``save`` snapshots the tree to pinned host
    memory in the caller's thread, ordered on the card against the next
    step (see the module docstring), and commits on a single background
    writer; a failed write is counted (``ckpt.write_fail``) and warned,
    never raised into the training loop.  ``restore()`` walks steps
    newest-first, quarantines any that fail verification
    (``directory/_quarantine/<step>``, counted as ``ckpt.quarantined``)
    and loads the newest intact tree.  GC keeps ``max_to_keep`` committed
    steps and never deletes the last one.

    :attr:`stats` holds one record per save: the host seconds ``save``
    spent (``snapshot_s``), the bytes, and the writer's seconds (leaves,
    manifest with its sha256s, commit, total).
    """

    QUARANTINE = "_quarantine"

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        from concurrent.futures import ThreadPoolExecutor
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max(1, int(max_to_keep))
        self._interval = max(1, int(save_interval_steps))
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="paddle-ckpt")
        self._futures = []
        self._last_requested: Optional[int] = None
        self.last_error: Optional[BaseException] = None
        self.last_restored_meta: Optional[Dict[str, Any]] = None
        # last in, first out: a save takes the block the previous one
        # freed, and reaches the unallocated one only while a write is
        # still in flight
        self._free: "queue.LifoQueue[_Staging]" = queue.LifoQueue()
        for _ in range(_STAGING_SLOTS):
            self._free.put(_Staging())
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self.stats: List[Dict[str, Any]] = []

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _step_dirs(self):
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def _committed_steps(self):
        return [s for s in self._step_dirs()
                if os.path.exists(os.path.join(self._step_dir(s),
                                               COMMITTED_NAME))]

    # -- write path --------------------------------------------------------
    def want_save(self, step: int) -> bool:
        """True when :meth:`save` at ``step`` would actually write
        (outside the save-interval window).  ``Model.fit`` checks this
        before building the state tree, so interval steps cost nothing
        and never touch the device."""
        step = int(step)
        return self._last_requested is None or \
            step - self._last_requested >= self._interval

    def _stream(self, dev: torch.device):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _snapshot(self, tree, staging: _Staging):
        """``(host entries, copy event or None)``: the device tensors are
        copied on a side stream into ``staging`` (the caller's stream
        waits for the copy before its next work), pinned host tensors
        after the caller's stream is synchronised, the rest at once."""
        entries = _flatten(tree)
        out, done, synced = [], None, False
        tensors = [(p, v.detach()) for p, v in entries
                   if isinstance(v, torch.Tensor)]
        staging.prepare(tensors)
        dev = next((v.device for _, v in tensors if v.is_cuda), None)
        if dev is not None:
            cur = torch.cuda.current_stream(dev)
            side = self._stream(dev)
            side.wait_stream(cur)
        for path, v in entries:
            if not isinstance(v, torch.Tensor):
                out.append((path, _host_copy(v)))
                continue
            v = v.detach()
            buf = staging.views[path]
            if v.is_cuda:
                if v.device != dev:
                    raise ValueError(f"checkpoint leaf {_keystr(path)} is on "
                                     f"{v.device}, the tree's others on "
                                     f"{dev}: one device a tree")
                with torch.cuda.stream(side):
                    buf.copy_(v, non_blocking=True)
            else:
                if dev is not None and not synced and v.is_pinned():
                    cur.synchronize()   # the card writes these async
                    synced = True
                buf.copy_(v)
            out.append((path, buf))
        if dev is not None:
            done = torch.cuda.Event()
            done.record(side)
            cur.wait_event(done)
        return out, done

    def save(self, step: int, tree: Dict[str, Any]) -> bool:
        """Queue an async save of ``tree`` at ``step``.  Returns False
        (and writes nothing) inside the save-interval window."""
        step = int(step)
        if not self.want_save(step):   # ONE copy of the window logic
            return False
        t0 = time.perf_counter()
        self._last_requested = step
        self._futures = [f for f in self._futures if not f.done()]
        staging = self._free.get()     # bounded: waits for the oldest write
        try:
            entries, done = self._snapshot(tree, staging)
        except BaseException:
            self._free.put(staging)
            raise
        record = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.stats.append(record)
        self._futures.append(self._pool.submit(
            self._write, step, entries, done, staging, record))
        return True

    def _write(self, step: int, entries, done, staging, record):
        try:
            if done is not None:
                done.synchronize()
            record.update(_save_entries(self._step_dir(step), entries,
                                        step=step, overwrite=True))
            self._gc()
        except BaseException as e:  # noqa: BLE001 — writer must survive
            self.last_error = e
            _metrics.counter("ckpt.write_fail",
                             "async checkpoint writes that failed "
                             "before commit").inc()
            from ..profiler import flight as _flight
            if _flight.active:
                _flight.note("ckpt", "write_fail", step=step,
                             error=f"{type(e).__name__}: {e}")
            warnings.warn(f"checkpoint save for step {step} failed "
                          f"({e!r}); the previous intact step remains "
                          f"restorable")
        finally:
            self._free.put(staging)

    def _gc(self):
        """Rotate committed steps down to ``max_to_keep`` and clear torn
        leftovers older than the newest commit (the reference's
        :707-744)."""
        committed = self._committed_steps()
        victims = committed[:-self._max_to_keep] if \
            len(committed) > self._max_to_keep else []
        for s in victims:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        if committed:
            newest = committed[-1]
            for s in self._step_dirs():
                if s < newest and s not in committed:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
        now = time.time()
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for name in names:
            if ".tmp-commit" not in name and not name.endswith(".old"):
                continue
            full = os.path.join(self.directory, name)
            try:
                if now - os.path.getmtime(full) > 300.0:
                    shutil.rmtree(full, ignore_errors=True)
            except OSError:
                pass

    # -- read path ---------------------------------------------------------
    def _quarantine(self, step: int, err: BaseException):
        qroot = os.path.join(self.directory, self.QUARANTINE)
        os.makedirs(qroot, exist_ok=True)
        dst = os.path.join(qroot, str(step))
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        try:
            os.rename(self._step_dir(step), dst)
        except OSError:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        _metrics.counter("ckpt.quarantined",
                         "corrupt checkpoint steps moved aside by "
                         "restore").inc()
        warnings.warn(f"checkpoint step {step} failed verification "
                      f"({err}); quarantined under {qroot}")

    def _surface_meta(self, step: int, *, template, shardings):
        """Record and announce the manifest metadata of the step about to
        be restored (``last_restored_meta``), and refuse a blind restore
        of a tree saved at another world size (the reference's
        :763-794)."""
        meta = checkpoint_metadata(self._step_dir(step)) or {}
        meta.setdefault("step", step)
        self.last_restored_meta = meta
        fmt = int(meta.get("format") or 1)
        world = meta.get("world_size")
        mesh = meta.get("mesh_shape")
        warnings.warn(
            f"checkpoint restore: step {meta.get('step')} from "
            f"{self.directory} (manifest v{fmt}"
            + (f", saved at world {world}" if world is not None else "")
            + (f", mesh {mesh}" if mesh else "") + ")")
        if template is not None or shardings is not None or fmt < 2:
            return
        cur = _current_world()
        if mesh or (world is not None and int(world) != cur):
            raise ValueError(
                f"checkpoint step {meta.get('step')} under "
                f"{self.directory} was saved at world {world}"
                + (f" on mesh {mesh}" if mesh else "")
                + f" but this process runs at world {cur}: the tree "
                f"needs resharding, which a template-less restore "
                f"can't express — pass template=/shardings=, or use "
                f"checkpoint.load_state(path, reshard_mesh=...) for "
                f"the automatic manifest-v2 reshard path")

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None,
                shardings: Optional[Dict[str, Any]] = None, *,
                verify: bool = True):
        """Restore ``step`` (or, when None, the newest step that passes
        verification — corrupt/torn steps are quarantined and skipped).
        Raises :class:`CheckpointCorruptError` when nothing intact
        remains."""
        if step is not None:
            self._surface_meta(int(step), template=template,
                               shardings=shardings)
            return load_state(self._step_dir(step), template, shardings,
                              verify=verify)
        candidates = sorted(self._step_dirs(), reverse=True)
        for s in candidates:
            if verify:
                try:
                    verify_checkpoint(self._step_dir(s))
                except CheckpointCorruptError as e:
                    self._quarantine(s, e)
                    continue
            self._surface_meta(s, template=template, shardings=shardings)
            return load_state(self._step_dir(s), template, shardings,
                              verify=False)
        raise CheckpointCorruptError(
            f"no intact checkpoint under {self.directory}")

    def latest_step(self) -> Optional[int]:
        committed = self._committed_steps()
        return committed[-1] if committed else None

    def all_steps(self):
        return self._committed_steps()

    def wait_until_finished(self):
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()  # _write never raises; .result() just joins

    def close(self):
        """Join the writer and let go of the pinned staging blocks."""
        self.wait_until_finished()
        self._pool.shutdown(wait=True)
        while not self._free.empty():
            self._free.get().release()
        for _ in range(_STAGING_SLOTS):
            self._free.put(_Staging())
