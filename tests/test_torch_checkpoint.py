"""``paddle_tpu_torch.distributed.checkpoint`` against the reference's
``paddle_tpu/distributed/checkpoint.py``.

The port writes its own leaf files (one raw file per leaf) under the
reference's commit protocol, so: the reference's ``verify_checkpoint`` and
``checkpoint_metadata`` accept a tree the port wrote; the corruption
matrix of ``tests/test_checkpoint_corruption.py:70-74`` (truncated leaf,
flipped bytes, missing manifest, interrupted rename) and a manifest
rewritten after commit are rejected by both packages' ``verify_checkpoint``
on the same port-written tree; and the save / corrupt / restore sequences
of ``tests/test_checkpoint_corruption.py:121-203`` leave both packages'
``AsyncCheckpointer`` with the same committed steps, quarantined steps,
restored step and counters.  Trees are made from seeded numpy arrays.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import checkpoint as rckpt
from paddle_tpu.profiler import metrics as rmetrics
from paddle_tpu.utils import chaos as rchaos
from paddle_tpu.utils import resilience as rresilience

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.utils import chaos, resilience


@pytest.fixture(autouse=True)
def _teardown():
    yield
    for c in (chaos, rchaos):
        c.reset()
    for r in (resilience, rresilience):
        r.clear_fail_points()


def _port_tree(v: float):
    """The reference test's tree (:26-28) in torch, plus leaves of every
    type the port writes."""
    rng = np.random.RandomState(int(v))
    return {"w": torch.full((16, 16), v), "b": torch.full((4,), v),
            "step": torch.tensor(int(v), dtype=torch.int32),
            "h": torch.from_numpy(rng.randn(3, 5).astype(np.float32)
                                  ).to(torch.bfloat16),
            "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
            "mask": torch.from_numpy(rng.rand(2, 3) > 0.5),
            "meta": {"n": np.int64(v), "seed": np.uint64(2**63 + 5),
                     "lst": [np.float64(v), 3]}}


def _ref_tree(v: float):
    return {"w": jnp.full((16, 16), v), "b": jnp.full((4,), v),
            "step": jnp.asarray(int(v), jnp.int32)}


def _largest_data_file(path):
    best, size = None, -1
    for base, _dirs, files in os.walk(path):
        for name in files:
            if name in (ckpt.MANIFEST_NAME, ckpt.COMMITTED_NAME):
                continue
            full = os.path.join(base, name)
            if os.path.getsize(full) > size:
                best, size = full, os.path.getsize(full)
    assert best is not None
    return best


def _corrupt_truncate(path):
    f = _largest_data_file(path)
    data = open(f, "rb").read()
    with open(f, "wb") as out:
        out.write(data[: max(1, len(data) // 2)])


def _corrupt_flip(path):
    f = _largest_data_file(path)
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(f, "wb") as out:
        out.write(bytes(data))


def _corrupt_no_manifest(path):
    os.unlink(os.path.join(path, ckpt.MANIFEST_NAME))


def _corrupt_uncommitted(path):
    os.unlink(os.path.join(path, ckpt.COMMITTED_NAME))


def _corrupt_manifest_rewritten(path):
    """A self-consistent manifest rewritten after the commit (the marker
    pins the old one's hash, the reference's :304-309)."""
    mpath = os.path.join(path, ckpt.MANIFEST_NAME)
    manifest = json.load(open(mpath))
    manifest["step"] = 999
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


CORRUPTIONS = {"truncated_leaf": _corrupt_truncate,
               "flipped_bytes": _corrupt_flip,
               "missing_manifest": _corrupt_no_manifest,
               "interrupted_rename": _corrupt_uncommitted,
               "manifest_rewritten": _corrupt_manifest_rewritten}


def _same_tree(a, b):
    assert type(a) is type(b) or isinstance(a, (np.ndarray, np.generic))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the port's trees under the reference's verification
# ---------------------------------------------------------------------------
def test_reference_verify_accepts_a_port_tree(tmp_path):
    path = str(tmp_path / "c")
    tree = _port_tree(3.0)
    ckpt.save_state(path, tree, step=3)
    mine, theirs = ckpt.verify_checkpoint(path), rckpt.verify_checkpoint(path)
    assert mine == theirs
    assert mine["format"] == rckpt.MANIFEST_FORMAT == 2
    meta = rckpt.checkpoint_metadata(path)
    assert meta == ckpt.checkpoint_metadata(path)
    assert meta["step"] == 3 and meta["framework"] == "paddle_tpu_torch"
    assert meta["world_size"] == 1 and meta["mesh_shape"] is None
    marker = json.load(open(os.path.join(path, rckpt.COMMITTED_NAME)))
    assert marker["step"] == 3 and marker["manifest_sha256"]
    # the layout is the reference's v2 record, with the port's file names
    layout = {e["key"]: e for e in mine["layout"]}
    assert layout["['h']"]["dtype"] == "bfloat16"
    assert layout["['h']"]["shape"] == [3, 5]
    assert layout["['meta']['lst'][1]"]["path"] == ["meta", "lst", 1]
    back = ckpt.load_state(path, verify=True)
    _same_tree({k: v for k, v in tree.items() if k != "meta"},
               {k: v for k, v in back.items() if k != "meta"})
    assert back["meta"]["seed"] == np.uint64(2**63 + 5)
    assert back["meta"]["lst"][1] == 3
    assert back["h"].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_both_reject_the_same_corruption(tmp_path, kind):
    path = str(tmp_path / "c")
    ckpt.save_state(path, _port_tree(3.0), step=3)
    rckpt.verify_checkpoint(path)
    CORRUPTIONS[kind](path)
    messages = []
    for mod, met in ((ckpt, metrics), (rckpt, rmetrics)):
        before = met.counter("ckpt.verify_fail").value
        with pytest.raises(mod.CheckpointCorruptError) as e:
            mod.verify_checkpoint(path)
        assert met.counter("ckpt.verify_fail").value == before + 1
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_state(path, verify=True)


def test_interrupted_commit_leaves_a_tree_both_reject(tmp_path):
    """The ``ckpt.commit`` fail point between the rename and the marker
    (the reference test's :95-112): an uncommitted tree both packages
    reject; a later save over the same path heals it."""
    path = str(tmp_path / "c")
    resilience.arm_fail_point("ckpt.commit")
    with pytest.raises(resilience.FailPointError):
        ckpt.save_state(path, _port_tree(1.0), step=1)
    assert os.path.isdir(path)
    for mod in (ckpt, rckpt):
        with pytest.raises(mod.CheckpointCorruptError,
                           match="interrupted commit"):
            mod.verify_checkpoint(path)
    ckpt.save_state(path, _port_tree(2.0), step=2)
    back = ckpt.load_state(path, verify=True)
    assert torch.equal(back["w"], torch.full((16, 16), 2.0))
    rckpt.verify_checkpoint(path)


def test_the_ckpt_write_chaos_site_fires(tmp_path):
    chaos.configure("ckpt.write:fail@1", seed=0)
    with pytest.raises(chaos.ChaosError):
        ckpt.save_state(str(tmp_path / "c"), {"w": torch.ones(2)})
    assert chaos.call_count("ckpt.write") == 1


def test_load_checks_template_and_rejects_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "c")
    ckpt.save_state(path, _port_tree(1.0), step=1)
    ckpt.load_state(path, template={"w": torch.zeros(16, 16)})
    with pytest.raises(ValueError, match="lacks"):
        ckpt.load_state(path, template={"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="has shape"):
        ckpt.load_state(path, template={"w": torch.zeros(4)})
    with pytest.raises(NotImplementedError, match="A5"):
        ckpt.load_state(path, reshard_mesh=object())
    with pytest.raises(NotImplementedError, match="A5"):
        ckpt.load_layer(path, torch.nn.Linear(2, 2), mesh=object())
    # a tree the reference wrote through orbax
    rpath = str(tmp_path / "r")
    rckpt.save_state(rpath, _ref_tree(1.0), step=1)
    ckpt.verify_checkpoint(rpath)
    with pytest.raises(ValueError, match="paddle_tpu"):
        ckpt.load_state(rpath)


def test_async_save_state_and_wait_all(tmp_path):
    paths = [str(tmp_path / f"c{i}") for i in range(3)]
    for i, p in enumerate(paths):
        ckpt.save_state(p, _port_tree(float(i)), step=i, use_async=True)
    ckpt.wait_all()
    for i, p in enumerate(paths):
        assert rckpt.verify_checkpoint(p)["step"] == i


def test_checkpointer_reuses_the_freed_staging_block(tmp_path):
    # saves whose writes do not overlap share one staging block; a second
    # is laid out only while the first one's write is still in flight
    mgr = ckpt.AsyncCheckpointer(str(tmp_path))

    def laid_out():
        return [s for s in mgr._free.queue if s.key is not None]

    for step in (1, 2, 3):
        mgr.save(step, _port_tree(float(step)))
        mgr.wait_until_finished()
        assert len(laid_out()) == 1
    first = laid_out()[0]
    mgr._pool.submit(mgr._free.get).result()   # a write in flight holds it
    mgr.save(4, _port_tree(4.0))
    mgr.wait_until_finished()
    assert first not in laid_out() and len(laid_out()) == 1
    mgr.close()
    assert mgr.all_steps() == [2, 3, 4]


def test_save_and_load_layer_with_its_optimizer(tmp_path):
    torch.manual_seed(0)
    net, twin = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    opts = [AdamW(0.1, parameters=n.parameters()) for n in (net, twin)]
    for _ in range(2):
        net(torch.ones(2, 4)).sum().backward()
        opts[0].step()
    path = str(tmp_path / "layer")
    ckpt.save_layer(path, net, opts[0], step=2)
    rckpt.verify_checkpoint(path)
    ckpt.load_layer(path, twin, opts[1], verify=True)
    assert torch.equal(net.weight, twin.weight)
    a, b = opts[0].functional_state(), opts[1].functional_state()
    assert a["step"] == b["step"] == 2
    for name, slots in a["slots"].items():
        for k, v in slots.items():
            assert torch.equal(v, b["slots"][name][k]), (name, k)


def test_derive_rank_seed_is_the_references():
    rng = np.random.RandomState(0)
    seeds = [0, 1, 2**31 - 1, 2**63 - 1] + [int(s) for s in
                                             rng.randint(0, 2**62, 4)]
    for s in seeds:
        for rank in range(8):
            assert ckpt.derive_rank_seed(s, rank) == \
                rckpt.derive_rank_seed(s, rank)


# ---------------------------------------------------------------------------
# AsyncCheckpointer: the reference test's sequences (:121-203) on both
# ---------------------------------------------------------------------------
PACKAGES = {"port": (ckpt, metrics, chaos, _port_tree),
            "reference": (rckpt, rmetrics, rchaos, _ref_tree)}
COUNTERS = ("ckpt.quarantined", "ckpt.write_fail", "ckpt.verify_fail")


def _observe(root, mgr, restored, before, met, rec):
    qroot = os.path.join(root, mgr.QUARANTINE)
    w = None if restored is None else float(np.asarray(restored["w"])[0, 0])
    return dict(
        steps=mgr.all_steps(), dirs=sorted(os.listdir(root)),
        quarantined=sorted(os.listdir(qroot)) if os.path.isdir(qroot)
        else [],
        restored_w=w,
        counters={c: met.counter(c).value - before[c] for c in COUNTERS},
        warnings=sorted({("quarantined" in m) + 2 * ("previous intact" in m)
                         for m in rec}),
        error=type(mgr.last_error).__name__ if mgr.last_error else None)


def _quarantine_fallback(mgr, tree, kind, root):
    for step in range(1, 4):
        mgr.save(step, tree(float(step)))
    mgr.wait_until_finished()
    CORRUPTIONS[kind](os.path.join(root, "3"))
    return mgr.restore(template=tree(0.0))


def _walk_past_several(mgr, tree, kind, root):
    for step in range(1, 5):
        mgr.save(step, tree(float(step)))
    mgr.wait_until_finished()
    _corrupt_flip(os.path.join(root, "4"))
    _corrupt_uncommitted(os.path.join(root, "3"))
    return mgr.restore(template=tree(0.0))


def _nothing_intact(mgr, tree, kind, root):
    mgr.save(1, tree(1.0))
    mgr.wait_until_finished()
    _corrupt_truncate(os.path.join(root, "1"))
    with pytest.raises(Exception, match="no intact"):
        mgr.restore(template=tree(0.0))


def _failed_write(mgr, tree, kind, root, chaos_mod):
    chaos_mod.configure("ckpt.write:fail@2", seed=0)
    mgr.save(1, tree(1.0))
    mgr.wait_until_finished()
    mgr.save(2, tree(2.0))                   # injected failure
    mgr.wait_until_finished()
    mid = (list(mgr.all_steps()), type(mgr.last_error).__name__)
    back = mgr.restore(template=tree(0.0))
    mgr.save(3, tree(3.0))                   # the next write heals
    mgr.wait_until_finished()
    return back, mid


def _gc_rotation(mgr, tree, kind, root, chaos_mod):
    chaos_mod.configure("ckpt.write:fail@2", seed=0)   # step 2 is torn
    for step in range(1, 6):
        mgr.save(step, tree(float(step)))
    mgr.wait_until_finished()
    return mgr.restore(5, template=tree(0.0))


def _interval_window(mgr, tree, kind, root):
    saved = [mgr.save(s, tree(float(s))) for s in range(1, 9)]
    mgr.wait_until_finished()
    return mgr.restore(template=tree(0.0)), saved


SEQUENCES = {
    **{f"quarantine_fallback_{k}": (_quarantine_fallback, k, dict(
        max_to_keep=4)) for k in sorted(CORRUPTIONS)},
    "walk_past_several": (_walk_past_several, None, dict(max_to_keep=5)),
    "nothing_intact": (_nothing_intact, None, {}),
    "failed_write_never_raises": (_failed_write, None, dict(max_to_keep=1)),
    "gc_keeps_newest_clears_torn": (_gc_rotation, None, dict(max_to_keep=2)),
    "interval_window": (_interval_window, None, dict(
        max_to_keep=8, save_interval_steps=3)),
}


def _run_sequence(pkg, name, tmp_path):
    mod, met, chaos_mod, tree = PACKAGES[pkg]
    fn, kind, kw = SEQUENCES[name]
    root = str(tmp_path / pkg)
    before = {c: met.counter(c).value for c in COUNTERS}
    mgr = mod.AsyncCheckpointer(root, **kw)
    extra = {}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        args = (mgr, tree, kind, root) + (
            (chaos_mod,) if fn in (_failed_write, _gc_rotation) else ())
        out = fn(*args)
    if isinstance(out, tuple):
        out, extra = out[0], {"extra": out[1]}
    mgr.close()
    chaos_mod.reset()
    return dict(_observe(root, mgr, out, before, met,
                         [str(w.message) for w in rec]), **extra)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_checkpointer_sequences_match_the_reference(tmp_path, name):
    port = _run_sequence("port", name, tmp_path)
    ref = _run_sequence("reference", name, tmp_path)
    assert port == ref
