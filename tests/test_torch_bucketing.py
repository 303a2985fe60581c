"""paddle_tpu_torch.serving.bucketing against the reference's
``paddle_tpu/serving/bucketing.py``: the shape buckets on the same inputs,
and the executable cache's contract (one compile per key under concurrent
callers, hit and compile counts, a failing compile publishes nothing and
releases its latch)."""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import bucketing as rb

from paddle_tpu_torch.serving import bucketing as pb

AVALS = [((-1, 7), "float32"), ((-1, -1, 3), "int32"), ((None, 5), "bool")]


@pytest.mark.parametrize("pad_dynamic", [False, True])
@pytest.mark.parametrize("max_batch,min_bucket", [(8, 1), (12, 2), (1, 1)])
def test_bucket_policy_matches_reference(pad_dynamic, max_batch, min_bucket):
    ref = rb.BucketPolicy(AVALS, max_batch_size=max_batch,
                          min_batch_bucket=min_bucket,
                          pad_dynamic_dims=pad_dynamic)
    got = pb.BucketPolicy(AVALS, max_batch_size=max_batch,
                          min_batch_bucket=min_bucket,
                          pad_dynamic_dims=pad_dynamic)
    assert got.dynamic_dims == ref.dynamic_dims
    assert got.max_buckets() == ref.max_buckets()
    for rows in range(0, 20):
        assert got.batch_bucket(rows) == ref.batch_bucket(rows)
    for idx, shape in enumerate([(3, 7), (5, 9, 3), (1, 5), (2, 33, 1)]):
        for rows_bucket in (1, 4, 8):
            assert got.bucket_shape(idx, shape, rows_bucket) == \
                ref.bucket_shape(idx, shape, rows_bucket)


def test_bucket_shape_and_pad_batch_match_reference():
    for shape in [(1, 4), (3, 4, 5), (8, 2), (9, 2), (0, 3)]:
        for cap in (1, 8, 16):
            assert pb.bucket_shape(shape, cap) == rb.bucket_shape(shape, cap)
    rs = np.random.RandomState(0)
    for shape, target in [((3, 4), (4, 4)), ((2, 5, 1), (8, 7, 1)),
                          ((4, 4), (4, 4))]:
        arr = rs.randn(*shape).astype(np.float32)
        got, want = pb.pad_batch(arr, target), rb.pad_batch(arr, target)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    arr = np.ones((4, 4), np.int32)
    assert pb.pad_batch(arr, (4, 4)) is arr
    for bad in [(3, 4), (4,), (4, 4, 1)]:
        with pytest.raises(ValueError):
            pb.pad_batch(arr, bad)
        with pytest.raises(ValueError):
            rb.pad_batch(arr, bad)


def test_seq_buckets_and_next_bucket_match_reference():
    for max_len in (1, 7, 8, 64, 100, 512):
        for lo in (1, 8, 16):
            assert pb.seq_buckets(max_len, lo) == rb.seq_buckets(max_len, lo)
    for n in range(0, 70):
        assert pb.next_bucket(n, 4, 48) == rb.next_bucket(n, 4, 48)


def test_concurrent_callers_compile_each_key_once():
    cache = pb.ExecutableCache(name="t")
    calls, lock = [], threading.Lock()
    gate = threading.Barrier(8)

    def compile_fn(key):
        def fn():
            with lock:
                calls.append(key)
            time.sleep(0.05)         # every thread arrives while it runs
            return ("exe", key)
        return fn

    got = [None] * 8

    def worker(i):
        gate.wait()
        key = ("k", i % 3)
        got[i] = cache.get_or_compile(key, compile_fn(key))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(calls) == [("k", 0), ("k", 1), ("k", 2)]
    assert got == [("exe", ("k", i % 3)) for i in range(8)]
    assert cache.compiles == 3 and cache.hits == 5
    assert len(cache) == 3 and sorted(cache.keys()) == sorted(set(calls))
    cache.get_or_compile(("k", 1), compile_fn(("k", 1)))
    assert (cache.compiles, cache.hits) == (3, 6)


def test_failing_compile_publishes_nothing_and_releases_the_latch():
    cache = pb.ExecutableCache()

    def boom():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get_or_compile(("prefill:8",), boom)
    assert len(cache) == 0 and cache.compiles == 0 and cache.hits == 0
    assert cache._inflight == {}
    # a waiter behind the failing owner compiles itself
    started, release = threading.Event(), threading.Event()

    def slow_boom():
        started.set()
        release.wait(10)
        raise RuntimeError("no")

    errors = []

    def owner():
        try:
            cache.get_or_compile(("decode",), slow_boom)
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=owner)
    t.start()
    started.wait(10)
    out = []
    w = threading.Thread(target=lambda: out.append(
        cache.get_or_compile(("decode",), lambda: "exe")))
    w.start()
    release.set()
    t.join(10)
    w.join(10)
    assert len(errors) == 1 and out == ["exe"]
    assert cache.compiles == 1 and cache.keys() == [("decode",)]


def test_an_invalid_entry_is_made_again():
    cache = pb.ExecutableCache()
    made = iter(range(10))
    first = cache.get_or_compile("k", lambda: next(made))
    assert cache.get_or_compile("k", lambda: next(made),
                                valid=lambda e: True) == first == 0
    assert cache.get_or_compile("k", lambda: next(made),
                                valid=lambda e: e > 0) == 1
    assert (cache.compiles, cache.hits, len(cache)) == (2, 1, 1)
