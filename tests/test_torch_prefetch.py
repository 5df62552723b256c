"""The port's common/prefetch.py: the counterpart of every test of
``tests/test_prefetch.py``, and the trainer's CPU device feed.

Contracts: exact ordering, clean exhaustion, transform-on-worker (host
work overlaps the consumer), source exceptions re-raised at the right
position, prompt stop on close/abandon.
"""

import threading
import time

import numpy as np
import pytest

import torch

from analytics_zoo_tpu_torch.common.prefetch import (DeviceFeed,
                                                     PrefetchIterator,
                                                     prefetch)
from analytics_zoo_tpu_torch.data.dataset import Dataset, prefetch_iterator


def test_order_and_completeness():
    items = list(range(57))
    assert list(prefetch(iter(items), depth=3)) == items


def test_transform_applied_in_order():
    out = list(prefetch(range(10), transform=lambda v: v * 2, depth=2))
    assert out == [v * 2 for v in range(10)]


def test_empty_source():
    assert list(prefetch(iter([]))) == []


def test_transform_runs_on_worker_thread():
    main = threading.get_ident()
    seen = []

    def transform(v):
        seen.append(threading.get_ident())
        return v

    list(prefetch(range(4), transform=transform))
    assert seen and all(t != main for t in seen)


def test_depth_bounds_inflight_items():
    """At most depth transformed items may exist ahead of the consumer
    (+1 being produced)."""
    produced = []

    def transform(v):
        produced.append(v)
        return v

    it = prefetch(range(100), transform=transform, depth=2)
    assert next(it) == 0
    time.sleep(0.3)  # give the worker every chance to run ahead
    # 1 consumed + depth buffered + 1 blocked on the full queue
    assert len(produced) <= 4
    it.close()


def test_source_exception_propagates_at_position():
    def source():
        yield 1
        yield 2
        raise ValueError("boom")

    it = prefetch(source())
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_transform_exception_propagates():
    def transform(v):
        if v == 3:
            raise RuntimeError("bad batch")
        return v

    it = prefetch(range(10), transform=transform)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="bad batch"):
        for _ in range(3):
            next(it)


def test_close_stops_worker_promptly():
    state = {"pulled": 0}

    def source():
        for i in range(10_000):
            state["pulled"] = i
            yield i

    it = PrefetchIterator(source(), depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.2)
    pulled_at_close = state["pulled"]
    time.sleep(0.2)
    # the worker must not keep draining the source after close
    assert state["pulled"] <= pulled_at_close + 3
    with pytest.raises(StopIteration):
        next(it)


def test_abandoned_iterator_worker_stops_via_gc():
    """Dropping the iterator without close() (e.g. a mid-epoch break)
    must still stop the worker: the thread holds no reference to the
    iterator, so GC runs __del__ → close()."""
    import gc
    state = {"pulled": 0}

    def source():
        for i in range(1_000_000):
            state["pulled"] = i
            yield i

    it = prefetch(source(), depth=2)
    assert next(it) == 0
    del it
    gc.collect()
    time.sleep(0.2)
    pulled = state["pulled"]
    time.sleep(0.3)
    assert state["pulled"] <= pulled + 3  # worker no longer draining


def test_context_manager_closes():
    with prefetch(range(100), depth=2) as it:
        assert next(it) == 0
    with pytest.raises(StopIteration):
        next(it)


def test_invalid_depth_rejected():
    with pytest.raises(ValueError):
        prefetch(range(3), depth=0)


# --------------------------------------------- dataset-level integration
def test_prefetch_iterator_compat_shim():
    """data.dataset.prefetch_iterator keeps its (iterator, put_fn,
    depth) signature on the threaded implementation."""
    out = list(prefetch_iterator(iter(range(8)), lambda v: v + 100,
                                 depth=3))
    assert out == [v + 100 for v in range(8)]
    assert list(prefetch_iterator(iter([]), lambda v: v)) == []


def test_dataset_batches_through_prefetch_match_direct():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.integers(0, 2, size=(40,)).astype(np.int32)
    ds = Dataset.from_ndarray(x, y)
    direct = list(ds.batches(8, shuffle=True, seed=3, epoch=1))
    fetched = list(prefetch(ds.batches(8, shuffle=True, seed=3, epoch=1),
                            transform=lambda b: b))
    assert len(direct) == len(fetched)
    for (dx, dy), (fx, fy) in zip(direct, fetched):
        np.testing.assert_array_equal(dx, fx)
        np.testing.assert_array_equal(dy, fy)


def test_device_feed_on_the_cpu_maps_batches_to_tensors():
    """On a CPU device the feed makes tensors of every array of a batch
    (tuples and None kept) and ready() hands them over unchanged."""
    feed = DeviceFeed("cpu")
    x = (np.arange(6).reshape(3, 2), np.ones((3, 1), np.float32))
    batch = (x, None, np.zeros(3, np.int32))
    out = [feed.ready(item) for item in prefetch([batch], transform=feed)]
    (a, b), none, c = out[0]
    assert none is None and feed.stream is None
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in (a, b, c))
    np.testing.assert_array_equal(a.numpy(), x[0])
    assert b.dtype == torch.float32 and c.dtype == torch.int32
