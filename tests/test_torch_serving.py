"""The port's serving fast path on the CPU: the counterparts of the
single-device cases of ``tests/test_serving_fastpath.py``.

Bucket ladder, bucket choice and batch signatures; padding never changes a
real row; oversize batches are chunked through the ladder; one build per
bucket and a warmup that runs every bucket; integer inputs keep their
dtype; coalesced rows equal solo rows at the same bucket bit for bit under
threads; a dispatcher crash fails every queued and in-flight request; close
is idempotent; a reload under live traffic never tears; ``to_serving``;
and ``InferenceModel.predict`` within 1e-5 of the JAX package's
``KerasNet.predict`` from the same weights, for LeNet and TransformerLM.
Every coalescer and handle is closed by a fixture finalizer and every wait
has a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch
import jax

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model, \
    Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_tpu_torch.pipeline.inference import (
    BucketedExecutableCache, CoalescerClosedError, InferenceModel, JTensor,
    RequestCoalescer, bucket_ladder)
from analytics_zoo_tpu_torch.pipeline.inference import serving

from test_torch_generate import models as lm_pair
from test_torch_lenet import build_lenet

WAIT = 30  # seconds: the bound of every blocking wait
TOL = 1e-5


@pytest.fixture
def closing():
    """Registers coalescers and handles to close when the test ends."""
    made = []
    yield lambda obj: made.append(obj) or obj
    for obj in made:
        obj.close()


def scale_fn(s):
    """A row-wise function: a row's output depends on that row only,
    exactly (no reduction whose order a batch shape could change)."""
    return lambda x: x * s + 1.0


def dense_net(scale, n_in=3, n_out=3):
    """Dense with weights ``scale * I`` and no bias: predict is
    ``scale * x`` (n_in == n_out)."""
    net = Sequential(device="cpu")
    net.add(tlayers.Dense(n_out, input_shape=(n_in,), bias=False))
    with torch.no_grad():
        net.stack[0].W.copy_(scale * torch.eye(n_in, n_out))
    return net


# ---------------------------------------------------------------- ladder
def test_bucket_ladder_shapes():
    assert bucket_ladder(32) == (1, 2, 4, 8, 16, 32)
    assert bucket_ladder(5) == (1, 2, 4, 5)
    assert bucket_ladder(1) == (1,)
    assert bucket_ladder(12, growth=3.0) == (1, 3, 9, 12)
    with pytest.raises(ValueError):
        bucket_ladder(0)
    with pytest.raises(ValueError):
        bucket_ladder(8, growth=1.0)


def test_bucket_for_picks_smallest_cover():
    cache = BucketedExecutableCache(lambda x: x, max_batch=32, device="cpu")
    assert cache.bucket_for(1) == 1
    assert cache.bucket_for(3) == 4
    assert cache.bucket_for(17) == 32
    assert cache.bucket_for(33) == 32  # oversize: top bucket (chunked)


def test_explicit_buckets_override_ladder():
    cache = BucketedExecutableCache(lambda x: x, buckets=[16, 4], device="cpu")
    assert cache.buckets == (4, 16)
    assert cache.bucket_for(1) == 4
    assert cache.bucket_for(5) == 16


def test_cache_runs_on_the_card_unless_asked():
    """Like every entry point of the port, the cache defaults to
    ``"cuda"``: without a card it raises rather than serve on the
    CPU."""
    if torch.cuda.is_available():
        assert BucketedExecutableCache(lambda x: x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BucketedExecutableCache(lambda x: x)


def test_batch_signature_distinguishes_dtype_and_shape():
    sig = serving.batch_signature
    a = np.zeros((2, 3), np.float32)
    assert sig(a) == sig(np.ones((5, 3), np.float32))
    assert sig(a) != sig(a.astype(np.int32))
    assert sig(a) != sig(np.zeros((2, 4), np.float32))
    assert sig((a, a)) != sig(a)


# ------------------------------------------------------ padding + cache
def test_padded_results_match_unpadded():
    cache = BucketedExecutableCache(scale_fn(3.0), max_batch=8, device="cpu")
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 7, 8):
        x = rng.normal(size=(n, 4)).astype(np.float32)
        np.testing.assert_array_equal(cache.run(x), x * 3.0 + 1.0)


def test_oversize_batch_is_chunked_through_ladder():
    cache = BucketedExecutableCache(scale_fn(2.0), max_batch=8, device="cpu")
    x = np.random.default_rng(1).normal(size=(21, 4)).astype(np.float32)
    np.testing.assert_array_equal(cache.run(x), x * 2.0 + 1.0)
    # chunks of 8, 8, then 5 padded to 8: one build, two hits
    assert cache.stats.misses == {8: 1}
    assert cache.stats.hits == {8: 2}


def test_empty_batch_keeps_the_output_structure():
    cache = BucketedExecutableCache(scale_fn(2.0), max_batch=4, device="cpu")
    out = cache.run(np.zeros((0, 3), np.float32))
    assert out.shape == (0, 3)


def test_one_build_per_bucket_counters():
    cache = BucketedExecutableCache(scale_fn(1.0), max_batch=8, device="cpu")
    stream = [1, 2, 3, 5, 8, 7, 1, 2, 4, 6, 8, 3]
    for n in stream:
        cache.run(np.zeros((n, 4), np.float32))
    st = cache.stats.snapshot()
    assert st["misses"] == {1: 1, 2: 1, 4: 1, 8: 1}
    assert sum(st["hits"].values()) == len(stream) - 4
    assert set(st["build_time_s"]) == {1, 2, 4, 8}
    assert all(t >= 0 for t in st["build_time_s"].values())


def test_warmup_runs_every_bucket(closing):
    im = closing(InferenceModel(max_batch_size=8)).load_keras_net(
        dense_net(2.0))
    assert im.warmup((3,)) > 0
    stats = im.serving_stats()
    assert stats["misses"] == {1: 1, 2: 1, 4: 1, 8: 1}
    for n in (1, 3, 8):
        im.predict(np.zeros((n, 3), np.float32))
    assert im.serving_stats()["misses"] == stats["misses"]


def test_bucketing_off_uses_exact_path(closing):
    im = closing(InferenceModel(bucketing=False)).load_keras_net(
        dense_net(2.0))
    x = np.ones((3, 3), np.float32)
    np.testing.assert_array_equal(im.predict(x), 2 * x)
    assert im.serving_stats()["buckets"] == ()


# ----------------------------------------------------------- int dtypes
def test_integer_inputs_keep_dtype_through_padded_path():
    seen = {}
    table = torch.from_numpy(
        np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32))

    def fn(x):
        seen["dtype"] = x.dtype
        return table[x[:, 0].long()]

    cache = BucketedExecutableCache(fn, max_batch=4, device="cpu")
    ids = np.array([[1], [7], [3]], np.int32)
    out = cache.run(ids)
    assert seen["dtype"] == torch.int32
    np.testing.assert_array_equal(out, table.numpy()[ids[:, 0]])


def test_embedding_model_int_ids_through_padded_path(closing):
    m = Sequential(device="cpu")
    m.add(tlayers.Embedding(20, 6, input_shape=(5,)))
    m.add(tlayers.Flatten())
    m.add(tlayers.Dense(3, activation="softmax"))
    im = closing(InferenceModel(max_batch_size=8, buckets=[8]))
    im.load_keras_net(m)
    ids = np.random.default_rng(0).integers(0, 20, (3, 5)).astype(np.int32)
    out = im.predict(ids)
    assert out.shape == (3, 3)
    for i in range(len(ids)):  # one bucket: solo rows share its shape
        np.testing.assert_array_equal(im.predict(ids[i:i + 1])[0], out[i])


def test_jtensor_and_list_inputs(closing):
    im = closing(InferenceModel(max_batch_size=4)).load_keras_net(
        dense_net(3.0))
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    out = im.predict(JTensor(x[0]))
    assert isinstance(out, JTensor)
    np.testing.assert_array_equal(out.to_ndarray(), 3 * x[0])
    outs = im.predict([JTensor(r) for r in x])
    np.testing.assert_array_equal(np.stack([o.to_ndarray() for o in outs]),
                                  3 * x)
    # a list of per-sample arrays stacks into one batch
    np.testing.assert_array_equal(im.predict([r for r in x]), 3 * x)
    assert im.predict(x).dtype == np.float32  # float64 narrows to f32


# ----------------------------------------------------------- coalescing
def test_coalesced_results_bit_identical_to_solo_under_threads(closing):
    """Concurrent coalesced predictions equal solo runs bit for bit, for
    every row, three times over; solo and coalesced share the one bucket
    (buckets=[16]), so both run the forward at the same shape."""
    m = Sequential(device="cpu")
    m.add(tlayers.Dense(16, input_shape=(4,), activation="relu"))
    m.add(tlayers.Dense(3, activation="softmax"))
    solo = closing(InferenceModel(max_batch_size=16, buckets=[16]))
    solo.load_keras_net(m)
    coal = closing(InferenceModel(supported_concurrent_num=4,
                                  max_batch_size=16, buckets=[16],
                                  coalescing=True, max_wait_ms=5.0))
    coal.load_keras_net(m)
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(1, 4)).astype(np.float32) for _ in range(16)]
    ref = [solo.predict(x) for x in xs]
    results = [[None] * len(xs) for _ in range(3)]
    go = threading.Event()

    def worker(rep, i):
        go.wait(WAIT)
        results[rep][i] = coal.predict(xs[i])

    threads = [threading.Thread(target=worker, args=(r, i))
               for r in range(3) for i in range(len(xs))]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(WAIT)
    for rep in range(3):
        for i in range(len(xs)):
            np.testing.assert_array_equal(results[rep][i], ref[i])
    stats = coal.serving_stats()
    assert stats["dispatches"] < stats["coalesced_requests"]
    assert stats["coalescer_pending"] == 0


def test_coalescer_mixed_signatures_stay_correct(closing):
    cache = BucketedExecutableCache(scale_fn(3.0), max_batch=8, device="cpu")
    c = closing(RequestCoalescer(cache, max_wait_ms=2.0))
    shapes = [(1, 2), (1, 5), (2, 2), (1, 5), (1, 2), (2, 5)]
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    futs = [c.submit(x) for x in xs]
    for f, x in zip(futs, xs):
        np.testing.assert_array_equal(f.result(timeout=WAIT), 3.0 * x + 1.0)


def test_coalescer_multi_input_models(closing):
    cache = BucketedExecutableCache(lambda xs: xs[0] + xs[1] * 2.0,
                                    max_batch=8, device="cpu")
    c = closing(RequestCoalescer(cache, max_wait_ms=2.0))
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.normal(size=(1, 3)).astype(np.float32)
                   for _ in range(2)) for _ in range(6)]
    futs = [c.submit(p) for p in pairs]
    for f, (a, b) in zip(futs, pairs):
        np.testing.assert_array_equal(f.result(timeout=WAIT), a + 2.0 * b)


def test_multi_input_model_predicts_through_the_handle(closing):
    a, b = Input((3,)), Input((3,))
    out = tlayers.Merge(mode="sum")([a, b])
    model = Model(input=[a, b], output=out, device="cpu")
    im = closing(InferenceModel(max_batch_size=4, coalescing=True))
    im.load_keras_net(model)
    x = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(im.predict((x, 2 * x)), 3 * x)


def test_coalescer_oversize_request_takes_solo_path(closing):
    im = closing(InferenceModel(supported_concurrent_num=2,
                                max_batch_size=4, coalescing=True,
                                max_wait_ms=1.0))
    im.load_keras_net(dense_net(1.0))
    x = np.ones((9, 3), np.float32)  # > max_batch: the chunked solo path
    np.testing.assert_array_equal(im.predict(x), x)
    with pytest.raises(ValueError, match="solo path"):
        im._coalescer.submit(x)


def test_staging_arena_reuses_its_ring():
    arena = serving._StagingArena(depth=2)
    reqs = [serving._Request(np.full((2, 3), i, np.float32), 2,
                             serving.batch_signature(np.zeros((2, 3))))
            for i in range(3)]
    bufs = []
    for r in reqs:
        bufs.append(arena.pack([r], 4))
        arena.commit()
    assert arena.buffers_allocated() == 2
    assert bufs[0] is bufs[2] and bufs[0] is not bufs[1]
    np.testing.assert_array_equal(bufs[2][:2].numpy(), 2.0)
    np.testing.assert_array_equal(bufs[2][2:].numpy(), 0.0)


def test_reload_concurrent_with_predict_never_fails_or_tears(closing):
    """load_keras_net under live coalesced traffic: every call returns a
    result computed entirely by one installed version, and none fails."""
    im = closing(InferenceModel(supported_concurrent_num=2,
                                max_batch_size=8, coalescing=True,
                                max_wait_ms=1.0))
    im.load_keras_net(dense_net(1.0))
    x = np.arange(6, dtype=np.float32).reshape(2, 3) + 1.0
    scales = (1.0, 2.0, 3.0, 4.0)
    results, failures = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                out = np.asarray(im.predict(x))
                with lock:
                    results.append(out)
            except Exception as e:  # noqa: BLE001 - asserted empty
                with lock:
                    failures.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for s in scales[1:]:
            time.sleep(0.1)
            im.load_keras_net(dense_net(s))  # reload mid-traffic
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(WAIT)
    assert not failures, failures[:5]
    assert results
    seen = set()
    for out in results:
        ratios = out / x
        assert np.allclose(ratios, ratios.flat[0]), ratios
        s = float(ratios.flat[0])
        assert any(np.isclose(s, c) for c in scales), s
        seen.add(round(s))
    assert len(seen) >= 2, seen


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_coalescer_crash_fails_queued_and_inflight_not_hang(closing):
    gate, entered = threading.Event(), threading.Event()

    def blocking_fn(x):
        entered.set()
        gate.wait(timeout=WAIT)
        return x

    cache = BucketedExecutableCache(blocking_fn, max_batch=2, device="cpu")
    c = closing(RequestCoalescer(cache, max_wait_ms=1.0))
    f1 = c.submit(np.ones((1, 2), np.float32))  # the dispatcher blocks
    assert entered.wait(timeout=WAIT)

    def bad_gather(*a, **k):
        raise RuntimeError("injected dispatcher crash")

    c._gather = bad_gather
    f2 = c.submit(np.ones((1, 2), np.float32))
    f3 = c.submit(np.ones((1, 2), np.float32))
    gate.set()
    for f in (f2, f3):
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=WAIT)
    try:
        f1.result(timeout=WAIT)  # resolved or failed, never hung
    except RuntimeError:
        pass
    c._thread.join(timeout=WAIT)
    assert not c._thread.is_alive()
    assert c.pending == 0
    with pytest.raises(CoalescerClosedError):
        c.submit(np.ones((1, 2), np.float32))


def test_submit_after_dispatcher_exit_raises_not_hangs(closing):
    cache = BucketedExecutableCache(lambda x: x, max_batch=4, device="cpu")
    c = closing(RequestCoalescer(cache, max_wait_ms=1.0))
    c._q.put(serving._SHUTDOWN)
    c._thread.join(timeout=WAIT)
    assert not c._thread.is_alive()
    assert c.closed  # though close() never ran
    with pytest.raises(CoalescerClosedError):
        c.submit(np.ones((1, 2), np.float32))


def test_coalescer_close_is_idempotent_and_fails_stragglers(closing):
    cache = BucketedExecutableCache(lambda x: x, max_batch=4, device="cpu")
    c = closing(RequestCoalescer(cache, max_wait_ms=1.0))
    fut = c.submit(np.ones((1, 2), np.float32))
    np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                  np.ones((1, 2), np.float32))
    c.close()
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c.submit(np.ones((1, 2), np.float32))


def test_kerasnet_to_serving_convenience(closing):
    m = Sequential(device="cpu")
    m.add(tlayers.Dense(4, input_shape=(3,), activation="softmax"))
    im = closing(m.to_serving(supported_concurrent_num=2, max_batch_size=8,
                              warmup_shapes=(3,)))
    stats = im.serving_stats()
    assert stats["misses"] == {1: 1, 2: 1, 4: 1, 8: 1}
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    out = im.predict(x)
    assert out.shape == (5, 4)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    assert im.serving_stats()["misses"] == stats["misses"]
    coal = closing(m.to_serving(coalescing=True))
    np.testing.assert_array_equal(coal.predict(x), im.predict(x))


def test_saved_model_loads_and_serves(closing, tmp_path):
    net = dense_net(2.0)
    net.save_model(str(tmp_path / "m"))
    im = closing(InferenceModel(max_batch_size=4, device="cpu"))
    im.load(str(tmp_path / "m"))
    x = np.ones((3, 3), np.float32)
    np.testing.assert_array_equal(im.predict(x), 2 * x)
    im.reload(str(tmp_path / "m"))
    np.testing.assert_array_equal(im.predict(x), 2 * x)


def test_handle_device_must_match_the_model(closing):
    im = closing(InferenceModel(device="meta"))
    with pytest.raises(ValueError, match="device"):
        im.load_keras_net(dense_net(1.0))


def test_quantized_handle_is_not_ported(closing):
    im = closing(InferenceModel())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        im.load_keras_net(dense_net(1.0), quantize=True)


# ------------------------------------------------------- JAX parity
def test_predict_matches_jax_lenet(closing):
    with jname_scope("serve_lenet"):
        jm = build_lenet(JSequential(), layers=jlayers)
    with name_scope("serve_lenet"):
        tm = build_lenet(Sequential(device="cpu"))
    tm.set_weights(jax.device_get(jm.get_weights()))
    x = np.random.default_rng(2).normal(size=(11, 28, 28, 1)).astype(
        np.float32)
    ref = jm.predict(x, batch_size=11)
    im = closing(InferenceModel(max_batch_size=8, coalescing=True))
    im.load_keras_net(tm)
    np.testing.assert_allclose(im.predict(x), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(im.predict(x[:3]), ref[:3], atol=TOL,
                               rtol=TOL)


def test_predict_matches_jax_transformer_lm(closing):
    jm, tm = lm_pair(seed=3)
    ids = np.random.default_rng(3).integers(0, 59, (5, 32)).astype(np.int32)
    ref = jm.predict(ids, batch_size=5)
    im = closing(InferenceModel(max_batch_size=4, coalescing=True))
    im.load_keras_net(tm)
    out = im.predict(ids)
    assert out.shape == (5, 32, 59)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
