"""Port counterpart of ``tests/test_serving_replicas.py``: the replica
set (one build a bucket, placement on every replica), the
least-outstanding-work coalescer, failover, re-probes and the registry's
replica wiring, on ``analytics_zoo_tpu_torch`` with replicas on the CPU.
The reference's sanitize cases wait for the port's tooling (ROADMAP).
"""


import json
import logging
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as _IM
from analytics_zoo_tpu_torch.pipeline.inference import ReplicaSet
from analytics_zoo_tpu_torch.pipeline.inference.serving import (
    available_devices, fetch_rows)
from analytics_zoo_tpu_torch.serving import ModelRegistry as _Registry
from analytics_zoo_tpu_torch.serving.metrics import registry_families


def InferenceModel(*args, **kwargs):
    """A handle on the CPU (its replicas are copies on the CPU)."""
    kwargs.setdefault("device", "cpu")
    return _IM(*args, **kwargs)


def ModelRegistry(*args, **kwargs):
    """A registry whose models serve on the CPU."""
    kwargs.setdefault("device", "cpu")
    return _Registry(*args, **kwargs)


@pytest.fixture
def compile_counter(monkeypatch):
    """Every build the serving path reports (``profile.note_compile``
    fires once per signature's first run on replica 0)."""
    from analytics_zoo_tpu_torch.observability import profile

    events = []
    real = profile.note_compile

    def note(seconds, key, **kw):
        events.append(key)
        real(seconds, key, **kw)

    monkeypatch.setattr(profile, "note_compile", note)
    return events


# ------------------------------------------------------------ ReplicaSet
def test_replicaset_compiles_once_and_places_everywhere(compile_counter):
    """One signature over 4 replicas = ONE reported build, and every
    replica returns the same bits."""
    devs = ["cpu"] * 4
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    rs = ReplicaSet(lambda p, x: x @ p["w"], params, devices=devs)
    assert rs.n == 4

    x = rng.normal(size=(2, 4)).astype(np.float32)
    n0 = len(compile_counter)
    secs = rs.ensure_compiled(x)
    assert secs > 0
    assert len(compile_counter) - n0 == 1  # the one compile
    assert rs.ensure_compiled(x) == 0.0    # cached
    assert rs.compiled_keys() == 1

    outs = []
    for rep in rs.replicas:
        out = np.asarray(fetch_rows(rs.dispatch(rep, x), 2))
        outs.append(out)
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    np.testing.assert_allclose(outs[0], x @ params["w"], rtol=1e-6)
    # placing + executing on 3 more replicas built NOTHING further
    assert len(compile_counter) - n0 == 1


def test_model_warmup_one_compile_per_bucket_across_replicas(
        compile_counter):
    """InferenceModel(replicas=4).warmup(): the whole ladder compiles
    once per bucket — not once per (bucket, replica)."""
    im = InferenceModel(max_batch_size=8, coalescing=True,
                        replicas=4)
    im.load_fn(lambda p, x: x @ p["w"],
                {"w": np.eye(4, dtype=np.float32)})
    assert im.n_replicas == 4
    n0 = len(compile_counter)
    im.warmup((4,))
    stats = im.serving_stats()
    assert stats["misses"] == {1: 1, 2: 1, 4: 1, 8: 1}
    assert len(compile_counter) - n0 == 4  # one per bucket, 4 replicas
    # warmed traffic on every path compiles nothing
    n1 = len(compile_counter)
    for n in (1, 3, 8):
        im.predict(np.zeros((n, 4), np.float32))
    assert len(compile_counter) == n1
    im.close()


def test_replicas_all_and_clamping():
    n_dev = len(available_devices("cpu"))
    im = InferenceModel(replicas="all")
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    assert im.n_replicas == n_dev
    im2 = InferenceModel(replicas=3)
    im2.load_fn(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    assert im2.n_replicas == 3
    # clamped, not failed, when asking beyond the host
    im3 = InferenceModel(replicas=n_dev + 99)
    im3.load_fn(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    assert im3.n_replicas == n_dev
    with pytest.raises(ValueError):
        InferenceModel(replicas=0).load_fn(
            lambda p, x: x, {"s": np.float32(1.0)})
    with pytest.raises(ValueError):
        InferenceModel(replicas="some").load_fn(
            lambda p, x: x, {"s": np.float32(1.0)})


def test_quantized_handle_stays_single_device():
    """Quantized handles have no bucket executables to replicate — the
    exact-shape path stays single-device rather than failing."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    m = Sequential(device="cpu")
    m.add(Dense(8, input_shape=(4,), activation="relu"))
    m.add(Dense(2))
    im = InferenceModel(max_batch_size=8, replicas=4).load_keras_net(
        m, quantize=True)
    assert im.n_replicas == 1
    out = im.predict(np.zeros((3, 4), np.float32))
    assert out.shape == (3, 2)


# --------------------------------------------- scheduler + bit-exactness
def test_coalesced_multi_replica_bit_identical_and_spread():
    """Concurrent coalesced traffic over 4 replicas: results equal the
    same model's solo predictions bit-for-bit (single bucket → one
    executable, identical on every device), and the scheduler actually
    uses more than one replica."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    m = Sequential(device="cpu")
    m.add(Dense(16, input_shape=(4,), activation="relu"))
    m.add(Dense(3, activation="softmax"))
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=16,
                        buckets=[16], coalescing=True, max_wait_ms=5.0,
                        replicas=4).load_keras_net(m)
    assert im.n_replicas == 4
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(1, 4)).astype(np.float32) for _ in range(16)]
    # solo reference through the SAME replicated executables
    ref = [im._cache.run(x) for x in xs]

    results = [[None] * len(xs) for _ in range(3)]
    go = threading.Event()

    def worker(rep, i):
        go.wait()
        results[rep][i] = im.predict(xs[i])

    threads = [threading.Thread(target=worker, args=(r, i))
               for r in range(3) for i in range(len(xs))]
    [t.start() for t in threads]
    go.set()
    [t.join(timeout=60) for t in threads]
    for rep in range(3):
        for i in range(len(xs)):
            np.testing.assert_array_equal(results[rep][i], ref[i])
    stats = im.serving_stats()
    assert stats["misses"] == {16: 1}  # one compile, all replicas
    used = sum(1 for v in stats["replica_dispatches"].values() if v > 0)
    assert used >= 2, stats["replica_dispatches"]
    im.close()


def test_staging_arena_reuse_bit_exact_vs_fresh_alloc():
    """Satellite pin: arena-staged dispatch (the coalescer path,
    buffers reused across dispatches) is bit-exact vs fresh-allocation
    dispatch (cache.run pads a fresh array) for same-bucket repeats —
    extends the bit-exact contract to the zero-alloc path."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        buckets=[8], coalescing=True, max_wait_ms=2.0,
                        replicas=2)
    w = np.arange(16, dtype=np.float32).reshape(4, 4)
    im.load_fn(lambda p, x: x @ p["w"], {"w": w})
    im.warmup((4,))
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, 4)).astype(np.float32) for _ in range(6)]
    fresh = [np.asarray(im._cache.run(x)) for x in xs]
    for repeat in range(5):  # SAME bucket ring reused every repeat
        outs = [np.asarray(im.predict(x)) for x in xs]
        for got, want in zip(outs, fresh):
            np.testing.assert_array_equal(got, want)
    # the arena really was in play (allocated buffers, coalescer path)
    assert im._coalescer._arena.buffers_allocated() > 0
    im.close()


def test_oversize_requests_still_served_with_replicas():
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=4,
                        coalescing=True, max_wait_ms=1.0, replicas=2)
    im.load_fn(lambda p, x: x + p["b"], {"b": np.float32(1.0)})
    x = np.zeros((11, 2), np.float32)  # > max_batch → chunked solo path
    np.testing.assert_array_equal(im.predict(x), x + 1.0)
    im.close()


def test_multi_input_models_through_replicas():
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        coalescing=True, max_wait_ms=2.0, replicas=2)
    im.load_fn(lambda p, xs: xs[0] + xs[1] * p["s"],
                {"s": np.float32(2.0)})
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.normal(size=(1, 3)).astype(np.float32)
                   for _ in range(2)) for _ in range(6)]
    out = [None] * len(pairs)

    def worker(i):
        out[i] = im.predict(pairs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(pairs))]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_array_equal(out[i], a + 2.0 * b)
    im.close()


# ------------------------------------------------------- warmup overlap
def test_warmup_logs_per_bucket_compile_ms_through_structured_logger():
    """Satellite pin: warmup emits one structured ``warmup_bucket``
    record per bucket with the compile milliseconds (the thread pool
    overlapping the compiles is structural — timing is not asserted on
    this 2-core box per the perf-flake policy)."""
    records = []

    class Collector(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("zoo.serving")
    handler = Collector()
    old_level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        im = InferenceModel(max_batch_size=8, replicas=2)
        im.load_fn(lambda p, x: x @ p["w"],
                    {"w": np.eye(4, dtype=np.float32)})
        im.warmup((4,))
        im.close()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    warm = [json.loads(r) for r in records
            if '"warmup_bucket"' in r]
    buckets = sorted(r["bucket"] for r in warm)
    assert buckets == [1, 2, 4, 8], warm
    assert all(r["compile_ms"] > 0 for r in warm)
    assert all(r["replicas"] == 2 for r in warm)


# ------------------------------------------------------ fault tolerance
class _CrashingExecutable:
    """Stands in for one replica's loaded executable."""

    def __init__(self, n_failures=10 ** 9):
        self.calls = 0
        self.n_failures = n_failures

    def execute(self, args):
        self.calls += 1
        raise RuntimeError("injected replica crash")


def _sabotage_replica(im, index):
    """Replace every placed executable of one replica with a crasher.
    Probes are frozen (huge backoff) so the tests pinning
    routes-around-the-dead-replica behavior aren't racing the health
    re-probe — the recovery tests re-arm it explicitly."""
    rs = im._cache.replica_set
    rs.probe_backoff_s = 3600.0
    crashers = []
    for key in list(rs._exes):
        exes = list(rs._exes[key])
        crasher = _CrashingExecutable()
        exes[index] = crasher
        rs._exes[key] = tuple(exes)
        crashers.append(crasher)
    return rs, crashers


def test_replica_crash_marks_unhealthy_and_reroutes():
    """A crashing replica never surfaces to callers: the group retries
    on a healthy replica, the crasher is marked unhealthy (exported as
    the gauge), and subsequent traffic routes around it."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        coalescing=True, max_wait_ms=2.0, replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(3.0)})
    im.warmup((4,))
    rs, crashers = _sabotage_replica(im, 1)

    errors = []

    def worker(i):
        try:
            x = np.full((1 + i % 3, 4), float(i), np.float32)
            np.testing.assert_array_equal(im.predict(x), 3.0 * x)
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(12)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not errors, errors[:3]
    stats = im.serving_stats()
    assert stats["replica_unhealthy"] == {0: False, 1: True}, stats
    # traffic now routes around the dead replica entirely
    calls_before = sum(c.calls for c in crashers)
    for i in range(8):
        x = np.full((2, 4), float(i), np.float32)
        np.testing.assert_array_equal(im.predict(x), 3.0 * x)
    assert sum(c.calls for c in crashers) == calls_before
    im.close()


def test_all_replicas_unhealthy_surfaces_the_error():
    """With nowhere left to retry the caller sees the model error —
    fault tolerance must not loop or hang."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=4,
                        coalescing=True, max_wait_ms=1.0, replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(1.0)})
    im.warmup((4,))
    _sabotage_replica(im, 0)
    _sabotage_replica(im, 1)
    with pytest.raises(RuntimeError, match="injected replica crash"):
        im.predict(np.ones((1, 4), np.float32))
    im.close()


def test_concurrent_cold_dispatches_race_safely_one_compile(
        compile_counter):
    """Pinned: placement is gated on the ReplicaSet's own registry,
    not the cache's hit/miss bit — concurrent UNWARMED requests for the
    same bucket must all succeed (the losers of the compile race wait
    on the per-key lock rather than KeyError-ing on an unpublished
    executable), and still pay exactly one compile per bucket."""
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=4,
                        bucketing=True, coalescing=False, replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    n0 = len(compile_counter)
    errors = []

    def worker(i):
        try:
            x = np.full((1 + i % 4, 3), float(i), np.float32)
            np.testing.assert_array_equal(im.predict(x), 2.0 * x)
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(16)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not errors, errors[:3]
    stats = im.serving_stats()
    assert all(v == 1 for v in stats["misses"].values()), stats["misses"]
    assert len(compile_counter) - n0 == len(stats["misses"])
    # nothing got marked unhealthy by the compile race
    assert not any(stats["replica_unhealthy"].values()), stats


def test_host_side_errors_do_not_flip_replicas_unhealthy():
    """Pinned: only RuntimeError (how a device fails in torch) indicts
    a replica.  A malformed input's host-side
    error propagates to its caller and leaves every replica healthy."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        coalescing=False, replicas=2)
    im.load_fn(lambda p, x: x @ p["w"],
                {"w": np.eye(4, dtype=np.float32)})
    im.warmup((4,))
    rs = im._cache.replica_set

    class TypeErrorExe:
        def execute(self, args):
            raise TypeError("host-side argument error")

    for key in list(rs._exes):
        rs._exes[key] = tuple(TypeErrorExe() for _ in rs._exes[key])
    with pytest.raises(TypeError, match="host-side"):
        im.predict(np.ones((2, 4), np.float32))
    stats = im.serving_stats()
    assert not any(stats["replica_unhealthy"].values()), stats


def test_reload_reuses_semaphore_unless_capacity_changes():
    """Pinned: a reload with an unchanged concurrency capacity
    keeps the SAME semaphore, so old-path drains and new-path traffic
    share one device-work budget (a fresh semaphore would let them
    stack to 2x during the drain window).  Only a replica-count change
    re-budgets."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=4,
                        replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(1.0)})
    sem = im._semaphore
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    assert im._semaphore is sem  # same capacity -> same budget
    im._replicas_req = 4
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(3.0)})
    assert im._semaphore is not sem  # capacity moved -> new budget
    assert im.n_replicas == 4
    im.close()


# ------------------------------------------------------ metrics wiring
def test_canary_staging_keeps_active_admission_scale():
    """Pinned: a staged canary must not re-bound the traffic the
    active version is still serving — admission re-scales only when a
    version ACTIVATES (deploy swap or promote)."""
    with ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                       max_batch_size=8, coalescing=True,
                       replicas=2) as reg:
        reg.deploy("m", fn=lambda p, x: x * p["s"],
                   params={"s": np.float32(1.0)}, warmup_shapes=(4,))
        entry = reg._entry("m")
        assert entry.admission.max_concurrency == 4  # 2 * 2 replicas
        # stage an UN-replicated canary: active bound must not move
        reg.deploy("m", fn=lambda p, x: x * p["s"],
                   params={"s": np.float32(2.0)}, canary_fraction=0.5,
                   replicas=1)
        assert entry.admission.max_concurrency == 4
        # promotion activates the 1-replica version: bound follows it
        reg.promote("m")
        assert entry.admission.max_concurrency == 2


def test_registry_exports_replica_families_and_scales_admission():
    with ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                       max_batch_size=8, coalescing=True,
                       replicas=2) as reg:
        reg.deploy("m", fn=lambda p, x: x * p["s"],
                   params={"s": np.float32(2.0)}, warmup_shapes=(4,))
        assert reg._entry("m").admission.max_concurrency == 4  # 2 * 2
        for _ in range(4):
            reg.predict("m", np.ones((1, 4), np.float32))
        snap = reg.metrics()
        serving = snap["m"]["serving"]
        assert serving["replicas"] == 2
        assert sum(serving["replica_dispatches"].values()) > 0
        assert serving["replica_unhealthy"] == {0: False, 1: False}
        fams = {f.name: f for f in registry_families(snap)}
        for name in ("zoo_model_replicas", "zoo_replica_dispatches_total",
                     "zoo_replica_bucket_dispatches_total",
                     "zoo_replica_unhealthy"):
            assert name in fams, sorted(fams)
        labels = [dict(lbl) for lbl, _ in
                  fams["zoo_replica_dispatches_total"].samples]
        assert {"model": "m", "replica": "0"} in labels
        assert {"model": "m", "replica": "1"} in labels
        bucket_labels = [dict(lbl) for lbl, _ in
                         fams["zoo_replica_bucket_dispatches_total"].samples]
        assert all({"model", "replica", "bucket"} <= set(d)
                   for d in bucket_labels)


def test_span_carries_replica_label():
    from analytics_zoo_tpu_torch.observability import Tracer
    tracer = Tracer(capacity=16)
    with ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                       max_batch_size=8, coalescing=True, replicas=2,
                       tracer=tracer) as reg:
        reg.deploy("m", fn=lambda p, x: x * p["s"],
                   params={"s": np.float32(1.0)}, warmup_shapes=(4,))
        _, info = reg.predict_ex("m", np.ones((2, 4), np.float32))
        tr = tracer.find(info["request_id"])
        assert tr is not None
        assert "replica" in tr["labels"], tr["labels"]
        assert tr["labels"]["replica"] in (0, 1)
        assert "bucket" in tr["labels"]


# ------------------------------------------------- health re-probe
def test_replica_crash_then_heals_via_reprobe():
    """Recovery is structured, not luck: a replica marked unhealthy by
    a crash is re-probed with a cheap warmed no-op execute once its
    backoff lapses, and a probe that returns flips it healthy — the
    zoo_replica_unhealthy gauge goes back to 0 without a hot-swap."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        coalescing=True, max_wait_ms=1.0, replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    im.warmup((4,))
    originals = dict(im._cache.replica_set._exes)  # pre-sabotage
    rs, _ = _sabotage_replica(im, 1)

    x = np.ones((2, 4), np.float32)
    for _ in range(8):  # round-robin reaches the crasher in <= 2
        np.testing.assert_array_equal(im.predict(x), 2.0 * x)
        if not rs.replicas[1].healthy:
            break
    assert im.serving_stats()["replica_unhealthy"][1] is True
    sick = rs.replicas[1]
    first_backoff = sick.probe_backoff

    # the fault clears (the "device" comes back): restore the real
    # executables and make the probe due NOW
    with rs._lock:
        for key, exes in originals.items():
            rs._exes[key] = exes
        rs.probe_backoff_s = 0.01
        sick.probe_at = 0.0
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not sick.healthy:
        im.predict(x)  # the dispatcher loop drives maybe_reprobe
        time.sleep(0.01)
    assert sick.healthy, "probe never restored the recovered replica"
    stats = im.serving_stats()
    assert stats["replica_unhealthy"] == {0: False, 1: False}, stats
    assert sick.probe_backoff == rs.probe_backoff_s  # backoff reset
    # healed means scheduled: traffic reaches replica 1 again
    before = rs.replicas[1].dispatches
    for i in range(12):
        np.testing.assert_array_equal(im.predict(x), 2.0 * x)
    assert rs.replicas[1].dispatches > before
    # the exported gauge agrees
    reg_snapshot = {"m": {"active_version": 1, "swap_count": 0,
                          "admission": {}, "versions": {},
                          "serving": stats}}
    fams = {f.name: f for f in registry_families(reg_snapshot)}
    vals = [v for lbl, v in fams["zoo_replica_unhealthy"].samples]
    assert vals == [0, 0], vals
    im.close()


def test_failed_probe_doubles_backoff():
    """A probe against a still-dead replica must back off
    exponentially — not hammer a sick device at the probe interval."""
    im = InferenceModel(supported_concurrent_num=1, max_batch_size=4,
                        coalescing=False, replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(1.0)})
    im.warmup((4,))
    rs, _ = _sabotage_replica(im, 1)
    rs.mark_unhealthy(rs.replicas[1], RuntimeError("injected"))
    sick = rs.replicas[1]
    with rs._lock:
        sick.probe_backoff = rs.probe_backoff_s = 0.01
    seen = []
    for round_i in range(3):
        prev = sick.probe_backoff
        # poll with a deadline, RETRYING the reprobe ask each pass: on
        # a loaded 2-core box the detached probe thread from the
        # previous round can still hold the probe guard, in which case
        # a single maybe_reprobe() call is a silent no-op and a fixed
        # wait misses the whole backoff window
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline \
                and sick.probe_backoff == prev and not sick.healthy:
            with rs._lock:
                sick.probe_at = 0.0
            rs.maybe_reprobe()
            time.sleep(0.005)
        assert sick.probe_backoff > prev, \
            f"round {round_i}: no probe ran within the deadline {seen}"
        seen.append(sick.probe_backoff)
        assert not sick.healthy  # the crasher is still installed
    assert seen[0] < seen[1] < seen[2], seen  # doubling, not constant
    assert seen[-1] <= rs.probe_backoff_max_s
    im.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_coalescer_crash_net_covers_multi_replica_inflight():
    """The dispatcher dying with a group in flight ON A REPLICA SLOT
    must fail every waiter and release the slot accounting — the
    single-device crash net's contract through the replica scheduler's
    in-flight bookkeeping."""
    from analytics_zoo_tpu_torch.pipeline.inference import \
        CoalescerClosedError

    im = InferenceModel(supported_concurrent_num=2, max_batch_size=2,
                        coalescing=True, max_wait_ms=1.0, replicas=2)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(1.0)})
    im.warmup((2,))
    c = im._coalescer
    assert c._rs is not None and c._rs.n == 2

    gate, entered = threading.Event(), threading.Event()
    orig = c._cache.dispatch_padded

    def blocking_dispatch(batched, spans=(), replica=None):
        entered.set()
        gate.wait(timeout=30)
        return orig(batched, spans, replica=replica)

    c._cache.dispatch_padded = blocking_dispatch  # instance attr shadow
    f1 = c.submit(np.ones((1, 2), np.float32))
    assert entered.wait(timeout=10)  # f1's group mid-dispatch on a slot

    def bad_gather(*a, **k):
        raise RuntimeError("injected dispatcher crash")

    c._gather = bad_gather
    f2 = c.submit(np.ones((1, 2), np.float32))
    f3 = c.submit(np.ones((1, 2), np.float32))
    gate.set()

    for f in (f2, f3):
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=10)
    try:
        f1.result(timeout=10)  # resolved or crash-net-failed, never hung
    except RuntimeError:
        pass
    c._thread.join(timeout=10)
    assert not c._thread.is_alive()
    assert c.pending == 0
    with pytest.raises(CoalescerClosedError):
        c.submit(np.ones((1, 2), np.float32))
    # the crash returned every device-concurrency slot: the solo
    # fallback path must not wedge
    out = im._cache.run(np.ones((1, 2), np.float32),
                        sem=im._semaphore)
    np.testing.assert_array_equal(out, np.ones((1, 2), np.float32))


def test_module_replicas_under_thread_stress_never_mix_replicas():
    """A module's replicas share one skeleton (``functional_call`` swaps
    a replica's tensors in for its forward).  With each replica's
    weights made distinct, 24 threads (more than the cores) on a short
    switch interval, through the solo path and the coalescer, must each
    get one replica's rows at the bucket: a forward that ran on another
    replica's swapped-in tensors, or on a mix, gives none of them."""
    import sys

    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    m = Sequential(device="cpu", seed=4)
    m.add(Dense(16, input_shape=(4,), activation="relu"))
    m.add(Dense(3))
    m.eval()
    rng = np.random.default_rng(8)
    xs = [rng.normal(size=(2, 4)).astype(np.float32) for _ in range(24)]
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for coalescing in (False, True):
            im = InferenceModel(supported_concurrent_num=4, buckets=[8],
                                coalescing=coalescing, replicas=4,
                                max_wait_ms=1.0).load_keras_net(m)
            rs = im._cache.replica_set
            for r in rs.replicas[1:]:
                for t in r.params.values():
                    if t.is_floating_point():
                        t.mul_(1.0 + 0.25 * r.index)
            fn = rs._fn
            with torch.no_grad():
                wants = [[fn(r.params, torch.from_numpy(np.concatenate(
                    [x, np.zeros((6, 4), np.float32)]))).numpy()[:2]
                    for r in rs.replicas] for x in xs]
            outs = [[] for _ in xs]

            def worker(i):
                try:
                    for _ in range(40):
                        outs[i].append(im.predict(xs[i]))
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(repr(e))

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(xs))]
            [t.start() for t in threads]
            [t.join(timeout=60) for t in threads]
            assert not any(t.is_alive() for t in threads)
            im.close()
            for got, want in zip(outs, wants):
                assert len(got) == 40
                for g in got:
                    assert any(np.array_equal(g, w) for w in want)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
