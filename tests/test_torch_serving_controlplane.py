"""Port counterpart of ``tests/test_serving_controlplane.py``: the
registry's hot swap, admission control, deadline shedding, canary split
and metrics snapshot, on ``analytics_zoo_tpu_torch.serving`` on the CPU.
Every registry here serves on the CPU (``device="cpu"`` rides the
registry's model defaults), and raw functions deploy as ``fn=``.
"""


import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.serving import (
    AdmissionController, DeadlineExceeded, DeployError, ModelNotFound,
    Overloaded)
from analytics_zoo_tpu_torch.serving import ModelRegistry as _Registry


def ModelRegistry(*args, **kwargs):
    """A registry whose models serve on the CPU."""
    kwargs.setdefault("device", "cpu")
    return _Registry(*args, **kwargs)


def _const_fn(c):
    """A forward whose every output row is the constant ``c`` — two
    versions are distinguishable per-row, so a torn (half-swapped)
    response would be visible as a mixed-constant output."""
    return lambda p, x: x * 0.0 + p["c"], {"c": np.float32(c)}


def _deploy_const(reg, name, c, **kw):
    fn, params = _const_fn(c)
    return reg.deploy(name, fn=fn, params=params, **kw)


# --------------------------------------------------------------- registry
def test_deploy_predict_and_versioning():
    with ModelRegistry(max_concurrency=2) as reg:
        v1 = _deploy_const(reg, "m", 1.0, warmup_shapes=(3,))
        assert v1 == 1
        out = reg.predict("m", np.zeros((2, 3), np.float32))
        np.testing.assert_array_equal(out, np.ones((2, 3), np.float32))
        v2 = _deploy_const(reg, "m", 2.0)  # warmup shapes remembered
        assert v2 == 2
        out, info = reg.predict_ex("m", np.zeros((1, 3), np.float32))
        np.testing.assert_array_equal(out, 2 * np.ones((1, 3)))
        assert info == {"model": "m", "version": 2, "canary": False}
        assert reg.models() == {"m": 2}
        m = reg.metrics("m")["m"]
        assert m["active_version"] == 2
        assert m["swap_count"] == 1
        # the data plane's bucket stats are re-exported per model
        assert m["serving"]["buckets"]
        assert m["versions"][1]["state"] == "retired"


def test_unknown_model_raises_structured():
    with ModelRegistry() as reg:
        with pytest.raises(ModelNotFound) as ei:
            reg.predict("nope", np.zeros((1, 2), np.float32))
        assert ei.value.http_status == 404
        assert ei.value.to_dict()["error"] == "ModelNotFound"


def test_deploy_needs_a_model():
    with ModelRegistry() as reg:
        with pytest.raises(DeployError):
            reg.deploy("m")


# ----------------------------------------------------- pinned: hot swap
def test_hot_swap_under_traffic_zero_failures_no_tearing():
    """THE pinned test: concurrent predict() traffic across deploy():
    no request fails, and every response is entirely v1's or entirely
    v2's output (constant rows — a mix would show)."""
    with ModelRegistry(max_concurrency=4,
                       supported_concurrent_num=4, coalescing=True,
                       max_wait_ms=1.0) as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(4,))
        results, failures = [], []
        lock = threading.Lock()
        stop = threading.Event()
        go = threading.Event()

        def client():
            go.wait()
            x = np.zeros((3, 4), np.float32)
            while not stop.is_set():
                try:
                    out = np.asarray(reg.predict("m", x))
                    with lock:
                        results.append(out)
                except Exception as e:  # noqa: BLE001 — asserted empty
                    with lock:
                        failures.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(6)]
        [t.start() for t in threads]
        go.set()
        try:
            time.sleep(0.15)          # v1-only traffic
            _deploy_const(reg, "m", 2.0)  # swap mid-traffic
            time.sleep(0.3)           # v2 traffic
        finally:
            stop.set()  # a failed deploy must not strand the clients
            [t.join(timeout=60) for t in threads]

        assert not failures, failures[:5]
        seen = set()
        for out in results:
            vals = np.unique(out)
            # entirely one version: a single constant fills the output
            assert vals.size == 1, f"torn response: {vals}"
            seen.add(float(vals[0]))
        assert seen == {1.0, 2.0}, seen  # traffic straddled the swap
        m = reg.metrics("m")["m"]
        assert m["admission"]["errors"] == 0
        assert m["swap_count"] == 1


def test_hot_swap_under_multi_replica_traffic_drains_every_replica():
    """A hot-swap while traffic spans FOUR device replicas
    completes with zero failed and zero torn responses; the displaced
    version's coalescer drains every replica's in-flight groups; the
    new version arrives fully placed (one compile per bucket, every
    replica healthy and primed) and admission re-scales with it."""
    with ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                       coalescing=True, max_wait_ms=1.0,
                       max_batch_size=8, replicas=4) as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(4,))
        entry = reg._entry("m")
        assert entry.admission.max_concurrency == 8  # 2 * 4 replicas
        v1_model = entry.active.model
        assert v1_model.n_replicas == 4
        results, failures = [], []
        lock = threading.Lock()
        stop = threading.Event()
        go = threading.Event()

        def client():
            go.wait()
            x = np.zeros((2, 4), np.float32)
            while not stop.is_set():
                try:
                    out = np.asarray(reg.predict("m", x))
                    with lock:
                        results.append(out)
                except Exception as e:  # noqa: BLE001 — asserted empty
                    with lock:
                        failures.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(8)]
        [t.start() for t in threads]
        go.set()
        try:
            time.sleep(0.15)
            _deploy_const(reg, "m", 2.0)  # swap mid-traffic
            time.sleep(0.3)
        finally:
            stop.set()
            [t.join(timeout=60) for t in threads]

        assert not failures, failures[:5]
        seen = set()
        for out in results:
            vals = np.unique(out)
            assert vals.size == 1, f"torn response: {vals}"
            seen.add(float(vals[0]))
        assert seen == {1.0, 2.0}, seen
        m = reg.metrics("m")["m"]
        assert m["admission"]["errors"] == 0
        assert m["swap_count"] == 1
        # the displaced version drained: its coalescer is closed with
        # nothing pending on any replica slot
        assert v1_model._coalescer.closed
        assert v1_model._coalescer.pending == 0
        assert all(c == 0 for c in v1_model._coalescer._slot_inflight)
        # the new version is fully placed and healthy on all replicas
        serving = m["serving"]
        assert serving["replicas"] == 4
        assert all(v == 1 for v in serving["misses"].values()), serving
        assert not any(serving["replica_unhealthy"].values())
        v1_traffic = sum(1 for o in results if float(o.flat[0]) == 1.0)
        v2_traffic = sum(1 for o in results if float(o.flat[0]) == 2.0)
        assert v1_traffic and v2_traffic


def test_warmup_failure_rolls_back_to_prior_version():
    with ModelRegistry() as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(3,))

        def bad(p, x):
            raise RuntimeError("boom at trace time")

        with pytest.raises(DeployError) as ei:
            reg.deploy("m", fn=bad, params={})
        assert ei.value.details["stage"] == "warmup"
        assert ei.value.details["active_version"] == 1
        # v1 was never unplugged
        out = reg.predict("m", np.zeros((2, 3), np.float32))
        np.testing.assert_array_equal(out, np.ones((2, 3)))
        assert reg.metrics("m")["m"]["active_version"] == 1
        assert reg.metrics("m")["m"]["swap_count"] == 0


def test_first_deploy_warmup_failure_leaves_no_active_version():
    with ModelRegistry() as reg:
        def bad(p, x):
            raise RuntimeError("boom")

        with pytest.raises(DeployError):
            reg.deploy("m", fn=bad, params={}, warmup_shapes=(3,))
        with pytest.raises(ModelNotFound):
            reg.predict("m", np.zeros((1, 3), np.float32))


# ------------------------------------------------------------- canary
def test_canary_split_exact_fraction_then_promote():
    with ModelRegistry() as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(2,))
        v2 = _deploy_const(reg, "m", 2.0, canary_fraction=0.25)
        assert reg.models() == {"m": 1}  # canary is staged, not active
        x = np.zeros((1, 2), np.float32)
        outs = [float(np.asarray(reg.predict("m", x))[0, 0])
                for _ in range(80)]
        # error-accumulator routing: exactly 25% to the canary
        assert outs.count(2.0) == 20
        assert outs.count(1.0) == 60
        m = reg.metrics("m")["m"]
        assert m["canary"] == {"version": v2, "fraction": 0.25}
        assert m["versions"][v2]["requests"] == 20

        assert reg.promote("m") == v2
        assert reg.models() == {"m": v2}
        out = reg.predict("m", x)
        assert float(np.asarray(out)[0, 0]) == 2.0
        assert reg.metrics("m")["m"]["canary"] is None
        assert reg.metrics("m")["m"]["swap_count"] == 1


def test_canary_redeploy_resets_routing_accumulator():
    """Pinned: the canary routing
    accumulator is owned by route_lock and reset under it on every
    canary deploy — routing after a re-deploy restarts deterministically
    from zero instead of inheriting the displaced canary's leftovers
    (or losing the reset to a racing _route increment)."""
    with ModelRegistry() as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(2,))
        _deploy_const(reg, "m", 2.0, canary_fraction=0.5)
        x = np.zeros((1, 2), np.float32)
        # acc: 0.5 (active), 1.0 -> fires (canary), 0.5 (active)
        flags = [reg.predict_ex("m", x)[1]["canary"] for _ in range(3)]
        assert flags == [False, True, False]
        # a NEW canary mid-cycle: acc restarts at exactly zero
        _deploy_const(reg, "m", 3.0, canary_fraction=0.5)
        flags = [reg.predict_ex("m", x)[1]["canary"] for _ in range(4)]
        assert flags == [False, True, False, True]


def test_retired_state_flips_after_drain_metrics_stay_responsive():
    """Pinned: a displaced deployment's
    state flips to 'retired' under entry.lock only AFTER its drain
    (model.close()) completes — while draining it is truthfully not yet
    retired — and metrics() stays responsive throughout a slow drain
    (it takes entry.lock, never deploy_lock)."""
    class SlowCloseModel:
        def __init__(self):
            self.close_entered = threading.Event()
            self.closed = threading.Event()

        def predict(self, x):
            return np.asarray(x)

        def close(self):
            self.close_entered.set()
            time.sleep(0.4)
            self.closed.set()

        def serving_stats(self):
            return {}

    slow = SlowCloseModel()
    with ModelRegistry(max_concurrency=2) as reg:
        reg.deploy("m", model=slow)
        samples = []

        def watcher():
            slow.close_entered.wait(5)
            while True:
                m = reg.metrics("m")["m"]
                drained = slow.closed.is_set()  # AFTER the read: sound
                if drained:
                    return
                v1 = m["versions"].get(1)
                samples.append(None if v1 is None else v1["state"])
                time.sleep(0.02)

        t = threading.Thread(target=watcher)
        t.start()
        fn, params = _const_fn(2.0)
        reg.deploy("m", fn=fn, params=params)  # displaces slow
        t.join(10)
        assert not t.is_alive()
        # metrics were served DURING the 0.4s drain, and never showed
        # the draining version as already-retired
        assert len(samples) >= 3, samples
        assert "retired" not in samples, samples
        assert reg.metrics("m")["m"]["versions"][1]["state"] == "retired"


def test_clear_canary_restores_all_traffic_to_active():
    with ModelRegistry() as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(2,))
        _deploy_const(reg, "m", 2.0, canary_fraction=0.5)
        reg.clear_canary("m")
        x = np.zeros((1, 2), np.float32)
        assert all(float(np.asarray(reg.predict("m", x))[0, 0]) == 1.0
                   for _ in range(10))
        assert reg.metrics("m")["m"]["canary"] is None
        with pytest.raises(ModelNotFound):
            reg.promote("m")


# ------------------------------------------------- admission controller
class _Gate:
    """A service body that blocks until released (to pin slots)."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self):
        self.release.wait(timeout=30)


def _spawn_admitted(ac, gate, n, deadline_ms=None):
    """n threads that admit and then block in the service body."""
    started = []

    def one():
        try:
            with ac.admit(deadline_ms=deadline_ms):
                gate()
        except Exception as e:  # noqa: BLE001
            started.append(e)

    ts = [threading.Thread(target=one) for _ in range(n)]
    [t.start() for t in ts]
    return ts, started


def _wait_until(pred, timeout=5.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_admission_queue_bound_and_immediate_overload():
    ac = AdmissionController(max_queue=3, max_concurrency=1)
    gate = _Gate()
    # one running + exactly max_queue waiting
    ts, errs = _spawn_admitted(ac, gate, 4)
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 3)
    t0 = time.perf_counter()
    with pytest.raises(Overloaded) as ei:
        with ac.admit():
            pass
    rejected_in = time.perf_counter() - t0
    assert rejected_in < 0.5  # immediate, not queued-until-timeout
    assert ei.value.details["queue_depth"] == 3
    gate.release.set()
    [t.join(timeout=60) for t in ts]
    assert not errs
    snap = ac.snapshot()
    assert snap["queue_high_water"] <= ac.max_queue
    assert snap["shed_overload"] == 1
    assert snap["completed"] == 4


def test_admission_predictive_shed_rejects_before_waiting():
    ac = AdmissionController(max_queue=10, max_concurrency=1)
    with ac.admit():  # seed the service-time EWMA
        time.sleep(0.05)
    gate = _Gate()
    ts, _ = _spawn_admitted(ac, gate, 3)  # 1 running + 2 queued
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 2)
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded) as ei:
        with ac.admit(deadline_ms=1.0):
            pass
    assert time.perf_counter() - t0 < 0.05  # shed at admission, no wait
    assert ei.value.details["shed"] is True
    assert ei.value.details["predicted_ms"] > 1.0
    assert ac.snapshot()["shed_deadline"] == 1
    gate.release.set()
    [t.join(timeout=60) for t in ts]


def test_admission_deadline_lapses_while_waiting():
    """No EWMA yet (nothing to predict from) — the request queues, then
    fails AT deadline lapse, not at some unbounded later timeout."""
    ac = AdmissionController(max_queue=4, max_concurrency=1)
    gate = _Gate()
    ts, _ = _spawn_admitted(ac, gate, 1)
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded) as ei:
        with ac.admit(deadline_ms=100):
            pass
    waited = time.perf_counter() - t0
    assert 0.08 <= waited < 2.0, waited
    assert ei.value.details["shed"] is False
    gate.release.set()
    [t.join(timeout=60) for t in ts]
    assert ac.snapshot()["deadline_lapsed"] == 1


def test_admission_drain_is_graceful():
    """drain(): new requests are refused, but everything already
    admitted — queued included — completes."""
    ac = AdmissionController(max_queue=4, max_concurrency=1)
    gate = _Gate()
    ts, errs = _spawn_admitted(ac, gate, 3)  # 1 running + 2 queued
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 2)
    drained = []
    dt = threading.Thread(target=lambda: drained.append(ac.drain(10.0)))
    dt.start()
    assert _wait_until(lambda: ac.draining)
    with pytest.raises(Overloaded) as ei:
        with ac.admit():
            pass
    assert ei.value.details.get("draining") is True
    assert ac.snapshot()["shed_draining"] == 1  # counted, not invisible
    gate.release.set()
    [t.join(timeout=60) for t in ts]
    dt.join(timeout=60)
    assert drained == [True]
    assert not errs  # the queued requests completed, not rejected
    assert ac.snapshot()["completed"] == 3


def test_admission_validates_config():
    with pytest.raises(ValueError):
        AdmissionController(max_queue=0)
    with pytest.raises(ValueError):
        AdmissionController(max_concurrency=0)


# ------------------------------------- acceptance: overload end to end
class _SlowModel:
    """Duck-typed serving handle with a controllable service time."""

    def __init__(self, service_s=0.02):
        self.service_s = service_s

    def predict(self, x):
        time.sleep(self.service_s)
        return x

    def close(self):
        pass

    def serving_stats(self):
        return {}


def test_overload_bounded_queue_and_deadlines_end_to_end():
    """Acceptance: saturating client against admission bound Q —
    queue depth never exceeds Q (high-water counter), rejections are
    structured and fast, accepted requests meet their deadlines."""
    Q, C, service_s = 4, 1, 0.02
    with ModelRegistry(max_queue=Q, max_concurrency=C) as reg:
        reg.deploy("m", model=_SlowModel(service_s))
        # generous deadline: fits the whole queue ahead + own service
        deadline_ms = 2000.0
        n_threads, per_thread = 12, 6
        ok_lat, rej_lat, errors = [], [], []
        lock = threading.Lock()
        go = threading.Event()
        x = np.zeros((1, 2), np.float32)

        def client():
            go.wait()
            for _ in range(per_thread):
                t0 = time.perf_counter()
                try:
                    reg.predict("m", x, deadline_ms=deadline_ms)
                    with lock:
                        ok_lat.append(time.perf_counter() - t0)
                except (Overloaded, DeadlineExceeded):
                    with lock:
                        rej_lat.append(time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(repr(e))

        ts = [threading.Thread(target=client) for _ in range(n_threads)]
        [t.start() for t in ts]
        go.set()
        [t.join(timeout=60) for t in ts]

        assert not errors, errors[:5]
        snap = reg.metrics("m")["m"]["admission"]
        # 12 saturating clients vs Q=4: the bound held and shed happened
        assert snap["queue_high_water"] <= Q
        assert rej_lat, "saturation never tripped admission"
        assert snap["shed"] == len(rej_lat)
        # rejections were immediate (vs the 2 s deadline they avoided)
        assert max(rej_lat) < 1.0, max(rej_lat)
        # accepted requests met their deadline
        assert ok_lat and max(ok_lat) <= deadline_ms / 1e3 + 0.5
        assert snap["completed"] == len(ok_lat)


# ----------------------------------------------------------- lifecycle
def test_undeploy_drains_and_removes():
    reg = ModelRegistry()
    _deploy_const(reg, "m", 1.0, warmup_shapes=(2,))
    assert reg.undeploy("m") is True
    with pytest.raises(ModelNotFound):
        reg.predict("m", np.zeros((1, 2), np.float32))
    with pytest.raises(ModelNotFound):
        reg.undeploy("m")


def test_shutdown_closes_everything_and_is_idempotent():
    reg = ModelRegistry()
    _deploy_const(reg, "a", 1.0, warmup_shapes=(2,))
    _deploy_const(reg, "b", 2.0, warmup_shapes=(2,))
    reg.shutdown()
    reg.shutdown()
    assert reg.models() == {}
    with pytest.raises(DeployError):
        _deploy_const(reg, "c", 3.0)


def test_concurrent_deploys_serialize_latest_wins():
    """Racing deploys must never leave the OLDER version active:
    whole deploys (build -> warmup -> swap) serialize per model, so
    versions are allocated in lock order and the last deploy to enter
    swaps last — even when the earlier one has a much slower warmup."""
    class SlowWarm:
        def __init__(self, tag, delay):
            self.tag, self.delay = tag, delay

        def warmup(self, shapes, dtypes=None):
            time.sleep(self.delay)

        def predict(self, x):
            return np.asarray(x) * 0.0 + self.tag

        def close(self):
            pass

        def serving_stats(self):
            return {}

    with ModelRegistry() as reg:
        reg.deploy("m", model=SlowWarm(1.0, 0.0), warmup_shapes=(2,))
        errs = []

        def deploy_one(delay):
            try:
                reg.deploy("m", model=SlowWarm(delay * 100, delay),
                           warmup_shapes=(2,))
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))

        ts = [threading.Thread(target=deploy_one, args=(d,))
              for d in (0.4, 0.0)]
        [t.start() for t in ts]
        [t.join(timeout=60) for t in ts]
        assert not errs, errs
        # versions 2 and 3 were allocated in serialization order; the
        # LAST one to enter swaps last and must be the one left active
        assert reg.models() == {"m": 3}
        m = reg.metrics("m")["m"]
        assert m["versions"][2]["state"] == "retired"
        assert m["versions"][3]["state"] == "active"


def test_prebuilt_handle_with_warmup_gets_warmed():
    """A duck-typed model= handle exposing warmup() is warmed before
    the swap (the registry must not silently skip step 2 just because
    the handle lacks InferenceModel's private _cache)."""
    calls = []

    class Handle:
        def warmup(self, shapes, dtypes=None):
            calls.append((shapes, dtypes))

        def predict(self, x):
            return x

        def close(self):
            pass

        def serving_stats(self):
            return {}

    with ModelRegistry() as reg:
        reg.deploy("m", model=Handle(), warmup_shapes=(4,))
        assert calls == [((4,), None)]


def test_canary_fraction_validated():
    with ModelRegistry() as reg:
        _deploy_const(reg, "m", 1.0, warmup_shapes=(2,))
        for bad in (1.5, -0.1, float("nan")):
            with pytest.raises(ValueError):
                _deploy_const(reg, "m", 2.0, canary_fraction=bad)
        assert reg.metrics("m")["m"]["canary"] is None


def test_deploy_racing_undeploy_discards_new_model_no_leak():
    """A deploy in flight when its model is undeployed must discard
    (and CLOSE) the new version instead of swapping it into the popped
    entry where nothing could ever close it."""
    warmup_entered = threading.Event()
    warmup_gate = threading.Event()
    closed = []

    class SlowWarm:
        def warmup(self, shapes, dtypes=None):
            warmup_entered.set()
            warmup_gate.wait(timeout=30)

        def predict(self, x):
            return x

        def close(self):
            closed.append(True)

        def serving_stats(self):
            return {}

    reg = ModelRegistry()
    _deploy_const(reg, "m", 1.0, warmup_shapes=(2,))
    outcome = []

    def deploy_slow():
        try:
            reg.deploy("m", model=SlowWarm(), warmup_shapes=(2,))
            outcome.append("deployed")
        except DeployError:
            outcome.append("discarded")

    t = threading.Thread(target=deploy_slow)
    t.start()
    assert warmup_entered.wait(timeout=10)
    undeployed = []
    u = threading.Thread(
        target=lambda: undeployed.append(reg.undeploy("m")))
    u.start()
    time.sleep(0.1)          # undeploy pops, then blocks on deploy_lock
    warmup_gate.set()
    t.join(timeout=60)
    u.join(timeout=60)
    assert outcome == ["discarded"]
    assert closed == [True]  # the orphaned new model was closed
    assert undeployed == [True]
    with pytest.raises(ModelNotFound):
        reg.predict("m", np.zeros((1, 2), np.float32))
    reg.shutdown()


def test_multi_model_isolation():
    """Two models, independent versions/admission/metrics."""
    with ModelRegistry() as reg:
        _deploy_const(reg, "a", 1.0, warmup_shapes=(2,))
        _deploy_const(reg, "b", 5.0, warmup_shapes=(3,))
        xa = np.zeros((1, 2), np.float32)
        xb = np.zeros((2, 3), np.float32)
        assert float(np.asarray(reg.predict("a", xa))[0, 0]) == 1.0
        np.testing.assert_array_equal(reg.predict("b", xb),
                                      5.0 * np.ones((2, 3)))
        _deploy_const(reg, "b", 6.0)
        assert reg.models() == {"a": 1, "b": 2}
        m = reg.metrics()
        assert m["a"]["swap_count"] == 0
        assert m["b"]["swap_count"] == 1


# ------------------------------------------------ elasticity satellites
def test_ewma_resets_on_activation_swap_then_admit():
    """A slow v1 seeds the service-time EWMA; activating a fast v2
    must reset it, or v2 would predictively shed deadline requests it
    could easily meet (the estimate describes the RETIRED model)."""
    reg = ModelRegistry(max_queue=8, max_concurrency=1)
    reg.deploy("m", model=_SlowModel(service_s=0.08))
    for _ in range(3):  # seed the EWMA with the slow version
        reg.predict("m", np.ones(2))
    entry = reg._entry("m")
    assert entry.admission.snapshot()["service_ewma_ms"] > 50

    reg.deploy("m", model=_SlowModel(service_s=0.0))  # the fast v2
    snap = entry.admission.snapshot()
    assert snap["service_ewma_ms"] is None, snap
    # swap-then-admit: a deadline v1 could never meet sails through
    # (predictive shedding has nothing stale to predict from)
    out = reg.predict("m", np.ones(2), deadline_ms=20)
    assert out is not None
    assert entry.admission.snapshot()["shed_deadline"] == 0
    # promote() resets too, not just direct activation
    reg.deploy("m", model=_SlowModel(service_s=0.06),
               canary_fraction=0.5)
    for _ in range(4):
        reg.predict("m", np.ones(2))
    assert entry.admission.snapshot()["service_ewma_ms"] is not None
    reg.promote("m")
    assert entry.admission.snapshot()["service_ewma_ms"] is None
    reg.shutdown()


def test_registry_priority_class_plumbs_through_admission():
    """predict_ex(priority_class=...) reaches the model's admission
    controller: per-class admitted counters move, and the classes from
    the registry-level config exist on every model's controller."""
    reg = ModelRegistry(max_queue=4, max_concurrency=2,
                        priority_classes={"interactive": (10, 0.9),
                                          "batch": (0, 0.1)})
    reg.deploy("m", model=_SlowModel(service_s=0.0))
    reg.predict("m", np.ones(2), priority_class="batch")
    out, info = reg.predict_ex("m", np.ones(2),
                               priority_class="interactive")
    assert info["version"] == 1
    classes = reg._entry("m").admission.snapshot()["classes"]
    assert classes["batch"]["admitted"] == 1
    assert classes["interactive"]["admitted"] == 1
    assert classes["interactive"]["priority"] == 10
    reg.shutdown()


# ------------------------------- registry generate and traced requests
def _small_lm():
    """A 2-layer TransformerLM on the CPU with a sharp seeded head (greedy
    picks far from f32 ties)."""
    import torch

    from analytics_zoo_tpu_torch.models import TransformerLM
    lm = TransformerLM(vocab_size=64, seq_len=48, n_layers=2, d_model=32,
                       n_heads=2, device="cpu")
    with torch.no_grad():
        lm.lm_head.W.mul_(5.0)
    return lm.eval()


def test_registry_generate_and_decode_families():
    """The registry's generate path: a request passes admission into the
    deployed version's decode engine, its stream equals the model's own
    greedy ``generate``, the span carries the decode phases, the
    counters tick and the Prometheus bridge exports the decode
    families."""
    from analytics_zoo_tpu_torch.observability import Tracer
    from analytics_zoo_tpu_torch.serving import registry_families

    lm = _small_lm()
    tracer = Tracer()
    reg = ModelRegistry(tracer=tracer)
    try:
        reg.deploy("lm", lm, decode_capacity=2, decode_max_len=48,
                   decode_prompt_buckets=(16,))
        prompt = np.random.default_rng(29).integers(0, 64, 6)
        out, info = reg.generate_ex("lm", [prompt], 5)
        want = lm.generate(prompt[None, :], 5)[0, -5:]
        np.testing.assert_array_equal(out[0], want)
        assert info["model"] == "lm" and info["version"] == 1
        trace = tracer.find(info["request_id"])
        phases = {p["name"] for p in trace["phases"]}
        assert {"prefill", "decode_step"} <= phases, phases
        assert reg.metrics("lm")["lm"]["versions"][1]["requests"] == 1
        fams = {f.name: f for f in registry_families(reg.metrics())}
        for name in ("zoo_decode_tokens_total", "zoo_decode_steps_total",
                     "zoo_decode_slot_occupancy",
                     "zoo_decode_slot_capacity"):
            assert name in fams, name
        (tok_labels, tok_v), = fams["zoo_decode_tokens_total"].samples
        assert tok_labels["model"] == "lm" and tok_v == 5
        (cap_labels, cap_v), = fams["zoo_decode_slot_capacity"].samples
        assert cap_labels["model"] == "lm" and cap_v == 2
        assert fams["zoo_decode_tokens_total"].mtype == "counter"
        assert fams["zoo_decode_slot_occupancy"].mtype == "gauge"
        # a decode-capable deployment stays pinned under a pager
        assert reg._build_recipe(1, reg._entry("lm").active.model,
                                 {}, None, None) is None
    finally:
        reg.shutdown()


def _phase_names(d):
    """Consecutive-deduped phase names of a span dict."""
    import itertools
    return [k for k, _ in itertools.groupby(p["name"] for p in d["phases"])]


def test_registry_traced_request_and_metric_satellites():
    import datetime

    from analytics_zoo_tpu_torch.observability import (
        Tracer, parse_prometheus_text, render_prometheus)
    from analytics_zoo_tpu_torch.serving import registry_families

    tracer = Tracer()
    reg = ModelRegistry(tracer=tracer, coalescing=True)
    try:
        reg.deploy("m", fn=lambda p, x: x @ p["w"],
                   params={"w": np.eye(4, dtype=np.float32)},
                   warmup_shapes=(4,))
        out, info = reg.predict_ex("m", np.ones((2, 4), np.float32),
                                   trace_id="rid-1")
        assert info["request_id"] == "rid-1"
        d = tracer.find("rid-1")
        assert _phase_names(d) == ["admission_queue", "coalesce_wait",
                                   "pad", "device_put", "execute",
                                   "depad"]
        assert d["labels"]["model"] == "m"
        assert d["labels"]["version"] == 1
        m = reg.metrics()["m"]
        v1 = m["versions"][1]
        parsed = datetime.datetime.fromisoformat(v1["deployed_at"])
        assert parsed.tzinfo is not None
        assert v1["uptime_s"] >= 0
        assert m["canary_fraction"] == 0.0
        reg.deploy("m", fn=lambda p, x: x @ p["w"],
                   params={"w": np.eye(4, dtype=np.float32) * 2},
                   canary_fraction=0.25)
        assert reg.metrics()["m"]["canary_fraction"] == 0.25
        fams = registry_families(reg.metrics())
        parsed = parse_prometheus_text(render_prometheus(fams))
        key = ("zoo_model_requests_total",
               (("model", "m"), ("version", "1")))
        assert parsed["samples"][key] == 1.0
        assert parsed["samples"][
            ("zoo_model_version_state",
             (("model", "m"), ("state", "active"),
              ("version", "1")))] == 1.0
        assert parsed["samples"][
            ("zoo_model_canary_fraction", (("model", "m"),))] == 0.25
        assert any(k[0] == "zoo_model_uptime_seconds"
                   for k in parsed["samples"])
        assert any(k[0] == "zoo_bucket_misses_total"
                   and dict(k[1])["bucket"] for k in parsed["samples"])
    finally:
        reg.shutdown()


def test_shed_request_span_is_finished_with_error_label():
    from analytics_zoo_tpu_torch.observability import Tracer

    tracer = Tracer()
    reg = ModelRegistry(tracer=tracer, coalescing=False)
    try:
        reg.deploy("m", fn=lambda p, x: x * p["s"],
                   params={"s": np.float32(1.0)}, warmup_shapes=(4,))
        reg.predict("m", np.ones((1, 4), np.float32))  # seed the EWMA
        with pytest.raises(DeadlineExceeded):
            reg.predict_ex("m", np.ones((1, 4), np.float32),
                           deadline_ms=0.0001, trace_id="shed-1")
        d = tracer.find("shed-1")
        assert d is not None
        assert d["labels"]["error"] == "DeadlineExceeded"
        assert all(p["dur_ms"] is not None for p in d["phases"])
    finally:
        reg.shutdown()
