"""Port counterpart of ``tests/test_serving_pager.py``: the weight pager
(page-out, fault-in, LRU budget, in-flight-safe eviction, cold-start
timeouts, families and spans) on ``analytics_zoo_tpu_torch.serving`` on
the CPU.
"""


import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.serving import (AdmissionController,
                                             ColdStartTimeout, DeployError,
                                             ModelNotFound,
                                             registry_families)
from analytics_zoo_tpu_torch.serving import ModelRegistry as _Registry


def ModelRegistry(*args, **kwargs):
    """A registry whose models serve on the CPU."""
    kwargs.setdefault("device", "cpu")
    return _Registry(*args, **kwargs)


def _const_fn(c):
    return lambda p, x: x * 0.0 + p["c"], {"c": np.float32(c)}


def _deploy_const(reg, name, c, **kw):
    fn, params = _const_fn(c)
    kw.setdefault("warmup_shapes", (3,))
    return reg.deploy(name, fn=fn, params=params, **kw)


def _paged_registry(budget=1, **pager_kw):
    pager_kw.setdefault("max_resident", budget)
    pager_kw.setdefault("quiesce_timeout_s", 1.0)
    return ModelRegistry(max_concurrency=2, pager=pager_kw)


X = np.zeros((2, 3), np.float32)


# ------------------------------------------------------- state machine
def test_page_out_and_fault_in_bitexact():
    """Budget 1, two models: serving either must evict the other, and
    every response through any number of cycles equals the unpaged
    answer."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        m = reg.metrics()
        states = {n: v["pager"]["state"] for n, v in m.items()}
        assert sorted(states.values()) == ["cold", "resident"]
        for _ in range(3):
            np.testing.assert_array_equal(
                reg.predict("a", X), np.ones((2, 3)))
            np.testing.assert_array_equal(
                reg.predict("b", X), 2 * np.ones((2, 3)))
        pa = reg.metrics("a")["a"]["pager"]
        assert pa["fault_ok"] >= 2 and pa["fault_error"] == 0
        assert reg.pager.resident_count() <= 1


def test_budget_n_keeps_n_resident():
    """A budget of N serves N resident models — pinned: the budget
    check must not count the incoming entry
    against its own slot (N would silently behave as N-1, doubling
    fault/evict churn for a fitting working set)."""
    with _paged_registry(budget=2) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        for _ in range(3):
            reg.predict("a", X)
            reg.predict("b", X)
        m = reg.metrics()
        assert all(v["pager"]["state"] == "resident"
                   for v in m.values())
        assert sum(v["pager"]["evict_pressure"]
                   for v in m.values()) == 0
        _deploy_const(reg, "c", 3.0)  # the third exceeds: LRU evicts
        assert reg.pager.resident_count() == 2


def test_resident_hot_path_never_touches_pager_lock():
    """Pinned: a warmed resident model's
    requests acquire the pager lock zero times."""
    with _paged_registry(budget=2) as reg:
        _deploy_const(reg, "a", 1.0)
        reg.predict("a", X)
        la0 = reg.pager.lock_acquisitions
        for _ in range(25):
            reg.predict("a", X)
        assert reg.pager.lock_acquisitions == la0


def test_keras_graph_paging_bitexact():
    """The keras path pages through a skeleton on the meta device: host
    copies of the weights, rebuilt bit-exact on fault-in through
    ``load_fn``."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    def net():
        m = Sequential(device="cpu")
        m.add(Dense(8, input_shape=(6,), activation="tanh"))
        m.add(Dense(4))
        return m

    x = np.random.default_rng(0).normal(size=(3, 6)).astype(np.float32)
    with _paged_registry(budget=1) as reg:
        reg.deploy("k", net=net(), warmup_shapes=(6,))
        expect = np.asarray(reg.predict("k", x))
        _deploy_const(reg, "other", 1.0)
        reg.predict("other", X)  # pressure-evicts k
        assert reg.metrics("k")["k"]["pager"]["state"] == "cold"
        np.testing.assert_array_equal(reg.predict("k", x), expect)


def test_unpageable_deploys_stay_pinned():
    """A prebuilt (duck-typed) handle cannot be rebuilt from a recipe:
    it deploys unpaged (no pager block in metrics) and keeps serving
    under pressure from paged neighbors."""

    class Duck:
        def predict(self, x):
            return np.asarray(x) + 7.0

        def close(self):
            pass

    with _paged_registry(budget=1) as reg:
        reg.deploy("duck", model=Duck())
        assert "pager" not in reg.metrics("duck")["duck"]
        _deploy_const(reg, "paged", 1.0)
        reg.predict("paged", X)
        np.testing.assert_array_equal(reg.predict("duck", X), X + 7.0)


def test_pageable_false_pins_and_detaches():
    """pageable=False re-deploy of a paged entry pins it: the pager
    forgets it and later pressure never demotes it."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        assert reg.metrics("a")["a"]["pager"]["state"] == "resident"
        _deploy_const(reg, "a", 3.0, pageable=False)
        assert "pager" not in reg.metrics("a")["a"]
        _deploy_const(reg, "b", 2.0)
        reg.predict("b", X)
        np.testing.assert_array_equal(
            reg.predict("a", X), 3 * np.ones((2, 3)))


def test_canary_on_paged_entry_rejected():
    """Canary staging never swaps the active version, so there is no
    safe detach moment for a possibly-cold active — the deploy fails
    structured, telling the operator to pin first."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        with pytest.raises(DeployError, match="pageable=False"):
            _deploy_const(reg, "a", 2.0, canary_fraction=0.5)


# ------------------------------------------------- races (satellites)
def test_concurrent_first_requests_share_one_fault():
    """Two (here: six) concurrent first-requests to one cold model:
    exactly ONE rebuild runs (no duplicate device_put), the rest wait
    on the pager condition and then serve the faulted-in handle."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        reg.predict("b", X)  # b resident, a cold
        entry = reg._entries["a"]
        assert entry.pager_state == "cold"
        builds = []
        real = entry.pager_recipe.build

        def counting_build(span=None):
            builds.append(threading.get_ident())
            time.sleep(0.15)  # widen the race window
            return real(span=span)

        entry.pager_recipe.build = counting_build
        outs, errs = [], []

        def hit():
            try:
                outs.append(np.asarray(reg.predict("a", X)))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=hit) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not errs
        assert len(builds) == 1  # the single fault
        assert all(np.array_equal(o, np.ones((2, 3))) for o in outs)


def test_eviction_aborts_while_request_inflight():
    """A model evicted while a request is mid-call: the evictor's
    quiesce wait sees the in-flight balance, aborts, and restores
    residency — the request completes on live executables."""
    with _paged_registry(budget=2, quiesce_timeout_s=0.3) as reg:
        _deploy_const(reg, "a", 1.0)
        reg.predict("a", X)
        entry = reg._entries["a"]
        dep = entry.active
        release = threading.Event()
        inside = threading.Event()
        real_predict = dep.model.predict

        def slow_predict(x):
            inside.set()
            release.wait(timeout=10)
            return real_predict(x)

        dep.model.predict = slow_predict
        res = []
        t = threading.Thread(
            target=lambda: res.append(
                np.asarray(reg.predict("a", X))))
        t.start()
        assert inside.wait(timeout=10)
        # mid-request eviction must refuse
        assert reg.pager._try_evict("a", entry, "idle") is False
        assert entry.pager_state == "resident"
        release.set()
        t.join(timeout=10)
        np.testing.assert_array_equal(res[0], np.ones((2, 3)))
        # quiesced now: the same eviction succeeds
        assert reg.pager._try_evict("a", entry, "idle") is True
        assert entry.pager_state == "cold" and dep.model is None


def test_fault_racing_undeploy_discards_rebuild():
    """Undeploy mid-fault: the faulter's rebuild sees the generation
    bump, closes the fresh handle instead of installing it, and the
    request fails structured (ModelNotFound) — nothing leaks, nothing
    deadlocks."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        reg.predict("b", X)  # a cold
        entry = reg._entries["a"]
        built = []
        real = entry.pager_recipe.build
        started = threading.Event()

        def slow_build(span=None):
            started.set()
            time.sleep(0.4)
            im = real(span=span)
            built.append(im)
            return im

        entry.pager_recipe.build = slow_build
        errs = []

        def hit():
            try:
                reg.predict("a", X)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=hit)
        t.start()
        assert started.wait(timeout=10)
        reg.undeploy("a", drain_timeout=0.1)
        t.join(timeout=15)
        assert not t.is_alive()
        assert len(errs) == 1 and isinstance(errs[0], ModelNotFound)
        # the stale rebuild was closed, not leaked into the entry
        assert len(built) == 1
        assert built[0]._coalescer is None or built[0]._coalescer.closed
        assert entry.pager_state is None and entry.active is None


def test_redeploy_while_cold_serves_new_version():
    """Deploying v2 of a cold entry swaps a live handle in and bumps
    the pager generation: requests serve v2 immediately, and the old
    cold deployment retires without a handle to close."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        reg.predict("b", X)  # a cold
        assert reg._entries["a"].pager_state == "cold"
        _deploy_const(reg, "a", 5.0)
        out, info = reg.predict_ex("a", X)
        assert info["version"] == 2
        np.testing.assert_array_equal(out, 5 * np.ones((2, 3)))


# -------------------------------------------- cold-start SLO semantics
def test_coldstart_timeout_structured_503():
    """A faulting request queues under its deadline; past it, the
    structured 503 — and the fault still completes, so the NEXT
    request lands hot."""
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        reg.predict("b", X)
        # warm the admission EWMA with fast requests so the predictive
        # shed cannot fire before the pager sees the deadline
        for _ in range(3):
            reg.predict("b", X)
        entry = reg._entries["a"]
        real = entry.pager_recipe.build

        def slow_build(span=None):
            time.sleep(0.5)
            return real(span=span)

        entry.pager_recipe.build = slow_build
        with pytest.raises(ColdStartTimeout) as ei:
            reg.predict("a", X, deadline_ms=100)
        assert ei.value.http_status == 503
        assert ei.value.details["model"] == "a"
        assert ei.value.details["waited_ms"] >= 100
        p = reg.metrics("a")["a"]["pager"]
        # ONE outcome per requesting thread (pinned):
        # a fault completing past the deadline is a timeout, not ALSO
        # an ok — sum over outcomes must equal requests
        assert p["fault_timeout"] == 1 and p["fault_ok"] == 0
        # the completed fault serves the next caller hot
        entry.pager_recipe.build = real
        np.testing.assert_array_equal(
            reg.predict("a", X, deadline_ms=5000), np.ones((2, 3)))
        # pinned: the TIMED-OUT fault's ~0.5 s wall is
        # excluded from the service EWMA too (the raise path), so it
        # cannot predictively shed the traffic behind it
        ewma = entry.admission.snapshot()["service_ewma_ms"]
        assert ewma is not None and ewma < 100.0


def test_fault_seconds_excluded_from_service_ewma():
    """Admission-integrated: one slow fault must not poison the
    steady-state EWMA that predictive deadline shedding reads."""
    ac = AdmissionController(max_queue=4, max_concurrency=1)
    with ac.admit() as grant:
        time.sleep(0.25)
        grant.exclude_service_s(0.25)
    ewma = ac.snapshot()["service_ewma_ms"]
    assert ewma is not None and ewma < 100.0


def test_idle_eviction_demotes_and_refaults():
    with _paged_registry(budget=4, idle_evict_s=0.15,
                         reap_interval_s=0.05) as reg:
        _deploy_const(reg, "a", 1.0)
        deadline = time.monotonic() + 10
        while (reg._entries["a"].pager_state != "cold"
               and time.monotonic() < deadline):
            time.sleep(0.02)
        p = reg.metrics("a")["a"]["pager"]
        assert p["state"] == "cold" and p["evict_idle"] >= 1
        np.testing.assert_array_equal(
            reg.predict("a", X), np.ones((2, 3)))


# ------------------------------------------------------- observability
def test_pager_metric_families():
    with _paged_registry(budget=1) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        reg.predict("a", X)
        fams = {f.name: f for f in registry_families(reg.metrics())}
        res = {s[0]["model"]: s[1]
               for s in fams["zoo_model_resident"].samples}
        assert res["a"] == 1 and res["b"] == 0
        faults = {(s[0]["model"], s[0]["outcome"]): s[1]
                  for s in fams["zoo_pager_faults_total"].samples}
        assert faults[("a", "ok")] >= 1
        evicts = {(s[0]["model"], s[0]["reason"]): s[1]
                  for s in fams["zoo_pager_evictions_total"].samples}
        assert evicts[("b", "pressure")] >= 1
        # fault-phase span vocabulary is registered taxonomy
        from analytics_zoo_tpu_torch.observability.trace import PHASES
        for ph in ("pager_wait", "weights_h2d", "exec_rehydrate"):
            assert ph in PHASES


def test_fault_span_carries_pager_phases():
    from analytics_zoo_tpu_torch.observability import Tracer

    tracer = Tracer()
    with ModelRegistry(max_concurrency=2, tracer=tracer,
                       pager={"max_resident": 1}) as reg:
        _deploy_const(reg, "a", 1.0)
        _deploy_const(reg, "b", 2.0)
        reg.predict("b", X)  # a cold
        _, info = reg.predict_ex("a", X)  # the faulting request
        span = tracer.find(info["request_id"])
        phases = {p["name"] for p in span["phases"]}
        assert "weights_h2d" in phases and "exec_rehydrate" in phases


def test_undeploy_retires_series_and_spans():
    """The satellite pin: deploy -> traffic -> undeploy -> scrape has
    ZERO series for the model, and the tracer ring dropped its spans
    — a paged fleet cycling many models keeps a bounded scrape."""
    from analytics_zoo_tpu_torch.observability import MetricsRegistry, Tracer
    from analytics_zoo_tpu_torch.observability.metrics import \
        parse_prometheus_text
    from analytics_zoo_tpu_torch.serving import registry_collector

    tracer = Tracer()
    with ModelRegistry(max_concurrency=2, tracer=tracer,
                       pager={"max_resident": 2}) as reg:
        mreg = MetricsRegistry()
        mreg.register_collector(registry_collector(reg))
        _deploy_const(reg, "dead", 1.0)
        _deploy_const(reg, "live", 2.0)
        for _ in range(3):
            reg.predict("dead", X)
            reg.predict("live", X)
        parsed = parse_prometheus_text(mreg.render_prometheus())
        models = {dict(k[1]).get("model") for k in parsed["samples"]}
        assert "dead" in models
        assert any(s["labels"].get("model") == "dead"
                   for s in tracer.recent())
        reg.undeploy("dead")
        parsed = parse_prometheus_text(mreg.render_prometheus())
        models = {dict(k[1]).get("model") for k in parsed["samples"]}
        assert "dead" not in models and "live" in models
        assert not any(s["labels"].get("model") == "dead"
                       for s in tracer.recent())
        assert any(s["labels"].get("model") == "live"
                   for s in tracer.recent())


def test_page_out_returns_the_weights_tensors():
    """A cold model holds no tensor of its weights: the page-out of a
    net's handle drops the net (its graph's reference cycles included),
    and the page-out of a faulted-in handle drops the uploaded params."""
    import gc
    import weakref

    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    def net():
        m = Sequential(device="cpu")
        m.add(Dense(8, input_shape=(6,), activation="tanh"))
        m.add(Dense(4))
        return m

    x = np.ones((2, 6), np.float32)
    was_enabled = gc.isenabled()
    gc.disable()  # only the pager may collect here
    try:
        with _paged_registry(budget=1) as reg:
            m = net()
            original = weakref.ref(next(m.parameters()))
            reg.deploy("k", m, warmup_shapes=(6,))
            want = np.asarray(reg.predict("k", x))
            del m
            _deploy_const(reg, "other", 1.0)  # pressure-evicts k
            assert reg.metrics("k")["k"]["pager"]["state"] == "cold"
            assert original() is None
            np.testing.assert_array_equal(reg.predict("k", x), want)
            entry = reg._entry("k")
            uploaded = weakref.ref(
                next(iter(entry.active.model._params.values())))
            reg.predict("other", X)  # pressure-evicts the faulted k
            assert reg.metrics("k")["k"]["pager"]["state"] == "cold"
            assert uploaded() is None
            host = entry.pager_recipe.host_bytes
            assert host == sum(4 * n for n in (6 * 8, 8, 8 * 4, 4))
    finally:
        if was_enabled:
            gc.enable()
