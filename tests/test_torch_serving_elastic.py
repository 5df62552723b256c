"""Port counterpart of ``tests/test_serving_elastic.py``: priority
classes and fair share, the autoscaler, the elastic replica set and
hedged dispatch, on ``analytics_zoo_tpu_torch`` on the CPU (replicas are
copies on the CPU; a build is a signature's first run on replica 0,
counted through ``observability.profile.note_compile``).
"""


import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as _IM
from analytics_zoo_tpu_torch.pipeline.inference import ReplicaSet
from analytics_zoo_tpu_torch.serving import (AdmissionController, Autoscaler,
                                             Overloaded, autoscaler_for)
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


def _wait_until(pred, timeout=5.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return False


class _Gate:
    def __init__(self):
        self.release = threading.Event()

    def __call__(self):
        self.release.wait(timeout=30)


def _spawn(ac, gate, n, cls=None):
    """n threads that admit under ``cls`` and block in the service
    body; returns (threads, errors-list)."""
    errs = []

    def one():
        try:
            with ac.admit(priority_class=cls):
                gate()
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=one) for _ in range(n)]
    [t.start() for t in ts]
    return ts, errs


# ---------------------------------------- priority shedding / eviction
def test_priority_eviction_sheds_lowest_class_first():
    """Queue full of bronze + a gold arrival: the NEWEST bronze waiter
    is evicted (Overloaded, evicted=True), gold is admitted, and the
    per-class shed counters attribute the shed to bronze alone."""
    ac = AdmissionController(max_queue=3, max_concurrency=1,
                             classes={"gold": (10, 1.0),
                                      "bronze": (0, 1.0)})
    gate = _Gate()
    holder, herr = _spawn(ac, gate, 1, cls="gold")
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    bronzes, berr = _spawn(ac, gate, 3, cls="bronze")
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 3)

    golds, gerr = _spawn(ac, gate, 1, cls="gold")
    # the gold arrival displaced a bronze instead of being rejected
    assert _wait_until(lambda: len(berr) == 1)
    assert isinstance(berr[0], Overloaded)
    assert berr[0].details["evicted"] is True
    assert berr[0].details["priority_class"] == "bronze"
    snap = ac.snapshot()
    assert snap["queue_depth"] == 3  # gold took the freed seat
    assert snap["shed_evicted"] == 1
    assert snap["classes"]["bronze"]["shed"] == 1
    assert snap["classes"]["gold"]["shed"] == 0

    gate.release.set()
    [t.join(timeout=60) for t in holder + bronzes + golds]
    assert not herr and not gerr
    snap = ac.snapshot()
    assert snap["completed"] == 4  # 1 holder + 2 bronze + 1 gold
    assert snap["admitted"] == snap["completed"]


def test_equal_priority_never_evicts():
    """A full queue of peers rejects the newcomer — same class (or any
    equal priority) must not cannibalize itself."""
    ac = AdmissionController(max_queue=2, max_concurrency=1)
    gate = _Gate()
    ts, errs = _spawn(ac, gate, 3)
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 2)
    with pytest.raises(Overloaded) as ei:
        with ac.admit():
            pass
    assert "evicted" not in ei.value.details
    assert ac.snapshot()["shed_evicted"] == 0
    gate.release.set()
    [t.join(timeout=60) for t in ts]
    assert not errs  # nobody already queued was disturbed


def test_weighted_fair_share_three_to_one():
    """With weights 3:1 and both classes saturated, 8 grants split 6:2
    — arrival order does not matter, virtual time does."""
    ac = AdmissionController(max_queue=32, max_concurrency=1,
                             classes={"a": (0, 3.0), "b": (0, 1.0)})
    gate = _Gate()
    holder, _ = _spawn(ac, gate, 1, cls="a")
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    order = []
    lock = threading.Lock()

    def worker(cls):
        with ac.admit(priority_class=cls):
            with lock:
                order.append(cls)

    ts = [threading.Thread(target=worker, args=(c,))
          for c in ["a"] * 8 + ["b"] * 8]
    [t.start() for t in ts]
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 16)
    gate.release.set()
    [t.join(timeout=60) for t in ts]
    first8 = order[:8]
    assert first8.count("a") == 6 and first8.count("b") == 2, order
    snap = ac.snapshot()
    assert snap["classes"]["a"]["admitted"] == 9  # holder included
    assert snap["classes"]["b"]["admitted"] == 8


def test_weight_zero_is_best_effort_and_full_weight_starves_it():
    """weight=0 ⇒ granted only when no weighted class waits: queued
    best-effort work is bypassed by later weighted arrivals."""
    ac = AdmissionController(max_queue=32, max_concurrency=1,
                             classes={"gold": (10, 1.0),
                                      "be": (0, 0.0)})
    gate = _Gate()
    holder, _ = _spawn(ac, gate, 1, cls="gold")
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    order = []
    lock = threading.Lock()

    def worker(cls):
        with ac.admit(priority_class=cls):
            with lock:
                order.append(cls)

    # best-effort enqueues FIRST; gold arrives later and still wins
    be = [threading.Thread(target=worker, args=("be",))
          for _ in range(3)]
    [t.start() for t in be]
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 3)
    golds = [threading.Thread(target=worker, args=("gold",))
             for _ in range(3)]
    [t.start() for t in golds]
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 6)
    gate.release.set()
    [t.join(timeout=60) for t in holder + be + golds]
    assert order[:3] == ["gold"] * 3, order
    assert order[3:] == ["be"] * 3, order


def test_no_priority_inversion_under_drain():
    """Drain closes admission for every class: a gold arrival is
    refused (shed_draining) and must NOT evict a queued bronze waiter
    the drain promised to finish."""
    ac = AdmissionController(max_queue=4, max_concurrency=1,
                             classes={"gold": (10, 1.0),
                                      "bronze": (0, 1.0)})
    gate = _Gate()
    holder, _ = _spawn(ac, gate, 1, cls="bronze")
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    queued, qerr = _spawn(ac, gate, 1, cls="bronze")
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 1)
    drained = []
    dt = threading.Thread(target=lambda: drained.append(ac.drain(10.0)))
    dt.start()
    assert _wait_until(lambda: ac.draining)
    with pytest.raises(Overloaded) as ei:
        with ac.admit(priority_class="gold"):
            pass
    assert ei.value.details.get("draining") is True
    snap = ac.snapshot()
    assert snap["classes"]["gold"]["shed"] == 1
    assert snap["classes"]["bronze"]["shed"] == 0  # nobody evicted
    gate.release.set()
    [t.join(timeout=60) for t in holder + queued]
    dt.join(timeout=60)
    assert drained == [True] and not qerr
    assert ac.snapshot()["completed"] == 2


def test_predictive_deadline_shed_is_class_aware():
    """A high-weight request behind a large LOW-weight backlog must
    not be predictively shed on a whole-queue FIFO estimate — WFQ will
    grant it a slot long before the backlog drains (and a doomed
    arrival must also never evict a victim before shedding itself)."""
    ac = AdmissionController(max_queue=16, max_concurrency=1,
                             classes={"hi": (10, 9.0),
                                      "lo": (0, 1.0)})
    with ac._cond:
        ac._service_ewma_s = 0.01  # 10 ms observed service time
    gate = _Gate()
    holder, _ = _spawn(ac, gate, 1, cls="lo")
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    los, _ = _spawn(ac, gate, 10, cls="lo")
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 10)
    # whole-queue estimate: 10ms * 11 = 110ms >> 60ms deadline — the
    # FIFO formula would shed; the hi class's own queue is empty and
    # its share is 0.9, so the class-aware estimate is ~11ms
    done = []

    def hi_request():
        with ac.admit(deadline_ms=500, priority_class="hi"):
            done.append(True)

    t = threading.Thread(target=hi_request)
    t.start()
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 11)
    assert ac.snapshot()["classes"]["hi"]["shed"] == 0
    gate.release.set()
    t.join(timeout=60)
    [x.join(timeout=60) for x in holder + los]
    snap = ac.snapshot()
    assert done == [True]
    assert snap["shed_deadline"] == 0 and snap["deadline_lapsed"] == 0
    # weight-0 really does wait behind everyone: the whole-queue
    # estimate applies and a hopeless best-effort deadline sheds
    with ac._cond:
        ac._service_ewma_s = 0.05
    gate2 = _Gate()
    h2, _ = _spawn(ac, gate2, 1, cls="lo")
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    q2, _ = _spawn(ac, gate2, 4, cls="lo")
    assert _wait_until(lambda: ac.snapshot()["queue_depth"] == 4)
    from analytics_zoo_tpu_torch.serving import DeadlineExceeded
    be = ac._class_for("be0")
    be.weight = 0.0
    with pytest.raises(DeadlineExceeded):
        with ac.admit(deadline_ms=20, priority_class="be0"):
            pass
    gate2.release.set()
    [x.join(timeout=60) for x in h2 + q2]


def test_wait_exception_does_not_leak_queue_seat():
    """An exception delivered INSIDE Condition.wait (KeyboardInterrupt
    in real life) must unwind the ticket: the queue seat comes back,
    no concurrency slot is burned, and drain still completes."""
    ac = AdmissionController(max_queue=2, max_concurrency=1)
    gate = _Gate()
    holder, _ = _spawn(ac, gate, 1)
    assert _wait_until(lambda: ac.snapshot()["running"] == 1)
    orig_wait = ac._cond.wait
    fired = threading.Event()

    def exploding_wait(timeout=None):
        if not fired.is_set():
            fired.set()
            raise RuntimeError("injected into Condition.wait")
        return orig_wait(timeout)

    ac._cond.wait = exploding_wait
    errs = []

    def victim():
        try:
            with ac.admit():
                pass
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    t = threading.Thread(target=victim)
    t.start()
    t.join(timeout=60)
    ac._cond.wait = orig_wait
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError)
    assert ac.snapshot()["queue_depth"] == 0  # the seat came back
    gate.release.set()
    [x.join(timeout=60) for x in holder]
    with ac.admit():  # the controller still serves
        pass
    assert ac.drain(5.0) is True  # and nothing phantom blocks drain


def test_autoscaler_signals_survive_undeploy():
    """get_signals reads entry.active once: a concurrent undeploy
    nulling it yields active=None, not an AttributeError every tick."""
    with ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                       max_batch_size=4, coalescing=True,
                       replicas=2) as reg:
        reg.deploy("m", fn=lambda p, x: torch.tanh(x @ p["w"]),
                   params={"w": np.eye(4, dtype=np.float32)},
                   warmup_shapes=(4,))
        sc = autoscaler_for(reg, "m", min_replicas=1)
        reg.undeploy("m")
        sig = sc.get_signals()
        assert sig["active"] is None
        assert sc.tick() is None  # the control loop keeps running


def test_class_families_exported():
    """zoo_shed_total{class}/zoo_class_admitted_total ride the registry
    bridge (classes export at zero, so alerts pre-wire on deploy)."""
    ac = AdmissionController(classes={"gold": (10, 0.9),
                                      "batch": (0, 0.1)})
    with ac.admit(priority_class="batch"):
        pass
    snapshot = {"m": {"active_version": 1, "swap_count": 0,
                      "admission": ac.snapshot(), "versions": {},
                      "serving": {}}}
    fams = {f.name: f for f in registry_families(snapshot)}
    shed = {dict(lbl)["class"]: v
            for lbl, v in fams["zoo_shed_total"].samples}
    admitted = {dict(lbl)["class"]: v
                for lbl, v in fams["zoo_class_admitted_total"].samples}
    # __overflow__ is the always-registered past-cap sink: exporting
    # it at zero pre-wires shed-abuse alerts like any other class
    assert shed == {"default": 0, "__overflow__": 0, "gold": 0,
                    "batch": 0}
    assert admitted["batch"] == 1 and admitted["gold"] == 0
    weights = {dict(lbl)["class"]: v
               for lbl, v in fams["zoo_class_weight"].samples}
    assert weights["gold"] == 0.9


# ----------------------------------------------------------- autoscaler
def _fake_scaler(**kw):
    """An Autoscaler over synthetic signals and a fake clock."""
    state = {"depth": 0.0, "clock": 0.0, "applied": []}

    def get_signals():
        return {"queue_depth": state["depth"], "ewma_ms": 1.0,
                "active": None}

    def apply_scale(n):
        state["applied"].append(n)

    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("initial_replicas", 1)
    kw.setdefault("up_queue_depth", 8)
    kw.setdefault("down_queue_depth", 1)
    kw.setdefault("hold_ticks", 2)
    kw.setdefault("cooldown_s", 10.0)
    sc = Autoscaler(get_signals, apply_scale,
                    clock=lambda: state["clock"], **kw)
    return sc, state


def test_autoscaler_hysteresis_cooldown_and_steps():
    sc, st = _fake_scaler()
    st["depth"] = 20
    assert sc.tick() is None          # held for 1 tick only
    ev = sc.tick()                    # hysteresis satisfied
    assert ev and ev["direction"] == "up" and ev["to_replicas"] == 2
    assert st["applied"] == [2]
    # still overloaded, but inside the cooldown window: nothing moves
    for _ in range(5):
        assert sc.tick() is None
    st["clock"] += 11.0               # cooldown lapses; the signal
    ev = sc.tick()                    # held throughout → fires now
    assert ev and ev["to_replicas"] == 3  # one step at a time
    # quiet load scales back down, same discipline
    st["depth"] = 0
    st["clock"] += 11.0
    sc.tick()
    ev = sc.tick()
    assert ev and ev["direction"] == "down" and ev["to_replicas"] == 2
    assert st["applied"] == [2, 3, 2]


def test_autoscaler_flapping_guard_under_oscillating_load():
    """Oscillating load (alternating over/under threshold) never
    builds a streak → zero transitions; and with hold_ticks=1 the
    cooldown still bounds it to ≤1 transition per window."""
    sc, st = _fake_scaler()
    for i in range(20):
        st["depth"] = 20 if i % 2 else 0
        assert sc.tick() is None      # hysteresis holds
    assert sc.events() == []

    sc2, st2 = _fake_scaler(hold_ticks=1, cooldown_s=10.0)
    events = 0
    for i in range(40):
        st2["depth"] = 20 if i % 2 else 0
        st2["clock"] += 0.1           # 40 ticks over 4s: < 1 cooldown
        if sc2.tick():
            events += 1
    assert events <= 1, events        # ≤1 transition per cooldown


def test_autoscaler_apply_failure_survives_and_backs_off():
    sc, st = _fake_scaler(hold_ticks=1)
    calls = []

    def bad_apply(n):
        calls.append(n)
        raise RuntimeError("injected scale failure")

    sc.apply_scale = bad_apply
    st["depth"] = 20
    assert sc.tick() is None          # failed transition, no event
    assert calls == [2]
    assert sc.counters.get("apply_errors") == 1
    assert sc.n_active == 1           # state not advanced
    assert sc.tick() is None          # inside the failure backoff
    st["clock"] += 11.0
    sc.tick()                         # retried after the cooldown
    assert calls == [2, 2]


def test_autoscaler_validates_bounds():
    with pytest.raises(ValueError):
        _fake_scaler(min_replicas=0)
    with pytest.raises(ValueError):
        _fake_scaler(min_replicas=3, max_replicas=2)


@pytest.fixture
def compile_counter(monkeypatch):
    """Every build the serving path reports (``profile.note_compile``)."""
    from analytics_zoo_tpu_torch.observability import profile

    events = []
    real = profile.note_compile

    def note(seconds, key, **kw):
        events.append(key)
        real(seconds, key, **kw)

    monkeypatch.setattr(profile, "note_compile", note)
    return events


def test_scale_events_warm_prime_and_zero_compiles(compile_counter):
    """The warm-before-activate discipline at runtime: scale-down then
    scale-up never compiles (placement covered the inactive replica),
    the joining replica is primed before taking traffic, and the
    admission bound follows the active count."""
    reg = ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                        max_batch_size=4, coalescing=True, replicas=3)
    reg.deploy("m", fn=lambda p, x: torch.tanh(x @ p["w"]),
               params={"w": np.eye(4, dtype=np.float32)},
               warmup_shapes=(4,))
    entry = reg._entry("m")
    model = entry.active.model
    assert model.n_replicas == 3 and model.active_replicas == 3
    assert entry.admission.max_concurrency == 6
    sc = autoscaler_for(reg, "m", min_replicas=1)
    assert sc.max_replicas == 3 and sc.n_active == 3

    x = np.ones((2, 4), np.float32)
    ref = model.predict(x).copy()
    n0 = len(compile_counter)
    sc.apply_scale(1)
    assert model.active_replicas == 1
    assert entry.admission.max_concurrency == 2
    rs = model._cache.replica_set
    assert rs.healthy_indices() == [0]
    for _ in range(6):
        np.testing.assert_array_equal(model.predict(x), ref)
    # a NEW signature arriving while scaled down still places on the
    # inactive replicas (that is what keeps scale-up compile-free)
    model.predict(np.ones((2, 4), np.float32))

    before = {r.index: r.dispatches for r in rs.replicas}
    sc.apply_scale(3)
    assert model.active_replicas == 3
    assert entry.admission.max_concurrency == 6
    for _ in range(12):
        np.testing.assert_array_equal(model.predict(x), ref)
    assert len(compile_counter) == n0, "a scale event paid a compile"
    stats = model.serving_stats()
    assert all(v == 1 for v in stats["misses"].values()), stats["misses"]
    # the rejoined replicas actually serve again
    assert any(rs.replicas[i].dispatches > before[i] for i in (1, 2))
    reg.shutdown()


def test_registry_exports_active_replica_gauge():
    with ModelRegistry(max_concurrency=2, supported_concurrent_num=2,
                       max_batch_size=4, coalescing=True,
                       replicas=2) as reg:
        reg.deploy("m", fn=lambda p, x: torch.tanh(x @ p["w"]),
                   params={"w": np.eye(4, dtype=np.float32)},
                   warmup_shapes=(4,))
        reg._entry("m").active.model.set_active_replicas(1)
        fams = {f.name: f for f in registry_families(reg.metrics())}
        total = dict(fams["zoo_model_replicas"].samples[0][0]), \
            fams["zoo_model_replicas"].samples[0][1]
        active = fams["zoo_model_replicas_active"].samples[0][1]
        assert total[1] == 2 and active == 1


def test_set_active_clamps():
    rs = ReplicaSet(lambda p, x: x * p["s"], {"s": np.float32(1.0)},
                    devices=["cpu"] * 4)
    rs.ensure_compiled(np.ones((2, 4), np.float32))
    assert rs.set_active(2) == 2
    assert rs.n_active == 2 and rs.healthy_indices() == [0, 1]
    assert rs.set_active(99) == 4
    assert rs.set_active(0) == 1  # floor: never zero active


def test_set_active_skips_unhealthy_replicas():
    """Health-aware elastic selection: a dead replica must not hold an
    active seat (or fail the whole resize from inside its prime) while
    a healthy spare sits deactivated — one red device must never wedge
    the autoscaler's scale-up forever."""
    rs = ReplicaSet(lambda p, x: x * p["s"], {"s": np.float32(1.0)},
                    devices=["cpu"] * 4)
    rs.ensure_compiled(np.ones((2, 4), np.float32))
    rs.probe_backoff_s = 3600.0  # freeze recovery for the test
    rs.set_active(1)
    rs.mark_unhealthy(rs.replicas[1], RuntimeError("injected"))
    assert rs.set_active(2) == 2
    # replica 1 is red: its seat goes to the next healthy index
    assert [r.index for r in rs.replicas if r.active] == [0, 2]
    assert rs.healthy_indices() == [0, 2]
    # more seats than healthy replicas: the remainder fills with the
    # red replica (unprimed) and the resize still succeeds
    assert rs.set_active(4) == 4
    assert [r.index for r in rs.replicas if r.active] == [0, 1, 2, 3]
    assert rs.healthy_indices() == [0, 2, 3]


def test_set_active_survives_prime_crash():
    """A joining replica whose prime raises goes red and the resize
    carries on with the rest — never propagating out of set_active
    (which would leave the autoscaler raising on every retry)."""
    rs = ReplicaSet(lambda p, x: x * p["s"], {"s": np.float32(1.0)},
                    devices=["cpu"] * 4)
    rs.ensure_compiled(np.ones((2, 4), np.float32))
    rs.probe_backoff_s = 3600.0
    rs.set_active(1)
    orig = rs._prime

    def crashing_prime(replica, _orig=orig):
        if replica.index == 1:
            raise RuntimeError("injected prime crash")
        return _orig(replica)

    rs._prime = crashing_prime
    assert rs.set_active(3) == 3
    assert not rs.replicas[1].healthy
    assert rs.healthy_indices() == [0, 2]


# -------------------------------------------------------------- hedging
def _hedged_model(**kw):
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        coalescing=True, replicas=2, hedging=True,
                        hedge_quantile=0.5, hedge_min_ms=0.5, **kw)
    im.load_fn(lambda p, x: torch.tanh(x @ p["w"]),
                {"w": np.eye(4, dtype=np.float32)})
    im.warmup((4,))
    return im


def _seed_window(im, x, n=30):
    for _ in range(n):
        im.predict(x)


def test_hedge_fires_and_hedge_wins_bit_exact():
    """A straggling primary slot → the hedge wins, first-wins results
    are bit-exact vs the unhedged reference, and the loser's slot
    ownership is eventually released (arena aliasing rule)."""
    im = _hedged_model()
    coal = im._coalescer
    x = np.ones((1, 4), np.float32)
    ref = im.predict(x).copy()
    _seed_window(im, x)
    orig = coal._fetch_slot

    def slow_primary(dev, n, slot, _orig=orig):
        time.sleep(0.03)
        return _orig(dev, n, slot)

    coal._fetch_slot = slow_primary
    for _ in range(12):
        np.testing.assert_array_equal(im.predict(x), ref)
    hedges = coal.hedge_stats()
    assert hedges["fired"] >= 1 and hedges["hedge_won"] >= 1, hedges
    # loser cleanup: once the straggling fetches return, every slot's
    # in-flight count is released (nothing leaks ownership)
    coal._fetch_slot = orig
    assert _wait_until(lambda: (im.predict(x) is not None
                                and not coal._pending_losers
                                and all(v == 0
                                        for v in coal._slot_inflight)))
    assert im.serving_stats()["hedges"]["fired"] >= 1
    im.close()


def test_hedge_fired_but_primary_wins():
    """A slow HEDGE fetch: the primary delivers first, the outcome
    counter says primary_won, and the result is still exact."""
    im = _hedged_model()
    coal = im._coalescer
    x = np.ones((1, 4), np.float32)
    ref = im.predict(x).copy()
    _seed_window(im, x)
    orig_p, orig_h = coal._fetch_slot, coal._fetch_hedge

    def slightly_slow_primary(dev, n, slot, _orig=orig_p):
        time.sleep(0.01)  # past the threshold → the hedge fires
        return _orig(dev, n, slot)

    def very_slow_hedge(dev, n, idx, _orig=orig_h):
        time.sleep(0.25)
        return _orig(dev, n, idx)

    coal._fetch_slot = slightly_slow_primary
    coal._fetch_hedge = very_slow_hedge
    for _ in range(8):
        np.testing.assert_array_equal(im.predict(x), ref)
    hedges = coal.hedge_stats()
    assert hedges["fired"] >= 1 and hedges["primary_won"] >= 1, hedges
    im.close()


def test_hedge_noop_with_fewer_than_two_healthy_replicas():
    """One healthy replica left: the threshold may lapse, but hedging
    must no-op (skipped_no_replica) — re-dispatching onto the same
    straggler or a red replica helps nobody."""
    im = _hedged_model()
    coal = im._coalescer
    rs = im._cache.replica_set
    x = np.ones((1, 4), np.float32)
    ref = im.predict(x).copy()
    _seed_window(im, x)
    rs.probe_backoff_s = 3600.0  # freeze recovery for the test
    rs.mark_unhealthy(rs.replicas[1], RuntimeError("injected"))
    fired_before = coal.hedge_stats()["fired"]  # seeding may have
    orig = coal._fetch_slot                     # hedged at p50

    def slow(dev, n, slot, _orig=orig):
        time.sleep(0.02)
        return _orig(dev, n, slot)

    coal._fetch_slot = slow
    for _ in range(6):
        np.testing.assert_array_equal(im.predict(x), ref)
    hedges = coal.hedge_stats()
    assert hedges["skipped_no_replica"] >= 1, hedges
    assert hedges["fired"] == fired_before, hedges  # no new hedges
    im.close()


def test_hedge_loser_keeps_slot_owned_until_fetch_returns():
    """THE aliasing pin: while the losing dispatch is still in flight,
    its slot's in-flight count stays held — so the staging arena can
    never hand that buffer to a new group and rewrite it under the
    loser's zero-copy device_put."""
    im = _hedged_model()
    coal = im._coalescer
    x = np.ones((1, 4), np.float32)
    _seed_window(im, x)
    release = threading.Event()
    observed = {}
    orig = coal._fetch_slot

    def blocking_primary(dev, n, slot, _orig=orig):
        release.wait(timeout=10)  # the loser, pinned in flight
        return _orig(dev, n, slot)

    coal._fetch_slot = blocking_primary
    out = im.predict(x)  # returns via the hedge win
    assert out is not None
    # the primary fetch is STILL blocked: its slot must read as owned
    observed["losers"] = len(coal._pending_losers)
    observed["held"] = sum(coal._slot_inflight)
    release.set()
    assert observed["losers"] == 1, observed
    assert observed["held"] >= 1, observed
    coal._fetch_slot = orig
    assert _wait_until(lambda: (im.predict(x) is not None
                                and not coal._pending_losers
                                and all(v == 0
                                        for v in coal._slot_inflight)))
    im.close()


def test_hedge_winner_crash_with_wedged_loser_does_not_hang():
    """Winner crashed, loser wedged: the fallback wait on the loser is
    bounded by the wedge budget — the dispatcher fails the group,
    keeps the wedged fetch as a pending loser (its slot and buffer
    stay owned), and marks its replica red, instead of blocking
    forever on .result()."""
    im = _hedged_model()
    coal = im._coalescer
    rs = im._cache.replica_set
    rs.probe_backoff_s = 3600.0  # a probe must not re-heal mid-test
    x = np.ones((1, 4), np.float32)
    _seed_window(im, x)
    coal._WEDGE_TIMEOUT_S = 0.2  # shrink the budget for the test
    release = threading.Event()
    orig_p = coal._fetch_slot

    def slow_then_crash(dev, n, slot):
        time.sleep(0.02)  # past the p50 threshold → the hedge fires
        raise RuntimeError("injected primary crash")

    def wedged_hedge(dev, n, idx):
        release.wait(timeout=10)
        raise RuntimeError("wedged hedge finally dies")

    coal._fetch_slot = slow_then_crash
    coal._fetch_hedge = wedged_hedge
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="injected primary crash"):
        im.predict(x)
    assert time.perf_counter() - t0 < 5.0  # bounded, not forever
    assert len(coal._pending_losers) == 1
    assert [r.index for r in rs.replicas if not r.healthy], \
        "the wedged hedge replica must go red"
    coal._fetch_slot = orig_p
    release.set()
    assert _wait_until(lambda: (im.predict(x) is not None
                                and not coal._pending_losers))
    im.close()


def test_hedged_resolve_records_primary_latency_not_first_wins():
    """The hedge-threshold window must learn the PRIMARY's latency
    even when the hedge wins — recording the group's first-wins
    latency feeds the threshold its own output: the quantile sinks
    toward the fast replica and a persistent straggler ends up hedged
    on nearly every dispatch instead of only at the tail."""
    im = _hedged_model()
    coal = im._coalescer
    x = np.ones((1, 4), np.float32)
    _seed_window(im, x)
    orig = coal._fetch_slot

    def slow_primary(dev, n, slot, _orig=orig):
        time.sleep(0.03)
        return _orig(dev, n, slot)

    coal._fetch_slot = slow_primary
    for _ in range(6):
        im.predict(x)
    # the slow PRIMARY latency must land in the window (p100 = window
    # max) even though hedges resolve the groups fast
    assert _wait_until(
        lambda: (coal._group_lat.percentile(100) or 0.0) >= 0.025)
    im.close()


def test_wedged_loser_drain_prefers_done_and_marks_wedged():
    """A forced loser drain retires whichever pending loser is already
    DONE — it must never block behind an older wedged fetch while a
    newer finished one could free a slot — and once the wedge budget
    lapses it marks the wedged fetch's replica unhealthy (once) instead
    of stalling the dispatcher forever.  The wedged slot's in-flight
    count is NEVER released early: the dispatch still aliases its
    staging buffer (arena-ownership rule)."""
    from concurrent.futures import Future

    from analytics_zoo_tpu_torch.pipeline.inference.serving import \
        RequestCoalescer

    coal = RequestCoalescer.__new__(RequestCoalescer)
    marked = []

    class _FakeRS:
        replicas = [object(), object()]

        def mark_unhealthy(self, replica, exc):
            marked.append(self.replicas.index(replica))

    coal._rs = _FakeRS()
    coal._slot_inflight = [1, 1]
    coal._wedged_reported = set()
    wedged, finished = Future(), Future()
    finished.set_result(None)
    coal._pending_losers = [(0, wedged, None), (1, finished, None)]

    t0 = time.perf_counter()
    assert coal._drain_losers(block=True) is True
    assert time.perf_counter() - t0 < 1.0  # no wait on the wedged one
    assert coal._slot_inflight == [1, 0]
    assert [f for _, f, _ in coal._pending_losers] == [wedged]
    assert not marked

    coal._WEDGE_TIMEOUT_S = 0.05  # shrink the budget for the test
    assert coal._drain_losers(block=True) is False
    assert marked == [0]
    assert coal._slot_inflight == [1, 0]  # ownership NOT released
    assert coal._drain_losers(block=True) is False
    assert marked == [0]  # marked once per loser, not per pass

    wedged.set_result(None)  # the fetch finally returns
    assert coal._drain_losers(block=True) is True
    assert coal._slot_inflight == [0, 0]
    assert not coal._pending_losers and not coal._wedged_reported


def test_unknown_class_auto_registration_is_bounded():
    """Class names arrive from untrusted request input: past the cap,
    fresh names fold into the best-effort overflow sink instead of
    growing per-name state and metric series without bound — and never
    into the default class, whose 1.0 WFQ weight would let an attacker
    cycling fresh names out-schedule a configured tenant."""
    from analytics_zoo_tpu_torch.serving.admission import (_MAX_CLASSES,
                                                     _OVERFLOW_CLASS)

    ac = AdmissionController(max_queue=4, max_concurrency=2)
    for i in range(_MAX_CLASSES + 20):
        with ac.admit(priority_class=f"attacker-{i}"):
            pass
    assert len(ac._classes) == _MAX_CLASSES
    # capped arrivals are accounted to the weight-0 sink, not dropped
    # and not the weight-1.0 default tenant
    snap = ac.snapshot()["classes"]
    assert snap[_OVERFLOW_CLASS]["admitted"] >= 20
    assert snap[_OVERFLOW_CLASS]["weight"] == 0.0
    assert snap["default"]["admitted"] == 0
    # explicit configuration is never capped
    ac.set_class("configured-vip", priority=10, weight=2.0)
    assert "configured-vip" in ac._classes


def test_hedge_crash_first_is_not_a_win():
    """A hedge that completes FIRST by crashing must not count (or
    trace) as hedge_won — the primary actually serves the group."""
    im = _hedged_model()
    coal = im._coalescer
    x = np.ones((1, 4), np.float32)
    ref = im.predict(x).copy()
    _seed_window(im, x)
    orig_p = coal._fetch_slot

    def slow_primary(dev, n, slot, _orig=orig_p):
        time.sleep(0.02)  # past the p50 threshold → the hedge fires
        return _orig(dev, n, slot)

    def crashing_hedge(dev, n, idx):
        raise RuntimeError("injected hedge-side crash")

    coal._fetch_slot = slow_primary
    coal._fetch_hedge = crashing_hedge
    won_before = coal.hedge_stats()["hedge_won"]
    for _ in range(8):
        np.testing.assert_array_equal(im.predict(x), ref)
    hedges = coal.hedge_stats()
    assert hedges["fired"] >= 1, hedges
    assert hedges["hedge_won"] == won_before, hedges
    assert hedges["primary_won"] >= 1, hedges
    im.close()


def test_unseeded_hedge_window_skips_the_pool():
    """Until hedge_min_samples groups have resolved a hedge cannot
    fire, so the resolve path must stay inline — the hedge executor is
    only materialized once the threshold window is seeded."""
    im = _hedged_model()
    coal = im._coalescer
    x = np.ones((1, 4), np.float32)
    for _ in range(coal.hedge_min_samples // 2):
        im.predict(x)
    assert coal._hedge_pool is None  # inline path, no pool yet
    _seed_window(im, x)
    im.predict(x)
    assert coal._hedge_pool is not None  # seeded → hedged resolves
    im.close()


def test_hedging_off_keeps_plain_resolve_path():
    """hedging=False (the default) must not route through the hedge
    executor at all — the pool is never created."""
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        coalescing=True, replicas=2)
    im.load_fn(lambda p, x: torch.tanh(x @ p["w"]),
                {"w": np.eye(4, dtype=np.float32)})
    im.warmup((4,))
    for _ in range(6):
        im.predict(np.ones((1, 4), np.float32))
    assert im._coalescer._hedge_pool is None
    assert im._coalescer.hedging is False
    assert "hedges" not in im.serving_stats()
    im.close()
