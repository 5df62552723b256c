"""Replica autoscaling: the control loop from serving signals to
serving capacity.

Counterpart of ``analytics_zoo_tpu/serving/autoscale.py``, the same
pure-Python module.  The replica set is the data plane and admission
(queue depth, EWMA service time) gives the signals; without this loop
every capacity knob is frozen at deploy time.  The
:class:`Autoscaler` closes the loop: a small periodic controller reads
the admission signals and resizes the live ``ReplicaSet``'s ACTIVE set
— reusing the registry's warm-before-activate discipline at runtime
(``ReplicaSet.set_active`` primes every placed executable on a joining
replica before it takes traffic), so a scale-up never serves a cold
replica and never builds — and re-bounds the model's
``AdmissionController`` to ``base_concurrency * active_replicas`` on
every transition.

Stability over reactivity, by construction:

* **hysteresis** — a scale signal must hold for ``hold_ticks``
  consecutive control intervals before it acts; a single queue blip
  scales nothing;
* **cooldown** — after any transition, no further transition for
  ``cooldown_s`` (the "≤ 1 transition per cooldown window" flapping
  bound the loadtest gate checks);
* **one step at a time** — transitions move the active count by ±1, so
  an overshooting spike cannot slam capacity to max and back.

The decision core is deliberately side-effect free apart from the two
injected callables (``get_signals`` / ``apply_scale``), so tests drive
``tick()`` directly with synthetic signals and a fake clock — no
threads, no sleeping.  ``autoscaler_for(registry, name)`` wires the
real thing: signals from the model's admission snapshot, scaling onto
the active deployment (re-resolved every call, so a hot-swap mid-flight
lands on the NEW model's replica set).

Usage::

    scaler = autoscaler_for(registry, "default", min_replicas=1,
                            up_queue_depth=8, cooldown_s=5.0)
    scaler.start()           # daemon control thread
    ...
    scaler.stop()
    scaler.events()          # the scale-event timeline
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..observability.log import get_logger as _get_logger
from ..observability.metrics import Family
from .metrics import Counters

_slog = _get_logger("zoo.autoscale")


class Autoscaler:
    """Queue-depth / EWMA-latency driven replica controller (module
    docstring).

    ``get_signals()`` returns ``{"queue_depth": int, "ewma_ms":
    float|None, "active": int|None}`` plus optional ``running`` /
    ``max_concurrency`` (scale-down additionally requires a free
    concurrency slot when both are present — an empty queue under
    full-slot saturation is load, not idleness).  ``active`` (when
    present) re-syncs the controller's view of the live replica
    count, so an external change (hot-swap deploying a fresh
    all-active set) is observed rather than fought.  ``apply_scale(n)`` makes ``n``
    replicas live; it must be synchronous (the warm-prime happens
    inside it) and may raise — a failed transition is logged, counted,
    and retried after the cooldown.
    """

    def __init__(self, get_signals: Callable[[], Dict[str, Any]],
                 apply_scale: Callable[[int], Any], *,
                 min_replicas: int = 1, max_replicas: int,
                 initial_replicas: Optional[int] = None,
                 up_queue_depth: float = 8.0,
                 down_queue_depth: float = 1.0,
                 up_latency_ms: Optional[float] = None,
                 down_latency_ms: Optional[float] = None,
                 hold_ticks: int = 2, cooldown_s: float = 5.0,
                 interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "model"):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        self.get_signals = get_signals
        self.apply_scale = apply_scale
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_queue_depth = float(up_queue_depth)
        self.down_queue_depth = float(down_queue_depth)
        self.up_latency_ms = up_latency_ms
        self.down_latency_ms = down_latency_ms
        self.hold_ticks = max(1, int(hold_ticks))
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.name = name
        self._clock = clock
        self.n_active = int(initial_replicas
                            if initial_replicas is not None
                            else max_replicas)
        self._up_streak = 0
        self._down_streak = 0
        # cooldown starts satisfied: the first held signal may act
        self._last_transition = clock() - self.cooldown_s
        # bounded timeline: a standing server transitioning once per
        # cooldown forever must not grow memory (totals live in the
        # counters; the ring keeps the recent history scrapes read)
        self._events: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=512)
        self.counters = Counters("ticks", "scale_up", "scale_down",
                                 "apply_errors")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- the control step ----
    def tick(self) -> Optional[Dict[str, Any]]:
        """One control interval: read signals, update streaks, maybe
        transition.  Returns the scale event dict when one happened,
        else None.  Deterministic given signals + clock — the tests'
        entry point, and the only place state changes."""
        self.counters.inc("ticks")
        sig = self.get_signals()
        if sig.get("active"):
            # observed truth wins over our bookkeeping (a hot-swap just
            # deployed a fresh, fully-active replica set)
            self.n_active = int(sig["active"])
        depth = float(sig.get("queue_depth") or 0)
        ewma = sig.get("ewma_ms")
        running = sig.get("running")
        cap = sig.get("max_concurrency")
        # an empty queue is NOT idleness when every concurrency slot
        # is busy: a closed-loop saturator keeps depth at 0 while the
        # model runs flat out, and scaling down under 100% utilization
        # just starts a perpetual down/up oscillation (signals without
        # the keys — synthetic tests — place no constraint)
        has_free_slots = (running is None or cap is None
                          or running < cap)
        want_up = depth >= self.up_queue_depth or (
            self.up_latency_ms is not None and ewma is not None
            and ewma >= self.up_latency_ms)
        want_down = depth <= self.down_queue_depth \
            and has_free_slots and (
                self.down_latency_ms is None or ewma is None
                or ewma <= self.down_latency_ms)
        self._up_streak = self._up_streak + 1 if want_up else 0
        self._down_streak = self._down_streak + 1 if want_down else 0
        now = self._clock()
        if now - self._last_transition < self.cooldown_s:
            return None  # ≤1 transition per cooldown window, by law
        target = self.n_active
        direction = None
        if self._up_streak >= self.hold_ticks \
                and self.n_active < self.max_replicas:
            target, direction = self.n_active + 1, "up"
        elif self._down_streak >= self.hold_ticks \
                and self.n_active > self.min_replicas:
            target, direction = self.n_active - 1, "down"
        if direction is None:
            return None
        try:
            self.apply_scale(target)
        except Exception as e:  # noqa: BLE001 — the loop must survive
            self.counters.inc("apply_errors")
            _slog.error("autoscale_apply_failed", model=self.name,
                        target=target,
                        error=f"{type(e).__name__}: {e}")
            # back off a full cooldown before retrying the transition
            self._last_transition = now
            return None
        event = {"t": now, "direction": direction,
                 "from_replicas": self.n_active,
                 "to_replicas": target,
                 "queue_depth": depth, "ewma_ms": ewma}
        self.n_active = target
        self._last_transition = now
        self._up_streak = self._down_streak = 0
        self.counters.inc(f"scale_{direction}")
        self._events.append(event)
        _slog.info("autoscale", model=self.name, **{
            k: v for k, v in event.items() if k != "t"})
        return event

    # ---- background loop ----
    def start(self):
        """Run ``tick()`` every ``interval_s`` on a daemon thread
        (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="zoo-autoscale", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — keep controlling
                _slog.error("autoscale_tick_failed", model=self.name,
                            error=f"{type(e).__name__}: {e}")
            self._stop.wait(self.interval_s)

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ---- read side ----
    def events(self) -> List[Dict[str, Any]]:
        """The scale-event timeline so far (oldest first)."""
        return list(self._events)

    def snapshot(self) -> Dict[str, Any]:
        return {"active_replicas": self.n_active,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "events": self.events(),
                **self.counters.snapshot()}

    def families(self) -> List[Family]:
        """Prometheus collector (plug into a MetricsRegistry):
        ``zoo_autoscale_events_total{model,direction}`` plus the
        active/min/max replica gauges."""
        c = self.counters.snapshot()
        ml = {"model": self.name}
        return [
            Family("counter", "zoo_autoscale_events_total",
                   "replica scale transitions",
                   [({**ml, "direction": "up"}, c["scale_up"]),
                    ({**ml, "direction": "down"}, c["scale_down"])]),
            Family("gauge", "zoo_autoscale_active_replicas",
                   "replicas currently in the scheduled set",
                   [(ml, self.n_active)]),
            Family("gauge", "zoo_autoscale_max_replicas",
                   "autoscaler replica ceiling",
                   [(ml, self.max_replicas)]),
        ]


def autoscaler_for(registry, name: str, **kwargs: Any) -> Autoscaler:
    """An :class:`Autoscaler` wired to one registry model: signals from
    its admission snapshot (+ the live active-replica count, so a
    hot-swap re-syncs the controller), scaling onto the ACTIVE
    deployment's replica set, and the admission concurrency re-bounded
    to ``base * n`` on every transition — the runtime generalization of
    the deploy-time rescale.  ``max_replicas`` defaults to the active
    model's total replica count."""
    entry = registry._entry(name)
    base = registry._max_concurrency

    def _model():
        dep = entry.active
        if dep is None:
            raise RuntimeError(
                f"model {name!r} has no active version to scale")
        return dep.model

    def get_signals() -> Dict[str, Any]:
        snap = entry.admission.snapshot()
        # single read: a concurrent undeploy nulls entry.active, and a
        # check-then-dereference would crash every tick thereafter
        dep = entry.active
        m = dep.model if dep is not None else None
        return {"queue_depth": snap["queue_depth"],
                "ewma_ms": snap["service_ewma_ms"],
                "running": snap["running"],
                "max_concurrency": snap["max_concurrency"],
                "active": (getattr(m, "active_replicas", None)
                           if m is not None else None)}

    def apply_scale(n: int):
        got = _model().set_active_replicas(n)
        entry.admission.set_max_concurrency(base * max(1, got))

    model = _model()
    total = getattr(model, "n_replicas", 1) or 1
    kwargs.setdefault("max_replicas", total)
    kwargs.setdefault("initial_replicas",
                      getattr(model, "active_replicas", total))
    return Autoscaler(get_signals, apply_scale, name=name, **kwargs)
