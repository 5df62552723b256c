"""Admission control: bounded queueing, concurrency limiting,
priority-aware load shedding, and weighted fair-share scheduling for
one served model.

Counterpart of ``analytics_zoo_tpu/serving/admission.py``, the same
pure-Python module.

The naive failure mode this prevents (a bare data plane has it):
under overload the coalescer queue grows without bound, every request
"succeeds" seconds too late, and by the time the client times out the
server has still done the work.  An ``AdmissionController`` makes
overload EXPLICIT and IMMEDIATE instead:

* the wait queue is bounded (``max_queue``) — request #Q+1 is rejected
  with a structured :class:`~.errors.Overloaded` in microseconds, not
  parked;
* at most ``max_concurrency`` requests occupy the data plane at once
  (the coalescer still packs them into shared dispatches underneath);
* a request with a deadline is SHED AT ADMISSION when the predicted
  queue wait + service time (an EWMA of observed service times) already
  overruns it — :class:`~.errors.DeadlineExceeded` with ``shed=True``,
  before it consumes any capacity.  A request whose deadline lapses
  while waiting for a slot is also failed immediately at lapse time;
* ``drain()`` is the graceful-shutdown half: stop admitting, let
  everything already admitted (queued or running) finish.

Mixed tenants add two orthogonal knobs, both per *priority class*
(``set_class(name, priority=, weight=)``, requests tag themselves via
``admit(priority_class=)``):

* **priority** governs SHEDDING: when the queue is full, an arriving
  request EVICTS the newest waiting request of the lowest class whose
  priority is strictly below its own (the evicted caller gets
  ``Overloaded`` with ``evicted=True``), so under sustained overload
  shed requests drain exclusively from the lowest class until it is
  exhausted — only then does shedding climb the ladder.  Equal
  priorities never evict each other (the classic bounded-queue reject
  applies), and per-class shed counts are exported
  (``zoo_shed_total{class=...}``).
* **weight** governs SCHEDULING: freed slots are granted by weighted
  fair queueing over the classes with waiters (per-class virtual time
  advancing by ``1/weight`` per grant), so a 0.9/0.1 split holds
  regardless of arrival ratios.  ``weight=0`` marks a best-effort
  class: it is granted slots only when no weighted class has waiters.
  Within a class, grants are FIFO.

Usage::

    ac = AdmissionController(max_queue=64, max_concurrency=4,
                             classes={"gold": (10, 0.9),
                                      "batch": (0, 0.1)})
    with ac.admit(deadline_ms=50, priority_class="gold"):
        out = model.predict(x)
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Optional

from .errors import DeadlineExceeded, Overloaded
from .metrics import Counters

DEFAULT_CLASS = "default"

# auto-registration bound for UNKNOWN class names (request input is
# untrusted); configured classes via set_class() are never capped
_MAX_CLASSES = 64

# the sink class unknown names fold into PAST the cap: best-effort
# (priority 0, weight 0), never the default class — the default is a
# real tenant with a full 1.0 WFQ share, and an attacker cycling fresh
# names must not ride it
_OVERFLOW_CLASS = "__overflow__"

# ticket states (single transition each, under the controller's lock)
_WAITING, _GRANTED, _EVICTED = 0, 1, 2


class AdmissionGrant:
    """The handle ``admit()`` yields for the ``with`` body.

    ``exclude_service_s`` subtracts one-off, non-recurring seconds
    from what this request contributes to the service-time EWMA.  The
    weight pager uses it for cold-start fault-ins: the EWMA predicts
    STEADY-STATE service for deadline shedding, and one 100 ms weight
    fault recorded as service time would predictively shed every
    deadline request behind it against a cost they will never pay."""

    __slots__ = ("excluded_s",)

    def __init__(self):
        self.excluded_s = 0.0

    def exclude_service_s(self, seconds: float) -> None:
        self.excluded_s += max(0.0, float(seconds))


class _Ticket:
    """One queued admission request."""

    __slots__ = ("cls", "seq", "state")

    def __init__(self, cls: "_PriorityClass", seq: int):
        self.cls = cls
        self.seq = seq
        self.state = _WAITING


class _PriorityClass:
    """Per-class scheduling/shedding state.  All fields are owned by
    the controller's condition lock."""

    __slots__ = ("name", "priority", "weight", "vtime", "waiters",
                 "admitted", "shed")

    def __init__(self, name: str, priority: int, weight: float):
        self.name = name
        self.priority = int(priority)
        self.weight = float(weight)
        self.vtime = 0.0
        self.waiters: "collections.deque[_Ticket]" = collections.deque()
        self.admitted = 0
        self.shed = 0


class AdmissionController:
    """Bounded queue + concurrency limit + deadline-aware shedding +
    priority classes with weighted fair-share (module docstring)."""

    def __init__(self, max_queue: int = 64, max_concurrency: int = 4,
                 default_deadline_ms: Optional[float] = None,
                 ewma_alpha: float = 0.2,
                 classes: Optional[Dict[str, Any]] = None):
        if max_queue < 1:
            # _waiting transiently covers a request about to take a
            # free slot, so the strict bound needs at least one seat
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_concurrency < 1:
            raise ValueError(
                f"max_concurrency must be >= 1, got {max_concurrency}")
        self.max_queue = int(max_queue)
        self.max_concurrency = int(max_concurrency)
        self.default_deadline_ms = default_deadline_ms
        self._alpha = float(ewma_alpha)
        # reentrant: the grant/evict helpers re-enter the lock they
        # were called under, so every state write is LEXICALLY guarded
        # (a reader sees the with-block)
        self._cond = threading.Condition(threading.RLock())
        self._waiting = 0            # admitted to the queue, no slot yet
        self._running = 0            # holding a concurrency slot
        self._queue_high_water = 0
        self._draining = False
        self._service_ewma_s: Optional[float] = None
        self._seq = itertools.count()
        self._vclock = 0.0  # floor for a class (re)entering the queue
        self._classes: Dict[str, _PriorityClass] = {}
        self.set_class(DEFAULT_CLASS)
        self.set_class(_OVERFLOW_CLASS, priority=0, weight=0.0)
        for name, spec in (classes or {}).items():
            if isinstance(spec, dict):
                self.set_class(name, **spec)
            else:
                prio, weight = spec
                self.set_class(name, priority=prio, weight=weight)
        self.counters = Counters(
            "admitted", "completed", "errors", "shed_overload",
            "shed_deadline", "shed_draining", "shed_evicted",
            "deadline_lapsed")

    # ---- priority classes ----
    def set_class(self, name: str, priority: int = 0,
                  weight: float = 1.0) -> None:
        """Register (or reconfigure) a priority class.  ``priority``
        orders shedding (higher survives longer), ``weight`` its fair
        share of freed slots (0 = best-effort)."""
        if weight < 0:
            raise ValueError(f"class weight must be >= 0, got {weight}")
        with self._cond:
            cls = self._classes.get(name)
            if cls is None:
                self._classes[name] = _PriorityClass(name, priority,
                                                     weight)
            else:
                cls.priority = int(priority)
                cls.weight = float(weight)

    def _class_for(self, name: Optional[str]) -> _PriorityClass:
        if name is None:
            return self._classes[DEFAULT_CLASS]
        cls = self._classes.get(name)
        if cls is None:
            if len(self._classes) >= _MAX_CLASSES:
                # class names arrive from UNTRUSTED request input (the
                # web sample passes {"class": ...} straight through):
                # past the cap, unknown names share the best-effort
                # overflow class instead of permanently allocating
                # per-name state and three labeled metric series each
                # — an attacker sending fresh names must not grow
                # memory, explode scrape cardinality, dilute
                # configured fair-share weights, or (via the default
                # class's 1.0 weight) out-schedule a configured tenant
                return self._classes[_OVERFLOW_CLASS]
            # unknown names degrade to BEST-EFFORT (priority 0, weight
            # 0) rather than erroring a live request path: an
            # unregistered (or typo'd, or abusive) name must never
            # out-schedule a configured tenant — a weight of 1.0 here
            # would hand any fresh name a bigger WFQ share than the
            # web sample's 0.9 premium class.  Register explicitly for
            # real tenant configs.
            cls = _PriorityClass(name, 0, 0.0)
            self._classes[name] = cls
        return cls

    # ---- admission ----
    @contextlib.contextmanager
    def admit(self, deadline_ms: Optional[float] = None, span=None,
              priority_class: Optional[str] = None):
        """Admit (or shed) one request; run the service call in the
        ``with`` body.  Raises Overloaded / DeadlineExceeded instead of
        queueing hopeless work.  ``span`` (an observability trace span)
        gets the ``admission_queue`` phase: opened here, closed by
        whichever phase the data plane starts next — so queue wait and
        slot wait are attributed, gap-free, even when admission is
        instant.  ``priority_class`` tags the request for shedding
        order and fair-share scheduling (default class when None).
        Yields an :class:`AdmissionGrant` (callers that ignore it are
        unchanged; the weight pager excludes cold-start fault seconds
        from the service EWMA through it)."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if span is not None:
            span.phase_start("admission_queue")
        t0 = time.perf_counter()
        deadline = None if deadline_ms is None else t0 + deadline_ms / 1e3
        self._acquire(t0, deadline, deadline_ms, priority_class)
        t_service = time.perf_counter()
        grant = AdmissionGrant()
        try:
            yield grant
        except BaseException:
            self._release(t_service, error=True,
                          excluded_s=grant.excluded_s)
            raise
        self._release(t_service, error=False,
                      excluded_s=grant.excluded_s)

    def _predicted_wait_s(self, cls: "_PriorityClass") -> Optional[float]:
        """Predicted time to COMPLETE a ``cls`` request admitted now:
        rounds of service ahead of it, plus its own service.  None
        until a service time has been observed (the first requests are
        never predictively shed — there is nothing to predict from).

        The estimate is CLASS-AWARE: WFQ grants ``cls`` a
        ``weight/total_weight`` share of freed slots, so a weighted
        request only waits behind its OWN class's queue scaled by the
        inverse of that share — a high-weight request behind a large
        low-weight backlog must not be shed on a FIFO estimate the
        scheduler will never make it pay (single default class: the
        share is 1 and this reduces to the original whole-queue
        formula).  Weight-0 (best-effort) requests really do wait
        behind everyone, so they keep the whole-queue estimate."""
        if self._service_ewma_s is None:
            return None
        if cls.weight > 0:
            total_w = sum(c.weight for c in self._classes.values()
                          if c.waiters and c.weight > 0)
            if not cls.waiters:
                total_w += cls.weight  # our arrival joins the set
            share = cls.weight / total_w
            ahead = len(cls.waiters) / share
        else:
            ahead = self._waiting
        rounds_ahead = ahead / float(self.max_concurrency)
        return self._service_ewma_s * (rounds_ahead + 1.0)

    def _evict_for(self, priority: int) -> bool:
        """Make room for an arriving request of ``priority`` by
        evicting the NEWEST waiter of the lowest class whose priority
        is strictly below it.  Returns True when a seat was freed.
        Strictly-below keeps equal-priority traffic honest: a full
        queue of peers rejects the newcomer (classic bounded-queue
        semantics), it never cannibalizes itself."""
        with self._cond:  # reentrant — callers already hold it
            victim_cls = None
            for cls in self._classes.values():
                if cls.waiters and cls.priority < priority and (
                        victim_cls is None
                        or cls.priority < victim_cls.priority):
                    victim_cls = cls
            if victim_cls is None:
                return False
            ticket = victim_cls.waiters.pop()  # newest: waited least
            ticket.state = _EVICTED
            self._waiting -= 1
            victim_cls.shed += 1
            self.counters.inc("shed_evicted")
            self._cond.notify_all()
            return True

    def _acquire(self, t0: float, deadline: Optional[float],
                 deadline_ms: Optional[float],
                 priority_class: Optional[str]):
        with self._cond:
            cls = self._class_for(priority_class)
            if self._draining:
                # drain closes admission for EVERY class — a gold
                # request must not evict queued work the drain promised
                # to finish (priority inversion under drain)
                cls.shed += 1
                self.counters.inc("shed_draining")
                raise Overloaded("model is draining — not admitting",
                                 queue_depth=self._waiting,
                                 priority_class=cls.name,
                                 draining=True)
            if deadline is not None:
                # predictive shed BEFORE any eviction: a deadline-doomed
                # arrival must not destroy a queued lower-priority
                # request only to shed itself one check later (eviction
                # does not shorten the wait — the evictor inherits the
                # freed seat, not the victim's queue position)
                est = self._predicted_wait_s(cls)
                if est is not None and t0 + est > deadline:
                    cls.shed += 1
                    self.counters.inc("shed_deadline")
                    raise DeadlineExceeded(
                        "deadline cannot be met at current queue depth",
                        shed=True,
                        predicted_ms=round(est * 1e3, 3),
                        deadline_ms=deadline_ms,
                        priority_class=cls.name,
                        queue_depth=self._waiting)
            if self._waiting >= self.max_queue \
                    and not self._evict_for(cls.priority):
                cls.shed += 1
                self.counters.inc("shed_overload")
                raise Overloaded(
                    "admission queue full",
                    queue_depth=self._waiting, max_queue=self.max_queue,
                    priority_class=cls.name)
            ticket = _Ticket(cls, next(self._seq))
            if not cls.waiters and cls.weight > 0:
                # a class (re)entering the queue starts at the virtual
                # clock floor — an idle class must not bank credit and
                # then monopolize the next burst
                cls.vtime = max(cls.vtime, self._vclock)
            cls.waiters.append(ticket)
            self._waiting += 1
            if self._waiting > self._queue_high_water:
                self._queue_high_water = self._waiting
            self._grant_locked()
            try:
                while ticket.state == _WAITING:
                    remaining = (None if deadline is None
                                 else deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        cls.shed += 1
                        self.counters.inc("deadline_lapsed")
                        raise DeadlineExceeded(
                            "deadline lapsed waiting for a slot",
                            shed=False,
                            waited_ms=round(
                                (time.perf_counter() - t0) * 1e3, 3),
                            deadline_ms=deadline_ms,
                            priority_class=cls.name)
                    self._cond.wait(timeout=remaining)
            except BaseException:
                # ANY exception out of the wait (deadline above, or a
                # KeyboardInterrupt/injected exception delivered inside
                # Condition.wait) must not leak the queue seat — the
                # old pre-class code guaranteed this in a finally, and
                # a leaked _WAITING ticket would shrink max_queue
                # forever (or, once granted by a racing release, burn
                # a concurrency slot no _release ever returns)
                if ticket.state == _WAITING:
                    cls.waiters.remove(ticket)
                    self._waiting -= 1
                elif ticket.state == _GRANTED:
                    # granted between the exception and this cleanup:
                    # hand the slot straight back
                    self._running -= 1
                    self.counters.inc("errors")
                    self._grant_locked()
                # our departure may unblock drain()'s wait
                self._cond.notify_all()
                raise
            if ticket.state == _EVICTED:
                raise Overloaded(
                    "shed while queued: a higher-priority request "
                    "arrived at a full queue",
                    evicted=True, priority_class=cls.name,
                    queue_depth=self._waiting,
                    max_queue=self.max_queue)

    def _next_class(self) -> Optional[_PriorityClass]:
        """The class whose head waiter gets the next freed slot.
        Weighted fair queueing over classes with weight > 0 (smallest
        virtual time first; ties to the higher priority, then FIFO);
        weight-0 classes are best-effort — eligible only when no
        weighted class has waiters, ordered by priority then FIFO."""
        weighted = None
        best_effort = None
        for cls in self._classes.values():
            if not cls.waiters:
                continue
            if cls.weight > 0:
                key = (cls.vtime, -cls.priority, cls.waiters[0].seq)
                if weighted is None or key < weighted[0]:
                    weighted = (key, cls)
            else:
                key = (-cls.priority, cls.waiters[0].seq)
                if best_effort is None or key < best_effort[0]:
                    best_effort = (key, cls)
        if weighted is not None:
            return weighted[1]
        return best_effort[1] if best_effort is not None else None

    def _grant_locked(self):
        """Hand out every free slot (called under the lock whenever
        one may have appeared).  All grant-side bookkeeping lives here
        so arrival order, release order, and concurrency raises share
        one scheduling policy."""
        with self._cond:  # reentrant — callers already hold it
            granted = False
            while self._running < self.max_concurrency:
                cls = self._next_class()
                if cls is None:
                    break
                ticket = cls.waiters.popleft()
                ticket.state = _GRANTED
                self._waiting -= 1
                self._running += 1
                self.counters.inc("admitted")
                cls.admitted += 1
                if cls.weight > 0:
                    self._vclock = max(self._vclock, cls.vtime)
                    cls.vtime += 1.0 / cls.weight
                granted = True
            if granted:
                self._cond.notify_all()

    def _release(self, t_service: float, error: bool,
                 excluded_s: float = 0.0):
        # excluded seconds (a pager fault-in) are one-off setup, not
        # service: the EWMA must keep predicting the steady state
        dt = max(0.0, time.perf_counter() - t_service - excluded_s)
        with self._cond:
            self._running -= 1
            self.counters.inc("errors" if error else "completed")
            # errors count toward the EWMA too: a failing model still
            # consumes service time, and shedding must see that
            if self._service_ewma_s is None:
                self._service_ewma_s = dt
            else:
                self._service_ewma_s += self._alpha * (
                    dt - self._service_ewma_s)
            self._grant_locked()
            self._cond.notify_all()

    def set_max_concurrency(self, n: int):
        """Re-bound concurrent service (thread-safe).  The registry
        calls this when a deployed model's replica count changes — N
        device replicas carry N times the concurrent work of one, so
        the admission bound scales with them (the autoscaler re-bounds
        it on every scale event the same way).  Raising the bound
        grants queued waiters immediately; lowering it only throttles
        NEW grants (requests already running finish normally)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"max_concurrency must be >= 1, got {n}")
        with self._cond:
            self.max_concurrency = n
            self._grant_locked()
            self._cond.notify_all()

    def reset_service_ewma(self):
        """Forget the observed service-time EWMA.  The registry calls
        this on version ACTIVATION: the estimate describes the model
        that produced it, and a slow old version's EWMA would
        predictively shed deadline requests a fast new version could
        easily meet.  The first requests after a reset are never
        predictively shed (same cold-start rule as construction)."""
        with self._cond:
            self._service_ewma_s = None

    # ---- shutdown ----
    def drain(self, timeout: float = 10.0) -> bool:
        """Graceful shutdown: stop admitting NEW requests (they get
        Overloaded) but let everything already admitted — queued or
        running — finish.  Returns True when fully drained within
        ``timeout``."""
        end = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._waiting or self._running:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    @property
    def draining(self) -> bool:
        return self._draining

    # ---- introspection ----
    def snapshot(self) -> dict:
        with self._cond:
            c = self.counters.snapshot()
            c["shed"] = (c["shed_overload"] + c["shed_deadline"]
                         + c["shed_draining"] + c["shed_evicted"]
                         + c["deadline_lapsed"])
            classes = {
                cls.name: {"priority": cls.priority,
                           "weight": cls.weight,
                           "waiting": len(cls.waiters),
                           "admitted": cls.admitted,
                           "shed": cls.shed}
                for cls in self._classes.values()}
            return {
                "queue_depth": self._waiting,
                "running": self._running,
                "queue_high_water": self._queue_high_water,
                "max_queue": self.max_queue,
                "max_concurrency": self.max_concurrency,
                "draining": self._draining,
                "service_ewma_ms": (
                    None if self._service_ewma_s is None
                    else round(self._service_ewma_s * 1e3, 3)),
                "classes": classes,
                **c,
            }
