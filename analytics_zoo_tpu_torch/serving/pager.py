"""Weight pager: serving density — one node serving many more models
than fit on-device.

Counterpart of ``analytics_zoo_tpu/serving/pager.py``: the same state
machine, counters, families and span phases.  The port has no executable
store, so a fault-in is the host-to-device copy of the weights plus a
warm-up run of the bucket ladder (the buckets' builds).

Production fleets serve hundreds of models whose combined working set
exceeds device memory, but every ``ModelRegistry.deploy`` used to pin
its weights and executables forever.  The pager turns each registry
entry into a resident/cold state machine instead:

* **resident** — the deployment holds a live ``InferenceModel``
  (weights on the device, buckets built); requests serve on the
  existing hot path, which NEVER acquires the pager lock
  (``lock_acquisitions`` makes that measurable);
* **cold** — the deployment's model handle is closed and dropped, so
  its tensors leave the card; the entry keeps only its *recipe*:
  host-side (numpy) weights, a module skeleton on the ``meta`` device
  and the deploy configuration;
* **faulting** — the first request to a cold model rebuilds the
  handle: one host-to-device copy of the weights
  (``InferenceModel.load_fn``; replica 0 serves the placed tensors,
  never a second device copy) plus a warm-up of every bucket.
  Concurrent first-requests to the same model share
  ONE fault: the winner builds, the rest wait on the pager condition
  (``pager_wait`` span phase) — no duplicate upload;
* **evicting** — idle-time or memory-pressure demotion back to cold.
  Eviction is in-flight-safe: arrivals are diverted to the fault path
  first, then the evictor waits for the deployment's in-flight
  balance (``started == aborted + requests + errors`` on the
  deployment counters — accounting the hot path already pays) to
  reach zero before closing the handle.  A model that will not
  quiesce within the bound is HOT: the eviction aborts and residency
  is restored.

Cold-start handling is admission-integrated: a faulting request holds
its admission slot and queues *under its own deadline* — past it the
request fails with the structured 503
:class:`~.errors.ColdStartTimeout` (the fault keeps running; the next
caller lands hot), and the fault seconds are EXCLUDED from the
admission controller's service-time EWMA so one cold start cannot
poison predictive deadline shedding for the requests behind it.

Observability: ``zoo_model_resident{model}``,
``zoo_pager_faults_total{model,outcome=ok|timeout|error}`` and
``zoo_pager_evictions_total{model,reason=idle|pressure}`` families
ride the registry scrape, and a faulting request's span carries the
``pager_wait`` / ``weights_h2d`` / ``exec_rehydrate`` phases.

A structured :class:`ColdStartTimeout` is never worth retrying on a
sibling, so one slow fault cannot cascade into every worker faulting
the same model.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..observability.log import get_logger as _get_logger
from .errors import ColdStartTimeout

_slog = _get_logger("zoo.serving.pager")

#: entry residency states (``entry.pager_state``; None = unpaged)
RESIDENT = "resident"
FAULTING = "faulting"
EVICTING = "evicting"
COLD = "cold"


class _CountingLock:
    """A plain mutex that counts successful acquisitions.  A
    resident-hot-path check reads the count around a warmed serve
    window: a resident model's request path must never touch
    the pager, and this makes "never" measurable instead of asserted.
    (The increment happens while the lock is held, so the counter
    needs no lock of its own.)"""

    __slots__ = ("_lock", "acquisitions")

    def __init__(self):
        self._lock = threading.Lock()
        self.acquisitions = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self.acquisitions += 1
        return ok

    def release(self):
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self._lock.release()


class PageRecipe:
    """Everything needed to rebuild a cold deployment's serving handle
    from host memory: a ``build()`` closure created at deploy time (it
    captures HOST-side numpy weights — never device tensors, or the
    cold state would still pin device memory) plus
    bookkeeping for logs and budgets."""

    __slots__ = ("build", "host_bytes", "version")

    def __init__(self, build: Callable[..., Any], host_bytes: int = 0,
                 version: int = 0):
        self.build = build
        self.host_bytes = int(host_bytes)
        self.version = int(version)


class ModelPager:
    """The LRU weight/executable pager one :class:`ModelRegistry` owns
    (module docstring).

    ``max_resident`` bounds how many paged models hold device memory
    at once (the pressure trigger: a fault past the budget evicts the
    least-recently-used resident entry first).  ``idle_evict_s``
    additionally demotes entries untouched for that long via a
    background reaper thread (off by default — pressure-only paging
    keeps the process thread-free and the resident hot window
    deterministic).  ``fault_timeout_s`` is the cold-start backstop
    for deadline-less requests; requests with a deadline queue under
    their own.
    """

    def __init__(self, max_resident: int, idle_evict_s: Optional[float] = None,
                 fault_timeout_s: float = 60.0,
                 quiesce_timeout_s: float = 5.0,
                 reap_interval_s: float = 0.5):
        if int(max_resident) < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {max_resident}")
        self.max_resident = int(max_resident)
        self.idle_evict_s = (None if idle_evict_s is None
                             else float(idle_evict_s))
        self.fault_timeout_s = float(fault_timeout_s)
        self.quiesce_timeout_s = float(quiesce_timeout_s)
        self._reap_interval_s = float(reap_interval_s)
        # THE pager lock: every residency transition (fault, evict,
        # attach, detach) serializes here.  The resident request path
        # never acquires it — `lock_acquisitions` is the proof.
        self._lock = _CountingLock()
        self._cond = threading.Condition(self._lock)
        self._entries: Dict[str, Any] = {}
        self._reaper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

    # ---- introspection -------------------------------------------------
    @property
    def lock_acquisitions(self) -> int:
        """Total pager-lock acquisitions ever (a check reads the
        delta over a warmed resident window and requires 0)."""
        return self._lock.acquisitions

    def resident_count(self) -> int:
        with self._cond:
            return sum(1 for e in self._entries.values()
                       if e.pager_state in (RESIDENT, FAULTING, EVICTING))

    def snapshot(self) -> Dict[str, Any]:
        """Control-plane view (NOT for the per-request path — this
        takes the pager lock)."""
        now = time.monotonic()
        with self._cond:
            models = {
                n: {"state": e.pager_state,
                    "idle_s": round(now - e.pager_stamp, 3),
                    **e.pager_counters.snapshot()}
                for n, e in sorted(self._entries.items())}
        return {"max_resident": self.max_resident,
                "idle_evict_s": self.idle_evict_s,
                "lock_acquisitions": self.lock_acquisitions,
                "models": models}

    # ---- registry hooks (control plane) --------------------------------
    def note_swapped(self, name: str, entry, recipe: PageRecipe):
        """A deploy just swapped a freshly-built (hence resident)
        version into ``entry``: record the new recipe, bump the
        generation so any in-flight fault of the PREVIOUS version
        discards its rebuild instead of installing stale weights, and
        make room under the budget."""
        with self._cond:
            self._entries[name] = entry
            entry.pager_gen += 1
            entry.pager_recipe = recipe
            entry.pager_state = RESIDENT
            entry.pager_stamp = time.monotonic()
            self._cond.notify_all()
        self._evict_for_budget(exclude=entry)

    def detach(self, name: str, entry) -> None:
        """Stop paging ``entry`` (undeploy, or a redeploy that is no
        longer pageable).  Waiting faulters wake and re-route; an
        in-flight rebuild sees the generation bump and closes its
        model instead of installing it."""
        with self._cond:
            self._entries.pop(name, None)
            entry.pager_gen += 1
            entry.pager_recipe = None
            entry.pager_state = None
            self._cond.notify_all()

    def close(self):
        """Stop the reaper (idempotent).  Does not touch residency —
        the registry's shutdown closes the models themselves."""
        self._closed = True
        self._stop.set()
        reaper = self._reaper
        if reaper is not None and reaper.is_alive():
            with self._cond:
                self._cond.notify_all()
            reaper.join(timeout=10.0)

    # ---- fault-in (the cold-request path) ------------------------------
    def fault_in(self, entry, deadline: Optional[float] = None,
                 span=None) -> float:
        """Bring ``entry`` resident (or wait for whoever already is).
        Returns the seconds this call spent waiting/building so the
        caller can exclude them from the admission EWMA.  Raises
        :class:`ColdStartTimeout` when ``deadline`` (absolute
        ``time.perf_counter()`` seconds; the pager's
        ``fault_timeout_s`` backstop when None) lapses first — the
        fault itself keeps running for the next caller."""
        t0 = time.perf_counter()
        if deadline is None:
            deadline = t0 + self.fault_timeout_s
        gen = 0
        with self._cond:
            while True:
                st = entry.pager_state
                if st is None or st == RESIDENT:
                    return time.perf_counter() - t0
                if st == COLD and entry.pager_recipe is not None:
                    entry.pager_state = FAULTING
                    gen = entry.pager_gen
                    break
                # someone else is faulting (or an eviction is mid-
                # teardown): queue under the deadline
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    entry.pager_counters.inc("fault_timeout")
                    raise ColdStartTimeout(
                        f"model {entry.name!r} is cold and its "
                        "fault-in did not complete within the deadline",
                        model=entry.name, state=st,
                        waited_ms=round(
                            (time.perf_counter() - t0) * 1e3, 3))
                if span is not None:
                    span.phase_start("pager_wait")
                self._cond.wait(timeout=remaining)
        # we are the faulter: build OUTSIDE the lock (waiters park on
        # the condition; the resident hot path never comes near it)
        return self._fault_build(entry, gen, t0, deadline, span)

    def _fault_build(self, entry, gen: int, t0: float, deadline: float,
                     span) -> float:
        self._evict_for_budget(exclude=entry)
        recipe = entry.pager_recipe
        dep0 = entry.active
        model = None
        try:
            if recipe is None or dep0 is None:
                raise RuntimeError(
                    f"model {entry.name!r} lost its page recipe "
                    "(undeployed mid-fault)")
            t_build = time.perf_counter()
            # the rebuild blocks on the upload and the bucket warm-up by
            # design: that block IS the fault
            rebuild_cold = recipe.build
            model = rebuild_cold(span=span)
            # group-atomic fault: a sharded model whose replica-group
            # placement came back incomplete must FAIL the fault (the
            # entry stays cold, the requester gets the error) rather
            # than install — a partially-resident group serves wrong
            # answers, not slower ones
            check = getattr(model, "placement_complete", None)
            if check is not None and not check():
                raise RuntimeError(
                    f"model {entry.name!r} rebuilt with incomplete "
                    "replica-group placement — refusing to install a "
                    "partially resident group")
            build_s = time.perf_counter() - t_build
        except BaseException as e:
            with self._cond:
                if entry.pager_gen == gen and \
                        entry.pager_state == FAULTING:
                    entry.pager_state = COLD
                entry.pager_counters.inc("fault_error")
                self._cond.notify_all()
            _slog.error("pager_fault_failed", model=entry.name,
                        error=f"{type(e).__name__}: {e}")
            raise
        # install: only into the deployment the recipe describes.  A
        # deploy/undeploy that raced the build bumped the generation
        # (or re-pointed entry.active, or already re-populated
        # dep0.model) — then this rebuild is stale and must be closed,
        # never swapped over fresher weights.
        stale = False
        with entry.lock:
            if (entry.pager_gen != gen or entry.active is not dep0
                    or dep0.model is not None):
                stale = True
            else:
                dep0.model = model
        if stale:
            model.close()
            with self._cond:
                self._cond.notify_all()
            _slog.info("pager_fault_stale", model=entry.name)
            return time.perf_counter() - t0
        # ONE outcome per requesting thread: a fault that completed
        # past the requester's deadline counts `timeout`, not `ok` —
        # the request was NOT served, however useful the install is
        # to the next caller (sum-over-outcomes must equal requests)
        late = time.perf_counter() > deadline
        with self._cond:
            if entry.pager_gen == gen and entry.pager_state == FAULTING:
                entry.pager_state = RESIDENT
            entry.pager_stamp = time.monotonic()
            entry.pager_counters.inc(
                "fault_timeout" if late else "fault_ok")
            self._cond.notify_all()
        waited = time.perf_counter() - t0
        _slog.info("pager_fault_in", model=entry.name,
                   build_ms=round(build_s * 1e3, 3),
                   waited_ms=round(waited * 1e3, 3),
                   host_bytes=recipe.host_bytes)
        if late:
            # the model IS resident now (the work is not wasted), but
            # THIS request missed its cold-start SLO
            raise ColdStartTimeout(
                f"model {entry.name!r} faulted in, but past this "
                "request's deadline", model=entry.name, state=RESIDENT,
                waited_ms=round(waited * 1e3, 3))
        return waited

    # ---- eviction ------------------------------------------------------
    @staticmethod
    def _inflight(dep) -> int:
        """Requests that passed the residency check and have not yet
        completed, from the per-deployment counters the request path
        already maintains (no extra lock on the hot path)."""
        c = dep.counters.snapshot()
        return (c.get("started", 0) - c.get("aborted", 0)
                - c.get("requests", 0) - c.get("errors", 0))

    def _wait_quiesce(self, dep) -> bool:
        end = time.monotonic() + self.quiesce_timeout_s
        while self._inflight(dep) > 0:
            if time.monotonic() > end:
                return False
            time.sleep(0.002)
        return True

    def _try_evict(self, name: str, entry, reason: str) -> bool:
        """Demote one resident entry to cold.  In-flight-safe: new
        arrivals divert to the fault path the moment the state leaves
        RESIDENT; the handle is closed only after the in-flight
        balance quiesces.  A model that stays busy past the quiesce
        bound is hot — residency is restored and the eviction reports
        False."""
        with self._cond:
            if entry.pager_state != RESIDENT:
                return False
            entry.pager_state = EVICTING
            gen = entry.pager_gen
        dep = entry.active
        if dep is None or not self._wait_quiesce(dep):
            with self._cond:
                if entry.pager_gen == gen and \
                        entry.pager_state == EVICTING:
                    entry.pager_state = RESIDENT
                self._cond.notify_all()
            return False
        model = None
        with entry.lock:
            if entry.active is dep:
                model, dep.model = dep.model, None
        if model is not None:
            model.close()
            # a module's graph holds reference cycles, so only the cyclic
            # collector returns its tensors (and the card's memory); a
            # handle rebuilt by a fault-in serves plain tensors and needs
            # none
            cyclic = getattr(model, "_net", None) is not None
            del model
            if cyclic:
                gc.collect()
        with self._cond:
            if entry.pager_gen == gen and entry.pager_state == EVICTING:
                entry.pager_state = COLD
            entry.pager_counters.inc("evict_" + reason)
            self._cond.notify_all()
        _slog.info("pager_evict", model=name, reason=reason)
        return True

    def _evict_for_budget(self, exclude=None):
        """Make room for one incoming resident entry: evict LRU
        resident entries (never ``exclude`` — the one faulting in)
        until the occupied count fits the budget.  Best-effort: a
        victim that will not quiesce is skipped, transient overcommit
        by in-flight faults is tolerated (the budget is a working-set
        target, not a hard device-memory wall)."""
        while True:
            with self._cond:
                occupied = [(e.pager_stamp, n, e)
                            for n, e in self._entries.items()
                            if e.pager_state in (RESIDENT, FAULTING,
                                                 EVICTING)]
                # occupied already counts the incoming entry (RESIDENT
                # from note_swapped, FAULTING from a fault) — evict
                # only when it would EXCEED the budget, or a budget of
                # N silently serves N-1 resident models
                if len(occupied) <= self.max_resident:
                    return
                victims = sorted(
                    (t, n, e) for t, n, e in occupied
                    if e is not exclude and e.pager_state == RESIDENT)
            if not victims:
                return
            evicted = False
            for _, vname, ventry in victims:
                if self._try_evict(vname, ventry, "pressure"):
                    evicted = True
                    break
            if not evicted:
                return

    # ---- idle reaper ---------------------------------------------------
    def start_reaper(self):
        """Start the idle-eviction thread (no-op unless
        ``idle_evict_s`` is configured; idempotent)."""
        if self.idle_evict_s is None or self._closed:
            return
        if self._reaper is not None and self._reaper.is_alive():
            return
        t = threading.Thread(target=self._reap_loop,
                             name="zoo-pager-reaper", daemon=True)
        self._reaper = t
        t.start()

    def _reap_loop(self):
        while not self._stop.wait(self._reap_interval_s):
            now = time.monotonic()
            with self._cond:
                idle = [(n, e) for n, e in self._entries.items()
                        if e.pager_state == RESIDENT
                        and now - e.pager_stamp >= self.idle_evict_s]
            for n, e in idle:
                if self._stop.is_set():
                    return
                self._try_evict(n, e, "idle")
