"""Per-request tracing for the serving stack: Span / Tracer with
explicit cross-thread handoff.

Counterpart of ``analytics_zoo_tpu/observability/trace.py``: the same
phase names, span dict layout and Prometheus families.  A span times the
host, as the JAX package's does: ``execute`` and ``step_compute`` cover
the dispatch of the device work, not its device time.

A request through the serving plane hops five queues/threads (admission
-> coalescer queue -> dispatcher -> device -> fan-out), so a p99
regression is unattributable from endpoint latency alone.  Each request
carries ONE :class:`Span` recording a contiguous sequence of phases::

    admission_queue -> coalesce_wait -> pad -> device_put -> execute
                    -> depad

``phase_start`` closes the previously open phase at the same timestamp,
so phases are gap-free BY CONSTRUCTION — the only uncovered time is the
tail between the last ``phase_end`` and ``finish()`` (future wake-up +
response serialization), which ``coverage`` exposes.

Cross-thread handoff is EXPLICIT: contextvars do not propagate into the
coalescer's dispatcher thread (it was started long before the request
existed), so the pending request object carries its span and the
dispatcher calls ``phase_start`` on it directly.  A span is only ever
touched by one thread at a time (caller until submit, dispatcher until
the future resolves, caller again after), so spans need no lock.

Cost model: when no tracer is active, the hot path pays ONE module-flag
branch (``current_span()`` returns None immediately); instrumentation
sites guard every other call behind ``if span is not None``.

Finished spans land in the tracer's bounded ring buffer (``recent()``)
and their per-phase durations aggregate into ``phase_stats()`` /
``families()`` for Prometheus exposition.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from .. import envcontract
from .metrics import Family

#: the canonical request phase order.  After
#: admission come the weight pager's cold-start phases (absent on the
#: resident hot path): pager_wait parks behind an in-flight fault,
#: weights_h2d is the one device_put of the host weights, and
#: exec_rehydrate the execstore warmup of the bucket ladder.  Then the
#: one-shot predict chain; the last three belong to the
#: continuous-batching generate path (decode_wait covers the engine
#: queue, prefill the bucketed prompt pass + slot insert, decode_step
#: the whole shared-step participation until eviction).
PHASES = ("admission_queue", "pager_wait", "weights_h2d",
          "exec_rehydrate", "coalesce_wait", "pad", "device_put",
          "execute", "depad", "decode_wait", "prefill", "decode_step")

#: the training-step phase order (train/stepprof.py; same gap-free
#: discipline as the request chain): waiting on the prefetch queue,
#: the host->device upload (measured on the prefetch thread and
#: attributed to the consuming step), the host-side microbatch split
#: when gradient accumulation is on (also prefetch-thread-measured),
#: the compiled step dispatch, and the checkpoint save when its
#: trigger fires.
TRAIN_PHASES = ("data_wait", "h2d", "grad_accum", "step_compute",
                "ckpt_save")

_SPAN_VAR: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("zoo_tpu_span", default=None)
# STICKY enable flag: False until the first span is ever activated in
# this process, True forever after.  A process that never traces pays
# exactly one bool branch per predict; once tracing has happened the
# branch falls through to a contextvar read (~100ns).  Sticky (rather
# than refcounted) keeps activate() lock-free on the request path.
_ENABLED = False


def tracing_active() -> bool:
    """True once any span has ever been activated in this process
    (sticky — see the flag comment above)."""
    return _ENABLED


def current_span() -> "Optional[Span]":
    """The span activated on this thread's context, or None.  Before
    any tracing has happened the path is one global-flag branch — no
    contextvar read."""
    if not _ENABLED:
        return None
    return _SPAN_VAR.get()


@contextlib.contextmanager
def activate(span: "Optional[Span]"):
    """Make ``span`` the current span for the calling thread (and any
    code it calls synchronously).  Thread hops do NOT inherit it — hand
    the span object across explicitly (the coalescer's pending request
    carries it)."""
    global _ENABLED
    if span is None:
        yield None
        return
    token = _SPAN_VAR.set(span)
    if not _ENABLED:
        _ENABLED = True
    try:
        yield span
    finally:
        _SPAN_VAR.reset(token)


# a fresh uuid4 per request costs ~40us on small hosts, material
# against a ~1ms request.  One
# random prefix per process + a GIL-atomic counter is unique within
# any ring/log scope and ~1us.
_ID_PREFIX = uuid.uuid4().hex[:8]
_ID_COUNTER = itertools.count(1)


def new_trace_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_COUNTER) & 0xffffffff:08x}"


# finished-span sink for the flight recorder (flightrec.configure):
# every tracer-owned span that finishes is offered to it.  One None
# check per finish when no recorder is configured.
_FINISH_HOOK: "Optional[Any]" = None


def set_finish_hook(fn) -> None:
    global _FINISH_HOOK
    _FINISH_HOOK = fn


# decoder for compact wire-string children (set by tracefleet on
# import — the module that owns the wire format): Span.to_dict uses
# it to render raw nested strings as summary dicts.  Returning None
# for a given string drops that child from the serialized form.
_CHILD_DECODER: "Optional[Any]" = None


def set_child_decoder(fn) -> None:
    global _CHILD_DECODER
    _CHILD_DECODER = fn


def tail_config_from_env() -> Dict[str, Any]:
    """Tail-sampling Tracer kwargs from the env contract:
    ``ZOO_TRACE_TAIL_Q`` (retention quantile, default 0.95; a value
    outside (0,1) — e.g. an explicit ``0`` — disables retention) and
    ``ZOO_TRACE_TAIL_CAP`` (exemplar budget, default 64).  Garbage
    degrades to the defaults, the envcontract parsing discipline."""
    cap = envcontract.env_int("ZOO_TRACE_TAIL_CAP", 64)
    raw = envcontract.env_str("ZOO_TRACE_TAIL_Q")
    q: Optional[float] = 0.95
    if raw is not None:
        try:
            q = float(raw)
        except ValueError:
            q = 0.95
        if not (0.0 < q < 1.0):
            q = None
    return {"tail_quantile": q, "tail_cap": max(cap, 1)}


class Span:
    """One request's timeline: ordered phases + point events + labels.

    Single-owner-at-a-time by design (see module doc) — no lock."""

    __slots__ = ("name", "trace_id", "labels", "start_s", "start_wall",
                 "end_s", "phases", "events", "children", "_open",
                 "_tracer", "_totals")

    def __init__(self, tracer: "Optional[Tracer]", name: str,
                 trace_id: Optional[str] = None,
                 labels: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        # taken by reference, not copied: every caller passes a fresh
        # **labels dict, and the copy showed up in the overhead gate
        self.labels: Dict[str, Any] = labels if labels is not None else {}
        self.start_s = time.perf_counter()
        self.start_wall = time.time()
        self.end_s: Optional[float] = None
        # each entry: [phase_name, start, end_or_None]
        self.phases: List[List[Any]] = []
        self.events: List[Dict[str, Any]] = []
        # remote child summaries (add_child); None until the first one
        # lands — almost no span has children, so no list allocation
        self.children: Optional[List[Dict[str, Any]]] = None
        self._open: Optional[List[Any]] = None
        self._totals: Optional[Dict[str, float]] = None

    # ---- phases ----
    def phase_start(self, name: str):
        """Open phase ``name``; the previously open phase (if any) is
        closed at the SAME timestamp, so consecutive phases never gap."""
        t = time.perf_counter()
        if self._open is not None:
            self._open[2] = t
        p = [name, t, None]
        self.phases.append(p)
        self._open = p

    def phase_end(self):
        """Close the open phase (idempotent when none is open)."""
        if self._open is not None:
            self._open[2] = time.perf_counter()
            self._open = None

    def phase_add(self, name: str, seconds: float,
                  end_s: Optional[float] = None):
        """Record an already-measured CLOSED phase (duration known, no
        open/close bracketing).  For work measured on another thread —
        the prefetch thread's h2d upload — whose duration belongs in
        this span's totals but whose wall interval overlaps the
        on-thread phases."""
        end = time.perf_counter() if end_s is None else end_s
        self.phases.append([name, end - seconds, end])

    @contextlib.contextmanager
    def phase(self, name: str):
        self.phase_start(name)
        try:
            yield self
        finally:
            self.phase_end()

    # ---- events / labels ----
    def event(self, name: str, **attrs: Any):
        """A point-in-time annotation (e.g. an XLA ``backend_compile``
        observed while this span was current)."""
        self.events.append({"name": name,
                            "t_s": time.perf_counter() - self.start_s,
                            **attrs})

    def set_label(self, key: str, value: Any):
        self.labels[key] = value

    def add_child(self, child):
        """Nest a REMOTE span summary under this span — the fleet
        router attaches the worker-side timeline a reply piggybacked
        (tracefleet.py owns the summary shape and the stitching).  A
        child is either a summary dict or the RAW compact wire string
        it arrived as: the string is stored un-parsed — one object —
        and only decoded when the span is serialized, because parsing
        per request allocated enough to show up as gc pauses against
        the traced-throughput gate."""
        if self.children is None:
            self.children = []
        self.children.append(child)

    # ---- lifecycle ----
    def finish(self):
        """Close the open phase, stamp the end, and hand the span to
        its tracer's ring buffer / aggregates (idempotent)."""
        if self.end_s is not None:
            return
        self.phase_end()
        self.end_s = time.perf_counter()
        if self._tracer is not None:
            self._tracer._finished(self)

    # ---- derived ----
    @property
    def wall_s(self) -> float:
        end = self.end_s if self.end_s is not None else time.perf_counter()
        return end - self.start_s

    def phase_totals(self) -> Dict[str, float]:
        """Total seconds per phase name (a phase may recur, e.g. pad /
        execute once per chunk of an oversized batch).  Memoized once
        the span is finished — the serve path reads it twice per
        request (ring aggregation, then the fleet-gap computation) and
        the rebuild showed up against the traced-throughput gate.
        Treat the returned dict as read-only."""
        if self._totals is not None:
            return self._totals
        out: Dict[str, float] = {}
        for name, t0, t1 in self.phases:
            if t1 is None:
                continue
            out[name] = out.get(name, 0.0) + (t1 - t0)
        if self.end_s is not None:
            self._totals = out
        return out

    @property
    def phase_total_s(self) -> float:
        return sum(self.phase_totals().values())

    @property
    def coverage(self) -> float:
        """Fraction of the span wall time covered by phases — the
        acceptance gate for "no phase gaps" (phases are internally
        contiguous, so 1 - coverage is exactly the head + tail slack)."""
        wall = self.wall_s
        return (self.phase_total_s / wall) if wall > 0 else 1.0

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "trace_id": self.trace_id,
            "name": self.name,
            "labels": dict(self.labels),
            "start_unix_s": round(self.start_wall, 6),
            # the monotonic start too: paired with the recorder's
            # meta.json wall/mono anchor it places this span on the
            # pod timeline without trusting the wall clock per span
            "start_mono_s": round(self.start_s, 6),
            "wall_ms": round(self.wall_s * 1e3, 4),
            "phases": [{"name": n,
                        "start_ms": round((t0 - self.start_s) * 1e3, 4),
                        "dur_ms": (None if t1 is None
                                   else round((t1 - t0) * 1e3, 4))}
                       for n, t0, t1 in self.phases],
            "phase_total_ms": round(self.phase_total_s * 1e3, 4),
            "coverage": round(self.coverage, 4),
            "events": list(self.events),
        }
        if self.children:
            dec = _CHILD_DECODER
            kids = []
            for ch in self.children:
                if isinstance(ch, str):
                    ch = dec(ch) if dec is not None else None
                    if ch is None:
                        continue
                kids.append(ch)
            out["children"] = kids
        return out


class Tracer:
    """Span factory + bounded ring buffer of recent finished spans +
    per-phase duration aggregation.

    One tracer per serving process is the expected shape; the registry
    and the web frontend share it.  ``capacity`` bounds memory: the ring
    holds the most recent N finished spans, aggregates are O(#phases).

    Tail sampling (``tail_quantile``): the ring treats every span
    equally and washes the interesting ones out under load, so the
    tracer additionally RETAINS full span trees for exactly the
    requests worth a postmortem — every errored span, plus spans whose
    wall time clears the running ``tail_quantile`` of recent walls —
    in a store bounded by ``tail_cap`` (fastest non-errored exemplar
    evicted first).  ``exemplars()`` lists them and ``families()``
    publishes each as a ``zoo_trace_exemplar_ms`` sample whose
    ``trace_id`` label is the join key the tracefleet stitcher
    reconstructs a cross-process waterfall from.
    """

    #: recent-wall reservoir size and threshold refresh period for the
    #: tail sampler: sorting 256 floats every finish showed up against
    #: sub-ms requests, so the quantile threshold refreshes every 32
    #: finishes instead — exemplar selection is a sieve, not a ruling
    _TAIL_WINDOW = 256
    _TAIL_REFRESH = 32

    def __init__(self, capacity: int = 256,
                 tail_quantile: Optional[float] = None,
                 tail_cap: int = 64):
        self.capacity = int(capacity)
        self._ring: "deque[Span]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        # phase -> [count, total_s, max_s]
        self._agg: Dict[str, List[float]] = {}
        self._span_count = 0
        # tail-sampled exemplar store: trace_id -> retained Span
        self.tail_quantile = tail_quantile
        self.tail_cap = max(int(tail_cap), 1)
        self._tail: Dict[str, Span] = {}
        self._tail_walls: "deque[float]" = deque(maxlen=self._TAIL_WINDOW)
        self._tail_thr: Optional[float] = None

    def start_span(self, name: str = "request",
                   trace_id: Optional[str] = None,
                   **labels: Any) -> Span:
        return Span(self, name, trace_id=trace_id, labels=labels)

    @contextlib.contextmanager
    def request(self, name: str = "request",
                trace_id: Optional[str] = None, **labels: Any):
        """Start a span, activate it for the calling thread, finish it
        on exit: the one-liner for benches and tests.  Activation is
        inlined (no nested context manager): this wrapper is part of
        every traced request's overhead."""
        global _ENABLED
        span = Span(self, name, trace_id=trace_id, labels=labels)
        token = _SPAN_VAR.set(span)
        if not _ENABLED:
            _ENABLED = True
        try:
            yield span
        finally:
            _SPAN_VAR.reset(token)
            span.finish()

    def _finished(self, span: Span):
        with self._lock:
            self._ring.append(span)
            self._span_count += 1
            for phase, dur in span.phase_totals().items():
                agg = self._agg.get(phase)
                if agg is None:
                    self._agg[phase] = [1, dur, dur]
                else:
                    agg[0] += 1
                    agg[1] += dur
                    agg[2] = max(agg[2], dur)
            if self.tail_quantile is not None:
                self._tail_sample(span)
        hook = _FINISH_HOOK  # outside the lock: the hook does file I/O
        if hook is not None:
            try:
                hook(span)
            except Exception:
                pass  # the flight recorder must never fail a request

    def _tail_sample(self, span: Span) -> None:
        """Retention decision for one finished span (caller holds the
        lock).  Errored spans always stay; otherwise the span's wall
        must clear the cached quantile threshold of recent walls."""
        wall = span.wall_s
        walls = self._tail_walls
        walls.append(wall)
        if self._tail_thr is None \
                or self._span_count % self._TAIL_REFRESH == 0:
            ws = sorted(walls)
            idx = min(int(len(ws) * self.tail_quantile), len(ws) - 1)
            self._tail_thr = ws[idx]
        if "error" not in span.labels and wall < self._tail_thr:
            return
        self._tail[span.trace_id] = span
        while len(self._tail) > self.tail_cap:
            victim = None
            fastest = None
            for tid, s in self._tail.items():
                if "error" in s.labels:
                    continue
                w = s.wall_s
                if fastest is None or w < fastest:
                    fastest, victim = w, tid
            if victim is None:
                # every exemplar errored: oldest insertion goes
                victim = next(iter(self._tail))
            del self._tail[victim]

    # ---- read side ----
    @property
    def span_count(self) -> int:
        with self._lock:
            return self._span_count

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The most recent ``n`` finished spans (all when None),
        oldest first, as dicts.  ``n <= 0`` returns [] — slicing with
        ``-0`` would silently mean "everything", and this is reachable
        straight from ``GET /traces?n=``."""
        with self._lock:
            spans = list(self._ring)
        if n is not None:
            spans = spans[-n:] if n > 0 else []
        return [s.to_dict() for s in spans]

    def find_span(self, trace_id: str) -> "Optional[Span]":
        """The finished :class:`Span` object itself (ring newest-first,
        then the tail store) — the allocation-free lookup the worker's
        reply piggyback uses on the hot serve path; most callers want
        :meth:`find`, which returns the serialized dict."""
        with self._lock:
            for s in reversed(self._ring):
                if s.trace_id == trace_id:
                    return s
            return self._tail.get(trace_id)

    def find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Ring first (newest wins), then the tail-exemplar store —
        an exemplar ``trace_id`` read off a scrape stays resolvable
        long after the ring washed the span out."""
        s = self.find_span(trace_id)
        return s.to_dict() if s is not None else None

    def retire(self, **labels: Any) -> int:
        """Drop finished spans whose labels match ALL of ``labels``
        (e.g. ``retire(model="ncf")`` when that model is undeployed):
        a long-lived process cycling many models must not keep dead
        models' spans pinned in the ring until traffic happens to wash
        them out.  Phase aggregates are label-free totals and stay.
        Returns the number of spans dropped."""
        if not labels:
            return 0
        with self._lock:
            kept = [s for s in self._ring
                    if any(s.labels.get(k) != v
                           for k, v in labels.items())]
            dropped = len(self._ring) - len(kept)
            if dropped:
                self._ring.clear()
                self._ring.extend(kept)
            # exemplars pin spans too — a retired model's must go
            # (not counted: the return value is ring spans dropped,
            # and a span can sit in both structures at once)
            for tid in [tid for tid, s in self._tail.items()
                        if all(s.labels.get(k) == v
                               for k, v in labels.items())]:
                del self._tail[tid]
        return dropped

    def phase_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-phase duration aggregation over every finished span."""
        with self._lock:
            return {phase: {"count": int(c),
                            "total_s": round(total, 6),
                            "mean_ms": round(total / c * 1e3, 4),
                            "max_ms": round(mx * 1e3, 4)}
                    for phase, (c, total, mx) in sorted(self._agg.items())}

    def exemplars(self) -> List[Dict[str, Any]]:
        """The tail-retained exemplar index: one row per retained span
        tree, newest-insertion last.  ``kind`` is ``error`` or
        ``slow``; the full tree is ``find(trace_id)``."""
        with self._lock:
            spans = list(self._tail.values())
        return [{"trace_id": s.trace_id,
                 "kind": "error" if "error" in s.labels else "slow",
                 "model": str(s.labels.get("model", "")),
                 "wall_ms": round(s.wall_s * 1e3, 4)}
                for s in spans]

    def families(self) -> List[Family]:
        """Prometheus collector (plug into MetricsRegistry)."""
        with self._lock:
            agg = {k: list(v) for k, v in self._agg.items()}
            count = self._span_count
            tail = list(self._tail.values())
        fams = [Family("counter", "zoo_trace_spans_total",
                       "finished request spans",
                       [({}, count)])]
        fams.append(Family(
            "counter", "zoo_trace_phase_seconds_total",
            "cumulative seconds spent per request phase",
            [({"phase": p}, v[1]) for p, v in sorted(agg.items())]))
        fams.append(Family(
            "counter", "zoo_trace_phase_count_total",
            "phase occurrences across finished spans",
            [({"phase": p}, v[0]) for p, v in sorted(agg.items())]))
        if tail:
            # the exemplar link: a scrape row whose trace_id label
            # names a span tree this process still holds in full —
            # cardinality is bounded by tail_cap, and the stitcher
            # (tracefleet.py) turns the id into a pod waterfall
            fams.append(Family(
                "gauge", "zoo_trace_exemplar_ms",
                "tail-sampled exemplar traces (slowest-quantile and "
                "errored requests): wall ms, joined on trace_id",
                [({"model": str(s.labels.get("model", "")),
                   "kind": ("error" if "error" in s.labels
                            else "slow"),
                   "trace_id": s.trace_id},
                  round(s.wall_s * 1e3, 4)) for s in tail]))
        return fams
