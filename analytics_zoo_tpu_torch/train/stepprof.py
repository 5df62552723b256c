"""Training step profiler: the serving span discipline applied to
``Trainer.fit``.

Counterpart of ``analytics_zoo_tpu/train/stepprof.py``, with its phase
names, families, timeline format and flight-recorder records.  A slow
fit can be input-bound, upload-bound, compute-bound or checkpoint-bound,
and the epoch wall time does not say which.  When enabled, every step
carries one
:class:`~..observability.trace.Span` over the phase chain
(``trace.TRAIN_PHASES``)::

    data_wait -> h2d -> grad_accum -> step_compute -> ckpt_save

* ``data_wait`` — the loop thread blocked on the prefetch queue (input
  pipeline can't keep up when this dominates);
* ``h2d`` — the host->device upload (the pinned copy issued on the
  feed's side stream), measured ON the prefetch thread (it overlaps
  compute by design) and attributed to the consuming step via
  :meth:`Span.phase_add`;
* ``grad_accum`` — the host-side split of the batch into its
  microbatches when gradient accumulation is on (also measured on the
  prefetch thread; the microbatches' forward and backward are inside
  ``step_compute``);
* ``step_compute`` — the step's dispatch on the host (the eager forward,
  backward and update; the device runs behind it, and nothing here
  waits for it); the span is ACTIVE here, so a compile-like event
  (``observability/profile.py``: a kernel build) attributes to the
  exact step that paid it;
* ``ckpt_save`` — the checkpoint write when its trigger fires.

Per-phase durations feed :class:`LatencyWindow` percentile families —
``zoo_train_step_seconds{phase=...}`` summaries — and an opt-in
bounded step timeline (JSONL, atomic publish) for offline inspection.
Step spans also land in the flight recorder when one is configured,
so a postmortem shows the dead worker's final steps phase by phase.

Enablement: ``Trainer.enable_step_profiler()`` or the env contract
(``ZOO_STEP_PROFILE=1``, ``ZOO_STEP_TIMELINE=/path.jsonl``) read at
``fit`` entry.  Cost when off: one ``None`` check per step.  Cost when
on: a span and a few clock reads a step, and no host sync (the JAX
package's drill holds the profiled step rate at >= 0.95x).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .. import envcontract
from ..observability.metrics import (Family, LatencyWindow,
                                     summary_family)
from ..observability.trace import TRAIN_PHASES, Span

ENV_PROFILE = "ZOO_STEP_PROFILE"
ENV_TIMELINE = "ZOO_STEP_TIMELINE"

#: step entries per batched flight-recorder write (finish_step)
_FLUSH_EVERY = 32


def from_env() -> "Optional[StepProfiler]":
    """A profiler per the env contract, or None when not requested."""
    if not envcontract.env_flag(ENV_PROFILE) \
            and not envcontract.env_flag(ENV_TIMELINE):
        return None
    return StepProfiler(
        timeline_path=envcontract.env_str(ENV_TIMELINE))


class StepProfiler:
    """Per-phase aggregation + optional timeline for one trainer's fit
    loops (module docstring).

    Writes happen on the training loop thread; ``families()`` may be
    called from a scrape/snapshot thread — the windows are internally
    locked and the counters are GIL-atomic ints."""

    def __init__(self, timeline_path: Optional[str] = None,
                 window: int = 2048, timeline_cap: int = 4096):
        # compile attribution rides the profile hooks: with a profile
        # installed, a compile-like event while a step span is active
        # lands as an event ON that span
        from ..observability import profile as xla_profile
        try:
            xla_profile.install()
        except Exception:
            pass  # profiling works without compile attribution
        self.windows: Dict[str, LatencyWindow] = {
            p: LatencyWindow(window) for p in TRAIN_PHASES}
        self.timeline_path = timeline_path
        self.steps = 0
        self.compiles = 0
        self.compile_seconds = 0.0
        self._timeline: "deque[Dict[str, Any]]" = deque(maxlen=timeline_cap)
        self._tl_lock = threading.Lock()
        # step entries awaiting a batched flight-recorder flush
        # (single-writer: the training loop thread)
        self._pending: List[Dict[str, Any]] = []
        # the wrapped data iterator stashes the wait it measured here;
        # single-writer (the loop thread) by construction
        self.last_wait_s = 0.0

    # ------------------------------------------------------- loop hooks
    def timed_iter(self, it):
        """Wrap the device-batch iterator so the time the loop thread
        spends blocked in ``next()`` is captured as ``data_wait``.
        Plain generator — ``close()`` is forwarded by the caller
        closing the underlying iterator directly."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.last_wait_s = time.perf_counter() - t0
            yield item

    def begin_step(self, step: int, h2d_s: float,
                   accum_s: float = 0.0) -> Span:
        """Open the step span with the pre-measured cross-thread
        phases: the just-observed queue wait, the prefetch thread's
        upload for this batch, and (under gradient accumulation) its
        host-side microbatch split."""
        span = Span(None, "train_step", labels={"step": step})
        span.phase_add("data_wait", self.last_wait_s)
        span.phase_add("h2d", h2d_s)
        if accum_s:
            span.phase_add("grad_accum", accum_s)
        return span

    def finish_step(self, span: Span, step: int) -> None:
        """Close the span, fold its phases into the windows, append
        the timeline entry, and offer it to the flight recorder."""
        span.finish()
        totals = span.phase_totals()
        for phase, dur in totals.items():
            win = self.windows.get(phase)
            if win is not None:
                win.add(dur)
        compiles = [e for e in span.events
                    if e.get("name") == "backend_compile"]
        self.steps += 1
        entry = {"step": step,
                 **{f"{p}_ms": round(totals.get(p, 0.0) * 1e3, 4)
                    for p in TRAIN_PHASES},
                 "wall_ms": round(span.wall_s * 1e3, 4)}
        if compiles:
            compile_s = sum(float(e.get("seconds") or 0.0)
                            for e in compiles)
            self.compiles += len(compiles)
            self.compile_seconds += compile_s
            entry["compiles"] = len(compiles)
            entry["compile_ms"] = round(compile_s * 1e3, 3)
        with self._tl_lock:
            self._timeline.append(entry)
        from ..observability import flightrec
        rec = flightrec.current()
        if rec is not None:
            # rich phase entries are BATCHED (one framed write per
            # _FLUSH_EVERY steps): per-step write-through belongs to
            # the trainer's tiny hb liveness marker alone — a crash
            # loses at most this buffer of phase detail, never the
            # "last completed step"
            self._pending.append({"t": "step",
                                  "ts": round(time.time(), 6), **entry})
            if len(self._pending) >= _FLUSH_EVERY:
                self.flush(rec)

    def flush(self, rec=None) -> None:
        """Write buffered step entries to the flight recorder (the
        trainer also calls this at fit end so short fits lose
        nothing)."""
        if rec is None:
            from ..observability import flightrec
            rec = flightrec.current()
        pending, self._pending = self._pending, []
        if rec is not None and pending:
            rec.record_batch(pending)

    # -------------------------------------------------------- read side
    def snapshot(self) -> Dict[str, Any]:
        return {"steps": self.steps, "compiles": self.compiles,
                "compile_seconds": round(self.compile_seconds, 6),
                "phases": {p: w.snapshot()
                           for p, w in self.windows.items()
                           if w.count}}

    def families(self) -> List[Family]:
        """``zoo_train_step_seconds{phase=...}`` percentile summaries
        (one family; render merges the per-phase pieces) + compile
        attribution counters.  A registry/flight-recorder collector."""
        fams: List[Family] = []
        for phase, win in self.windows.items():
            fam = summary_family(
                "zoo_train_step_seconds",
                "per-phase training step seconds (stepprof taxonomy)",
                {"phase": phase}, win.snapshot())
            if fam is not None:
                fams.append(fam)
        fams.append(Family(
            "counter", "zoo_train_step_compiles_total",
            "compile-like events attributed to profiled training steps",
            [({}, self.compiles)]))
        return fams

    def timeline(self) -> List[Dict[str, Any]]:
        with self._tl_lock:
            return list(self._timeline)

    def write_timeline(self, path: Optional[str] = None) -> Optional[str]:
        """Publish the step timeline as JSONL (the shared
        tmp+fsync+atomic-rename discipline; the artifact is always
        complete).  No-op without a path."""
        path = path or self.timeline_path
        if not path:
            return None
        from ..observability.flightrec import atomic_write
        atomic_write(path, "".join(
            json.dumps(e, separators=(",", ":")) + "\n"
            for e in self.timeline()))
        return path
