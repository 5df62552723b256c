"""Crash-safe per-process flight recorder: the black box a supervisor
harvests after reaping a worker.

Counterpart of ``analytics_zoo_tpu/observability/flightrec.py``.  The
files keep that module's format byte for byte (the framing, the record
types, the layout, ``metrics.prom`` and ``meta.json``'s keys), so either
package harvests the other's; ``meta.json`` records the torch and CUDA
versions and the device's name where the JAX package records jax and
jaxlib.

The supervisor makes pod death survivable; this module makes it
explainable.  Everything the single-process observability stack knows (spans, metric
families, structured-log lines, per-step heartbeats) dies with the
process on SIGKILL — exactly the moment it is most needed.  The flight
recorder continuously lands a bounded tail of that state on disk under
a per-incarnation directory, with write disciplines chosen so a kill at
ANY byte offset never yields a torn or ambiguous record:

* **event segments** (``events.seg`` + one rotated predecessor) hold
  length-prefix + CRC32 framed JSON records appended in a single
  ``os.write`` — a reader stops at the first short or checksum-failing
  record, so the worst a mid-write SIGKILL costs is the record in
  flight (the checkpoint commit lesson applied to telemetry);
* **metric snapshots** (``metrics.prom``) are full Prometheus-text
  renders of the registered collectors, throttled and published
  tmp+atomic-rename (the commit-manifest discipline) — the file is
  always a complete, parseable scrape;
* **meta.json** (pid / rank / incarnation / versions / start time) is
  written once at open, same tmp+rename.

Record types: ``span`` (a finished :class:`~.trace.Span` as dict),
``log`` (a structured-log record), ``hb`` (per-training-step liveness:
``{ts, step}`` — the postmortem's "last completed step" and heartbeat
timeline come from these).

Layout under the shared base directory (one per pod, the supervisor
points every worker at it via ``ZOO_FLIGHTREC_DIR``)::

    <base>/rank0.i0/{meta.json, events.seg[.old], metrics.prom}
    <base>/rank1.i0/...
    <base>/rank1.i1/...          # incarnation 1 after a restart

The read side (:func:`harvest`, :func:`write_postmortem`) is pure
stdlib and never throws on torn/absent data — a postmortem of a pod
that never got as far as recording anything still names the failed
rank from supervisor-side evidence.

Cost model: one ``None`` check per hooked call site when no recorder
is configured; about a ``json.dumps`` and one ``os.write`` per record
when one is.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from . import log as log_mod
from . import trace as trace_mod
from .metrics import Family, process_info_family, render_prometheus
from .. import envcontract

#: shared pod directory; the supervising launcher exports this to every
#: worker (a pre-set value wins, so drills can harvest it themselves)
ENV_DIR = "ZOO_FLIGHTREC_DIR"

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
_SEGMENT = "events.seg"
_SEGMENT_OLD = "events.seg.old"
_METRICS = "metrics.prom"
_META = "meta.json"

_lock = threading.Lock()
_recorder: "Optional[FlightRecorder]" = None


def _env_int(name: str) -> int:
    """A declared variable as an int; unset or garbage ("", "stale")
    degrades to 0: telemetry identity must never crash a training job
    (the contract of log.refresh_identity)."""
    value = envcontract.env_str(name)
    if value:
        try:
            return int(value)
        except ValueError:
            return 0
    return 0


def _env_rank() -> int:
    return _env_int("ZOO_TPU_PROCESS_ID")


def _env_incarnation() -> int:
    return _env_int("ZOO_RESTART_COUNT")


def atomic_write(path: str, data: str) -> None:
    """tmp + fsync + atomic-rename: the file at ``path`` is always a
    complete previous or complete new version (shared by the recorder,
    the supervisor's postmortem artifacts, and the aggregator CLI)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


_atomic_write = atomic_write


class FlightRecorder:
    """One process's black box (module docstring).  Thread-safe: spans
    finish on dispatcher threads, logs come from anywhere, heartbeats
    from the training loop."""

    def __init__(self, base_dir: str, rank: Optional[int] = None,
                 incarnation: Optional[int] = None,
                 max_segment_bytes: int = 256 * 1024,
                 snapshot_interval_s: float = 2.0):
        self.rank = _env_rank() if rank is None else int(rank)
        self.incarnation = (_env_incarnation() if incarnation is None
                            else int(incarnation))
        self.dir = os.path.join(
            base_dir, f"rank{self.rank}.i{self.incarnation}")
        os.makedirs(self.dir, exist_ok=True)
        self.max_segment_bytes = int(max_segment_bytes)
        self.snapshot_interval_s = float(snapshot_interval_s)
        # RLock: _rotate_locked re-enters it lexically
        self._wlock = threading.RLock()
        self._seg_path = os.path.join(self.dir, _SEGMENT)
        # O_APPEND: every record lands in one write() at the tail even
        # if some other handle (a forked child) still points here
        self._fd = os.open(self._seg_path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            self._seg_bytes = os.fstat(self._fd).st_size
        except OSError:
            self._seg_bytes = 0
        # keyed by function identity (module+qualname): registering a
        # REPLACEMENT source — e.g. a fresh StepProfiler's bound
        # families — supersedes the old instance instead of
        # double-publishing the same series from a stale one
        self._collectors: Dict[Tuple[str, str],
                               Callable[[], Iterable[Family]]] = {
            ("flightrec", "process_info"):
                lambda: [process_info_family()]}
        self._snap_last = 0.0
        self._closed = False
        self._write_meta()

    # ------------------------------------------------------- write side
    def _write_meta(self) -> None:
        start_unix = time.time()
        meta: Dict[str, Any] = {
            "pid": os.getpid(), "rank": self.rank,
            "incarnation": self.incarnation,
            "start_unix": round(start_unix, 6),
            # wall/monotonic anchor, sampled back-to-back: spans
            # record perf_counter starts, so anchor.unix +
            # (span.start_mono_s - anchor.mono) places any of this
            # incarnation's spans on the wall clock with ONE
            # correction per rank — the trace stitcher's clock
            # alignment (observability/tracefleet.py)
            "anchor": {"unix": round(start_unix, 6),
                       "mono": round(time.perf_counter(), 6)}}
        try:
            import torch
            meta["torch"] = torch.__version__
            meta["cuda"] = torch.version.cuda or "none"
            # the device of a process that has used its card (asking an
            # uninitialised one would start a CUDA context here)
            meta["device"] = (
                torch.cuda.get_device_name(torch.cuda.current_device())
                if torch.cuda.is_available() and torch.cuda.is_initialized()
                else "cpu")
        except Exception:
            pass  # the black box works without them
        try:
            _atomic_write(os.path.join(self.dir, _META),
                          json.dumps(meta, default=str))
        except OSError:
            pass  # telemetry is best-effort; never fail the worker

    def _append(self, record: Dict[str, Any]) -> None:
        """Append one framed record (the hot path).
        A SIGKILL between the write and the disk is the reader's
        problem by design: the frame's length+CRC makes a torn tail
        detectable, never silently wrong."""
        self.record_batch((record,))

    def _rotate_locked(self) -> None:
        """Bound the on-disk tail to two segments (caller already
        holds the write lock — re-entered lexically).  The rename is
        atomic; a crash between steps loses at most the older
        segment.  A failed REOPEN kills the recorder rather than
        leave ``_fd`` naming a closed descriptor — a later write to a
        recycled fd number would corrupt whatever file reused it."""
        with self._wlock:
            os.close(self._fd)
            self._fd = -1
            try:
                os.replace(self._seg_path,
                           os.path.join(self.dir, _SEGMENT_OLD))
            except OSError:
                pass
            try:
                self._fd = os.open(
                    self._seg_path,
                    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                # replace may have failed above: size from the fd, not
                # an assumed-fresh 0, keeps the rotation bound honest
                self._seg_bytes = os.fstat(self._fd).st_size
            except OSError:
                self._closed = True

    def record_span(self, span_dict: Dict[str, Any]) -> None:
        self._append({"t": "span", "ts": round(time.time(), 6),
                      "span": span_dict})

    def record_log(self, record: Dict[str, Any]) -> None:
        # type tag LAST: a caller log field named "t" must lose to the
        # tag, not silently reclassify the record out of the log tail
        self._append({**record, "t": "log"})

    def record_step(self, step: int) -> None:
        """Per-training-step liveness marker: the postmortem's "last
        completed step" is the last one of these on disk."""
        self._append({"t": "hb", "ts": round(time.time(), 6),
                      "step": int(step)})

    def record(self, rtype: str, **fields: Any) -> None:
        """A generic typed record (e.g. the step profiler's compact
        per-step phase entry, ``t="step"``)."""
        self._append({"t": rtype, "ts": round(time.time(), 6),
                      **fields})

    def record_batch(self, records: Sequence[Dict[str, Any]]) -> None:
        """Append many records in ONE write: each record is framed
        individually (the reader sees no difference) but the syscall
        is amortized — the step profiler batches its per-step phase
        entries this way so the training loop's write-through cost
        stays with the tiny liveness marker alone."""
        if self._closed or not records:
            return
        frames = []
        for record in records:
            payload = json.dumps(record, default=str,
                                 separators=(",", ":")).encode("utf-8")
            frames.append(_HEADER.pack(
                len(payload), zlib.crc32(payload) & 0xffffffff) + payload)
        blob = b"".join(frames)
        with self._wlock:
            if self._closed:
                return
            try:
                os.write(self._fd, blob)
                self._seg_bytes += len(blob)
                if self._seg_bytes >= self.max_segment_bytes:
                    self._rotate_locked()
            except OSError:
                pass

    # ---------------------------------------------------- metric snaps
    def add_collector(self, fn: Callable[[], Iterable[Family]]) -> None:
        """Register a family source included in every snapshot.
        Keyed by the function's module+qualname, so re-registering is
        idempotent AND a new instance's bound method replaces its
        predecessor's."""
        key = (getattr(fn, "__module__", "") or "",
               getattr(fn, "__qualname__", "") or repr(fn))
        with self._wlock:
            self._collectors[key] = fn

    def snapshot_metrics(self, force: bool = False) -> bool:
        """Render the registered collectors to ``metrics.prom``
        (tmp+atomic-rename), throttled to ``snapshot_interval_s``
        unless forced.  Returns True when a snapshot was written."""
        now = time.monotonic()
        if not force and now - self._snap_last < self.snapshot_interval_s:
            return False
        self._snap_last = now
        with self._wlock:
            collectors = list(self._collectors.values())
        fams: List[Family] = []
        for fn in collectors:
            try:
                fams.extend(fn())
            except Exception:
                continue  # one broken source must not drop the scrape
        try:
            _atomic_write(os.path.join(self.dir, _METRICS),
                          render_prometheus(fams))
        except (OSError, ValueError):
            return False
        return True

    # -------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Final snapshot + release the segment fd (idempotent)."""
        if self._closed:
            return
        self.snapshot_metrics(force=True)
        with self._wlock:
            if self._closed:
                return
            self._closed = True
            try:
                os.close(self._fd)
            except OSError:
                pass


# ------------------------------------------------------------ process
def configure(base_dir: str, **kwargs: Any) -> FlightRecorder:
    """Open THE process recorder and hook it into the tracer finish
    path and the structured logger's tail.  Idempotent: an existing
    recorder is returned unchanged (one black box per process)."""
    global _recorder
    with _lock:
        if _recorder is not None:
            return _recorder
        rec = FlightRecorder(base_dir, **kwargs)
        _recorder = rec
    trace_mod.set_finish_hook(lambda span: rec.record_span(span.to_dict()))
    log_mod.set_tail_hook(rec.record_log)
    return rec


def current() -> "Optional[FlightRecorder]":
    return _recorder


def install_from_env() -> "Optional[FlightRecorder]":
    """Open the process recorder when ``ZOO_FLIGHTREC_DIR`` is set (the
    supervising launcher's contract); None (and zero cost later) when
    it is not."""
    if _recorder is not None:
        return _recorder
    base = envcontract.env_str(ENV_DIR)
    if not base:
        return None
    try:
        return configure(base)
    except OSError:
        return None  # unwritable dir: run without a black box


def shutdown() -> None:
    """Final snapshot, close the segment, unhook the trace/log sinks,
    and clear the process recorder (idempotent).  ``configure`` /
    ``install_from_env`` may open a fresh one afterwards."""
    global _recorder
    with _lock:
        rec, _recorder = _recorder, None
    trace_mod.set_finish_hook(None)
    log_mod.set_tail_hook(None)
    if rec is not None:
        rec.close()


_reset_for_tests = shutdown  # test-isolation alias


# ----------------------------------------------------------- read side
def read_records(path: str) -> List[Dict[str, Any]]:
    """Decode one segment file, stopping cleanly at the first torn
    record (short frame, CRC mismatch, or undecodable payload)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return out
    off, n = 0, len(data)
    while off + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(data, off)
        start = off + _HEADER.size
        end = start + length
        if end > n:
            break  # torn tail: the record in flight at the kill
        payload = data[start:end]
        if zlib.crc32(payload) & 0xffffffff != crc:
            break
        try:
            out.append(json.loads(payload.decode("utf-8")))
        except (ValueError, UnicodeDecodeError):
            break
        off = end
    return out


def _read_dir(d: str, tail: int) -> Dict[str, Any]:
    records = (read_records(os.path.join(d, _SEGMENT_OLD))
               + read_records(os.path.join(d, _SEGMENT)))
    # "step" records (the profiler's compact per-step entries) carry a
    # step field too — both kinds feed the liveness timeline.  Batched
    # step records land AFTER later write-through hb records, so
    # restore chronology and collapse the hb/step duplicate a profiled
    # step produces (dict keyed by step keeps the last occurrence)
    hbs = sorted((r for r in records if r.get("t") in ("hb", "step")),
                 key=lambda r: (r.get("ts") or 0.0))
    hbs = list({r.get("step"): r for r in hbs}.values())
    spans = [r.get("span") for r in records if r.get("t") == "span"]
    steps = [{k: v for k, v in r.items() if k != "t"}
             for r in records if r.get("t") == "step"]
    logs = [{k: v for k, v in r.items() if k != "t"}
            for r in records if r.get("t") == "log"]
    meta: Dict[str, Any] = {}
    try:
        with open(os.path.join(d, _META)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        pass
    metrics_path = os.path.join(d, _METRICS)
    out = {
        "meta": meta,
        "last_step": (int(hbs[-1]["step"]) if hbs else None),
        "heartbeats": [{"ts": h.get("ts"), "step": h.get("step")}
                       for h in hbs[-tail:]],
        "spans": spans[-tail:],
        "steps": steps[-tail:],
        "logs": logs[-tail:],
        "metrics_path": (metrics_path if os.path.exists(metrics_path)
                         else None),
    }
    return out


def harvest(base_dir: str, tail: int = 32) -> Dict[int, Dict[str, Any]]:
    """Read every rank's NEWEST incarnation directory under
    ``base_dir``.  Returns ``{rank: {meta, last_step, heartbeats,
    spans, logs, metrics_path, incarnations}}``; missing/torn data
    degrades to absent fields, never an exception."""
    found: Dict[int, List[int]] = {}
    try:
        names = os.listdir(base_dir)
    except OSError:
        return {}
    for name in names:
        if not name.startswith("rank") or ".i" not in name:
            continue
        try:
            rank_s, inc_s = name[4:].split(".i", 1)
            rank, inc = int(rank_s), int(inc_s)
        except ValueError:
            continue
        found.setdefault(rank, []).append(inc)
    out: Dict[int, Dict[str, Any]] = {}
    for rank, incs in sorted(found.items()):
        inc = max(incs)
        d = os.path.join(base_dir, f"rank{rank}.i{inc}")
        rec = _read_dir(d, tail)
        rec["incarnation"] = inc
        rec["incarnations"] = sorted(incs)
        out[rank] = rec
    return out


def write_postmortem(base_dir: str, out_path: str, *,
                     reason: str, failed_rank: Optional[int],
                     incarnation: int,
                     supervisor: Optional[Dict[int, Dict[str, Any]]] = None,
                     extra: Optional[Dict[str, Any]] = None,
                     tail: int = 32) -> Dict[str, Any]:
    """Harvest every worker's recorder and land ``pod_postmortem.json``
    (tmp+atomic-rename).  ``supervisor`` carries per-rank evidence only
    the supervisor has (exit rc, heartbeat-file age at reap) and is
    merged under each rank — so "why did rank 1 die" is answerable
    even when rank 1 never wrote a single record."""
    ranks: Dict[str, Dict[str, Any]] = {
        str(r): rec for r, rec in harvest(base_dir, tail=tail).items()}
    for r, sup in (supervisor or {}).items():
        ranks.setdefault(str(r), {}).update(sup)
    pm = {
        "reason": reason,
        "failed_rank": failed_rank,
        "incarnation": incarnation,
        "written_unix": round(time.time(), 6),
        **(extra or {}),
        "ranks": ranks,
    }
    _atomic_write(out_path, json.dumps(pm, indent=2, default=str))
    return pm
