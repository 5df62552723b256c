"""Fleet-wide distributed tracing: cross-process span stitching,
per-request time attribution, and the offline waterfall CLI.

Counterpart of ``analytics_zoo_tpu/observability/tracefleet.py``, with
the same summary wire form, leg shape, stitching rules and output keys;
it reads the port's flight-recorder files, whose layout is the JAX
package's.

One served request crosses at least two processes: the fleet router's
span (``route_pick`` -> ``worker_call``) and the worker registry's span
(``admission_queue`` -> ... -> ``execute``), and after a retry three.
Each process records its half (router: tracer ring; worker: tracer ring
and flight recorder); this module joins them.

**Inline stitching** (the hot half).  A worker reply to a request that
carried a ``trace_id`` piggybacks a compact summary of the worker-side
span (:func:`reply_trace`), and the router nests it under its open
``worker_call`` phase (:func:`nest_summary`).  The remainder of
``worker_call`` that the worker does not account for is the
*unattributed wire+queue gap* (:func:`inline_gap_ms`), surfaced as
``info["fleet_gap_ms"]``.

**Offline assembly** (the postmortem half)::

    python -m analytics_zoo_tpu_torch.observability.tracefleet \
        FLIGHT_DIR --router ring.json --trace ID

harvests every rank's flight-recorder span records (ALL incarnations: a
retried request's first leg lives in the incarnation that was
SIGKILLed), joins them with the router tracer ring (:func:`dump_ring`)
on ``trace_id``, aligns clocks through each rank's ``meta.json``
wall/monotonic anchor, and renders a waterfall.  ``--postmortem
pod_postmortem.json`` reads the rank spans out of a supervisor
postmortem instead.

Clock alignment: a rank's leg is placed at ``anchor.unix +
(span.start_mono_s - anchor.mono)``.  A leg that still lands outside its
``worker_call`` occurrence (clock skew) is shifted by the least
correction that fits it inside, and that correction is REPORTED per
``rank{r}.i{i}`` in ``skew_s``.

Attribution: ``attributed_fraction`` counts router phases other than
``worker_call``, every stitched leg's phase total, the named
``fleet_gap`` remainder of each stitched occurrence, and on a retried
request the failed (non-final) ``worker_call`` occurrence.  A missing
leg on a non-retried occurrence makes the trace ``partial`` and lowers
the fraction.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import flightrec
from . import trace as _trace_mod

#: the router phase a worker leg nests under
_SUMMARY_PHASE = "worker_call"
#: alignment tolerance: a leg within this of its occurrence counts as
#: fitting (same-host perf_counter/time() jitter, rounding in to_dict)
_EPS_MS = 1.0


# --------------------------------------------------------- inline half
def span_summary(span_dict: Dict[str, Any],
                 rank: Optional[int] = None,
                 inc: Optional[int] = None) -> Dict[str, Any]:
    """The compact piggyback form of a finished span dict: closed
    phases as ``[name, start_ms, dur_ms]`` triples plus the wall/mono
    anchors the stitcher aligns on.  Events, labels and the span name
    are dropped and floats are rounded to 1us — the full tree stays in
    the worker's ring/flight recorder; the reply carries only what
    per-request attribution needs, and every extra byte here is paid
    on the hot serve path."""
    phases = [[p.get("name"), round(p.get("start_ms") or 0.0, 3),
               round(p["dur_ms"], 3)]
              for p in (span_dict.get("phases") or ())
              if isinstance(p, dict) and p.get("dur_ms") is not None]
    wall = span_dict.get("wall_ms")
    unix = span_dict.get("start_unix_s")
    mono = span_dict.get("start_mono_s")
    out: Dict[str, Any] = {
        "tid": span_dict.get("trace_id"),
        "wall_ms": None if wall is None else round(wall, 3),
        "start_unix_s": None if unix is None else round(unix, 6),
        "start_mono_s": None if mono is None else round(mono, 6),
        "phases": phases,
    }
    if rank is not None:
        out["rank"] = rank
    if inc is not None:
        out["inc"] = inc
    return out


def summary_wire(span, rank: Optional[int] = None,
                 inc: Optional[int] = None) -> str:
    """The summary of a finished live :class:`Span` as ONE compact
    delimited string: ``tid|wall_ms|unix|mono|rank|inc|ph:s:d,...``
    (empty field = None).  A single string rides the binary wire as
    one leaf, with one format call per side instead of an envelope
    walk and dict rebuilds.  Built straight off the Span (no
    ``to_dict``)."""
    ph = ",".join(
        f"{n}:{(t0 - span.start_s) * 1e3:.3f}:{(t1 - t0) * 1e3:.3f}"
        for n, t0, t1 in span.phases if t1 is not None)
    return (f"{span.trace_id}|{span.wall_s * 1e3:.3f}|"
            f"{span.start_wall:.6f}|{span.start_s:.6f}|"
            f"{'' if rank is None else rank}|"
            f"{'' if inc is None else inc}|{ph}")


def parse_summary(wire: str) -> Optional[Dict[str, Any]]:
    """A :func:`summary_wire` string back into the summary-dict shape
    (:func:`span_summary`); None for anything malformed — the router
    must nest nothing rather than fail a request over a bad peer."""
    try:
        tid, wall, unix, mono, rank, inc, ph = wire.split("|")
        phases: List[List[Any]] = []
        if ph:
            for p in ph.split(","):
                name, start, dur = p.rsplit(":", 2)
                phases.append([name, float(start), float(dur)])
        out: Dict[str, Any] = {
            "tid": tid or None,
            "wall_ms": float(wall) if wall else None,
            "start_unix_s": float(unix) if unix else None,
            "start_mono_s": float(mono) if mono else None,
            "phases": phases,
            "_phase": _SUMMARY_PHASE,
        }
        if rank:
            out["rank"] = int(rank)
        if inc:
            out["inc"] = int(inc)
        return out
    except (ValueError, AttributeError):
        return None


# Span.to_dict renders raw wire-string children through this module's
# parser — registered at import, which every string-nesting process
# (the router) reaches via nest_summary itself
_trace_mod.set_child_decoder(parse_summary)


def reply_trace(tracer, trace_id: Optional[str],
                rank: Optional[int] = None,
                inc: Optional[int] = None) -> Optional[str]:
    """Worker-side piggyback builder: the wire
    summary of THIS request's just-finished registry span, or None
    when the request was untraced — the untraced reply pays one
    ``is None`` branch and nothing else."""
    if tracer is None or trace_id is None:
        return None
    span = tracer.find_span(trace_id)
    if span is None:
        return None
    return summary_wire(span, rank=rank, inc=inc)


def nest_summary(span, summary) -> None:
    """Router-side inline stitch: nest a reply's
    worker-span summary — the :func:`summary_wire` string, or an
    already-parsed dict — under the router span's ``worker_call``.
    A wire string is stored RAW (one object; parsed lazily at
    serialization, so a request allocates no parsed summary).  Tolerant of
    anything a peer sends: a missing or malformed piggyback nests
    nothing, never fails the request."""
    if span is None:
        return
    if isinstance(summary, str):
        if summary.count("|") == 6:  # shape sniff, no allocation
            span.add_child(summary)
        return
    if not isinstance(summary, dict):
        return
    span.add_child({**summary, "_phase": _SUMMARY_PHASE})


def inline_gap_ms(span) -> Optional[float]:
    """Per-request unattributed wire+queue gap: the span's total
    ``worker_call`` time minus the wall time its nested worker legs
    account for (>= 0; None when nothing is nested)."""
    children = getattr(span, "children", None)
    if not children:
        return None
    tot = span.phase_totals().get(_SUMMARY_PHASE)
    if tot is None:
        return None
    worker_ms = 0.0
    for ch in children:
        try:
            if isinstance(ch, str):
                # raw wire child: wall_ms is field 2 — one bounded
                # split, no full parse on the serve path
                worker_ms += float(ch.split("|", 2)[1])
            else:
                worker_ms += float(ch.get("wall_ms") or 0.0)
        except (TypeError, ValueError, IndexError):
            pass
    return round(max(tot * 1e3 - worker_ms, 0.0), 4)


# -------------------------------------------------------- offline half
def iter_rank_dirs(base_dir: str) -> List[Tuple[int, int, str]]:
    """Every ``rank{r}.i{i}`` recorder directory under ``base_dir`` —
    ALL incarnations, sorted — unlike :func:`flightrec.harvest`'s
    newest-incarnation policy: a retried request's first leg lives in
    the incarnation that died."""
    out: List[Tuple[int, int, str]] = []
    try:
        names = os.listdir(base_dir)
    except OSError:
        return out
    for name in names:
        if not name.startswith("rank") or ".i" not in name:
            continue
        try:
            rank_s, inc_s = name[4:].split(".i", 1)
            rank, inc = int(rank_s), int(inc_s)
        except ValueError:
            continue
        full = os.path.join(base_dir, name)
        if os.path.isdir(full):
            out.append((rank, inc, full))
    out.sort()
    return out


def harvest_legs(base_dir: str,
                 trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every span record under ``base_dir`` (optionally filtered to
    one ``trace_id``) as stitchable legs ``{rank, inc, anchor, span}``.
    Torn segment tails, missing directories, and anchor-less metas all
    degrade to fewer/less-aligned legs, never an exception."""
    legs: List[Dict[str, Any]] = []
    for rank, inc, d in iter_rank_dirs(base_dir):
        meta: Dict[str, Any] = {}
        try:
            with open(os.path.join(d, flightrec._META)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        anchor = meta.get("anchor")
        if not isinstance(anchor, dict):
            anchor = None
        records = (
            flightrec.read_records(os.path.join(d, flightrec._SEGMENT_OLD))
            + flightrec.read_records(os.path.join(d, flightrec._SEGMENT)))
        for r in records:
            if r.get("t") != "span":
                continue
            span = r.get("span")
            if not isinstance(span, dict):
                continue
            if trace_id is not None and span.get("trace_id") != trace_id:
                continue
            legs.append({"rank": rank, "inc": inc,
                         "anchor": anchor, "span": span})
    return legs


def legs_from_postmortem(pm: Dict[str, Any],
                         trace_id: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
    """Stitchable legs out of a supervisor postmortem's per-rank
    harvest — the source that survives when the SIGKILLed worker's
    directory itself is gone."""
    legs: List[Dict[str, Any]] = []
    for rank_s, rec in (pm.get("ranks") or {}).items():
        if not isinstance(rec, dict):
            continue
        meta = rec.get("meta") if isinstance(rec.get("meta"), dict) else {}
        anchor = meta.get("anchor")
        if not isinstance(anchor, dict):
            anchor = None
        try:
            rank: Any = int(rank_s)
        except (TypeError, ValueError):
            rank = rank_s
        inc = rec.get("incarnation", meta.get("incarnation", 0))
        for span in rec.get("spans") or ():
            if not isinstance(span, dict):
                continue
            if trace_id is not None and span.get("trace_id") != trace_id:
                continue
            legs.append({"rank": rank, "inc": inc,
                         "anchor": anchor, "span": span})
    return legs


def _summary_span(ch: Dict[str, Any]) -> Dict[str, Any]:
    """An inline piggyback summary re-shaped as a full span dict —
    the stitcher's fallback legs when the flight recorder is gone but
    the router span still carries its nested children."""
    return {"trace_id": ch.get("tid"), "name": ch.get("name"),
            "labels": dict(ch.get("labels") or {}),
            "start_unix_s": ch.get("start_unix_s"),
            "start_mono_s": ch.get("start_mono_s"),
            "wall_ms": ch.get("wall_ms"),
            "coverage": ch.get("coverage"),
            "phases": ch.get("phases") or []}


def legs_from_children(router_span: Dict[str, Any]
                       ) -> List[Dict[str, Any]]:
    return [{"rank": ch.get("rank"), "inc": ch.get("inc", 0),
             "anchor": None, "span": _summary_span(ch)}
            for ch in router_span.get("children") or ()
            if isinstance(ch, dict)]


def _phase_triples(phases) -> Iterator[Tuple[str, float, Optional[float]]]:
    """Normalize either phase shape — ``to_dict`` dicts or piggyback
    ``[name, start_ms, dur_ms]`` triples — skipping anything
    malformed."""
    for p in phases or ():
        if isinstance(p, dict):
            name, start, dur = p.get("name"), p.get("start_ms"), \
                p.get("dur_ms")
        elif isinstance(p, (list, tuple)) and len(p) >= 3:
            name, start, dur = p[0], p[1], p[2]
        else:
            continue
        if name is None or start is None:
            continue
        try:
            start = float(start)
        except (TypeError, ValueError):
            continue
        if dur is not None:
            try:
                dur = float(dur)
            except (TypeError, ValueError):
                dur = None
        yield str(name), start, dur


def _leg_abs_start(leg: Dict[str, Any]) -> Optional[float]:
    """Wall-clock start of a leg: the rank's meta anchor + the span's
    monotonic start when both exist (ONE trusted wall reading per
    incarnation), else the span's own wall stamp; None when the leg
    carries no time basis at all (it is then placed by fit alone and
    reports no skew)."""
    span = leg.get("span") or {}
    anchor = leg.get("anchor") or {}
    mono = span.get("start_mono_s")
    try:
        if mono is not None and "unix" in anchor and "mono" in anchor:
            return float(anchor["unix"]) \
                + (float(mono) - float(anchor["mono"]))
        unix = span.get("start_unix_s")
        return float(unix) if unix else None
    except (TypeError, ValueError):
        return None


def _fit_shift(leg_start_s: float, leg_dur_s: float,
               occ_start_s: float, occ_dur_s: float) -> float:
    """Minimal time shift (seconds) that places the leg inside the
    occurrence window; 0 when it already fits, the centering shift
    when the leg cannot fit (leg longer than the occurrence)."""
    lo = occ_start_s - leg_start_s
    hi = (occ_start_s + occ_dur_s) - (leg_start_s + leg_dur_s)
    if lo <= 0.0 <= hi:
        return 0.0
    if lo > hi:  # leg longer than occurrence: center it
        return (lo + hi) / 2.0
    return lo if lo > 0.0 else hi


def stitch(router_span: Optional[Dict[str, Any]],
           legs: List[Dict[str, Any]],
           trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Join one router span with its worker legs into a monotonic
    waterfall (module docstring for alignment and attribution rules).
    Degrades: no router half, no legs, torn legs, anchor-less metas
    all yield a ``partial`` trace, never an exception."""
    R = router_span if isinstance(router_span, dict) else {}
    wall_ms = float(R.get("wall_ms") or 0.0)
    labels = dict(R.get("labels") or {})
    retried = bool(labels.get("retried"))

    entries = []
    for leg in legs or ():
        if isinstance(leg, dict) and isinstance(leg.get("span"), dict):
            entries.append((_leg_abs_start(leg), leg))
    # timeless legs (no basis) sort last and are placed by fit alone
    entries.sort(key=lambda e: (e[0] is None, e[0] or 0.0))

    base = float(R.get("start_unix_s") or 0.0)
    if not R:
        timed = [s for s, _ in entries if s is not None]
        if timed:
            base = timed[0]

    rows: List[Dict[str, Any]] = []
    occs: List[Dict[str, Any]] = []
    attributed_ms = 0.0
    for name, start, dur in _phase_triples(R.get("phases")):
        if dur is None:  # open at finish: extend to span end
            dur = max(wall_ms - start, 0.0)
        rows.append({"src": "router", "phase": name,
                     "start_ms": round(start, 4),
                     "dur_ms": round(dur, 4)})
        if name == _SUMMARY_PHASE:
            occs.append({"start_ms": start, "dur_ms": dur,
                         "leg": None, "shift_s": 0.0})
        else:
            attributed_ms += dur

    # greedy time-order matching: each leg takes the free occurrence
    # it FITS (duration-wise) needing the smallest correction — the
    # fit test first, because under forged clocks every candidate
    # shift is ~the clock error and the leg must not be centered into
    # an occurrence shorter than itself when a fitting one is free
    # (two legs of a retried request land on their own occurrences)
    unmatched_legs: List[Dict[str, Any]] = []
    for start_abs, leg in entries:
        leg_dur_s = float((leg["span"].get("wall_ms") or 0.0)) / 1e3
        best = None
        best_key = (True, 0.0)
        best_shift = 0.0
        best_rel = 0.0
        for occ in occs:
            if occ["leg"] is not None:
                continue
            rel = ((start_abs - base) if start_abs is not None
                   else occ["start_ms"] / 1e3)
            shift = _fit_shift(rel, leg_dur_s,
                               occ["start_ms"] / 1e3,
                               occ["dur_ms"] / 1e3)
            fits = leg_dur_s <= occ["dur_ms"] / 1e3 + _EPS_MS / 1e3
            key = (not fits, abs(shift))
            if best is None or key < best_key:
                best, best_key = occ, key
                best_shift, best_rel = shift, rel
        if best is None:
            unmatched_legs.append(leg)
            continue
        best["leg"] = leg
        best["shift_s"] = best_shift
        best["leg_rel_s"] = best_rel
        best["timeless"] = start_abs is None

    gap_ms = 0.0
    skew: Dict[str, float] = {}
    monotonic = True
    stitched = 0
    missing = 0
    for i, occ in enumerate(occs):
        leg = occ["leg"]
        if leg is None:
            if retried and i < len(occs) - 1:
                # the failed leg of a retried request: the worker died
                # without replying — the router's own measurement of
                # that occurrence is the attribution
                rows.append({"src": "wire", "phase": "worker_call_failed",
                             "start_ms": round(occ["start_ms"], 4),
                             "dur_ms": round(occ["dur_ms"], 4)})
                attributed_ms += occ["dur_ms"]
            else:
                missing += 1
            continue
        stitched += 1
        span = leg["span"]
        shift = occ["shift_s"]
        if not occ.get("timeless") and abs(shift) > _EPS_MS / 1e3:
            key = f"rank{leg.get('rank')}.i{leg.get('inc', 0)}"
            if key not in skew or abs(shift) > abs(skew[key]):
                skew[key] = round(shift, 6)
        leg_start_ms = (occ["leg_rel_s"] + shift) * 1e3
        leg_wall = float(span.get("wall_ms") or 0.0)
        src = f"rank{leg.get('rank')}"
        leg_total = 0.0
        for name, start, dur in _phase_triples(span.get("phases")):
            if dur is None:
                continue
            rows.append({"src": src, "phase": name,
                         "start_ms": round(leg_start_ms + start, 4),
                         "dur_ms": round(dur, 4)})
            leg_total += dur
        attributed_ms += leg_total
        gap = max(occ["dur_ms"] - leg_wall, 0.0)
        gap_ms += gap
        attributed_ms += gap
        rows.append({"src": "wire", "phase": "fleet_gap",
                     "start_ms": round(occ["start_ms"], 4),
                     "dur_ms": round(gap, 4)})
        if leg_start_ms < occ["start_ms"] - _EPS_MS \
                or leg_start_ms + leg_wall \
                > occ["start_ms"] + occ["dur_ms"] + _EPS_MS:
            monotonic = False

    # legs that found no occurrence (router half missing, or more
    # legs than worker_call occurrences) still render — at their own
    # claimed offsets — so a router-less postmortem shows SOMETHING
    for leg in unmatched_legs:
        span = leg["span"]
        start_abs = _leg_abs_start(leg)
        leg_start_ms = 0.0 if start_abs is None \
            else (start_abs - base) * 1e3
        src = f"rank{leg.get('rank')}"
        for name, start, dur in _phase_triples(span.get("phases")):
            if dur is None:
                continue
            rows.append({"src": src, "phase": name,
                         "start_ms": round(leg_start_ms + start, 4),
                         "dur_ms": round(dur, 4)})
    rows.sort(key=lambda r: (r["start_ms"], -r["dur_ms"]))

    frac = min(attributed_ms / wall_ms, 1.0) if wall_ms > 0 else 0.0
    return {
        "trace_id": R.get("trace_id") or trace_id,
        "name": R.get("name"),
        "labels": labels,
        "start_unix_s": base,
        "wall_ms": wall_ms,
        "rows": rows,
        "occurrences": len(occs),
        "stitched_legs": stitched,
        "gap_ms": round(gap_ms, 4),
        "attributed_ms": round(attributed_ms, 4),
        "attributed_fraction": round(frac, 4),
        "skew_s": skew,
        "monotonic": monotonic,
        "partial": (not R) or missing > 0 or bool(unmatched_legs),
    }


def assemble(trace_id: str,
             router_spans: List[Dict[str, Any]],
             legs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One trace_id's stitched view from already-loaded sources.  The
    newest router span wins; with no flight-recorder legs, the router
    span's own inline children (when it has them) are the fallback."""
    R = None
    for sd in router_spans or ():
        if isinstance(sd, dict) and sd.get("trace_id") == trace_id:
            R = sd
    mine = [leg for leg in legs or ()
            if (leg.get("span") or {}).get("trace_id") == trace_id]
    if R is not None and not mine:
        mine = legs_from_children(R)
    return stitch(R, mine, trace_id=trace_id)


def dump_ring(tracer, path: str) -> str:
    """Persist a router tracer's ring + exemplar index as the CLI's
    ``--router`` input (atomic write; survives anything that happens
    to the router process afterwards)."""
    payload = {"written_unix": round(time.time(), 6),
               "spans": tracer.recent(),
               "exemplars": (tracer.exemplars()
                             if hasattr(tracer, "exemplars") else [])}
    flightrec.atomic_write(path, json.dumps(payload, default=str))
    return path


def load_router_spans(path: str) -> List[Dict[str, Any]]:
    """Router span dicts from a :func:`dump_ring` file, a bare JSON
    list of spans, or a ``GET /traces`` response body."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(data, list):
        return [d for d in data if isinstance(d, dict)]
    if isinstance(data, dict):
        spans = data.get("spans") or data.get("traces") or []
        return [d for d in spans if isinstance(d, dict)]
    return []


# --------------------------------------------------------------- render
def render_waterfall(st: Dict[str, Any], width: int = 44) -> str:
    labels = st.get("labels") or {}
    head = f"trace {st.get('trace_id')} {st.get('name') or '?'}"
    if labels.get("model"):
        head += f" model={labels['model']}"
    head += (f" wall={float(st.get('wall_ms') or 0.0):.2f}ms"
             f" attributed="
             f"{100.0 * float(st.get('attributed_fraction') or 0.0):.1f}%"
             f" gap={float(st.get('gap_ms') or 0.0):.2f}ms")
    if st.get("partial"):
        head += " PARTIAL"
    lines = [head]
    if st.get("skew_s"):
        lines.append("  clock skew corrected: " + ", ".join(
            f"{k}={v:+.3f}s" for k, v in sorted(st["skew_s"].items())))
    rows = st.get("rows") or []
    span_ms = max([float(st.get("wall_ms") or 0.0)]
                  + [r["start_ms"] + r["dur_ms"] for r in rows])
    for r in rows:
        if span_ms > 0:
            a = min(int(width * max(r["start_ms"], 0.0) / span_ms),
                    width - 1)
            b = max(int(round(width * r["dur_ms"] / span_ms)), 1)
            bar = "." * a + "#" * min(b, width - a)
        else:
            bar = ""
        lines.append(f"  {str(r['src']):>8}  {r['phase']:<22}"
                     f"{r['start_ms']:>10.2f} {r['dur_ms']:>9.2f}ms  "
                     f"{bar}")
    return "\n".join(lines)


def _join_index(router_spans: List[Dict[str, Any]],
                legs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    idx: Dict[str, Dict[str, Any]] = {}
    for sd in router_spans:
        tid = sd.get("trace_id")
        if tid:
            idx[tid] = {"trace_id": tid, "router": True, "legs": 0,
                        "ranks": set(),
                        "wall_ms": sd.get("wall_ms"),
                        "labels": sd.get("labels") or {}}
    for leg in legs:
        tid = (leg.get("span") or {}).get("trace_id")
        if not tid:
            continue
        row = idx.setdefault(tid, {"trace_id": tid, "router": False,
                                   "legs": 0, "ranks": set(),
                                   "wall_ms": None, "labels": {}})
        row["legs"] += 1
        row["ranks"].add(leg.get("rank"))
    out = list(idx.values())
    for row in out:
        row["ranks"] = sorted(r for r in row["ranks"] if r is not None)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.observability.tracefleet",
        description="Stitch one request's cross-process spans into a "
                    "waterfall: router tracer ring + per-rank flight-"
                    "recorder records, joined on trace_id, clocks "
                    "aligned via each rank's meta.json anchor")
    ap.add_argument("dir", nargs="?", default=None,
                    help="fleet flight-recorder dir "
                         "(ZOO_FLIGHTREC_DIR; rank{r}.i{i}/ layout)")
    ap.add_argument("--router", metavar="FILE", default=None,
                    help="router tracer ring dump "
                         "(tracefleet.dump_ring / GET /traces JSON)")
    ap.add_argument("--postmortem", metavar="FILE", default=None,
                    help="pod/worker postmortem JSON as the rank-span "
                         "source (works after SIGKILL, no live dir "
                         "needed)")
    ap.add_argument("--trace", metavar="ID", default=None,
                    help="trace_id to stitch (default: list joinable "
                         "traces)")
    ap.add_argument("--list", action="store_true",
                    help="list joinable trace_ids and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit the stitched trace as JSON")
    args = ap.parse_args(argv)
    if not args.dir and not args.postmortem:
        ap.error("need a flight-recorder DIR and/or --postmortem FILE")

    router_spans = load_router_spans(args.router) if args.router else []
    legs: List[Dict[str, Any]] = []
    if args.dir:
        legs.extend(harvest_legs(args.dir))
    if args.postmortem:
        try:
            with open(args.postmortem) as f:
                pm = json.load(f)
        except (OSError, ValueError) as e:
            print(f"unreadable postmortem: {e}", file=sys.stderr)
            return 2
        legs.extend(legs_from_postmortem(pm))

    if args.list or not args.trace:
        rows = _join_index(router_spans, legs)
        rows.sort(key=lambda r: (not r["router"], -r["legs"]))
        for row in rows[:64]:
            labels = row["labels"]
            print(f"{row['trace_id']}  router={'y' if row['router'] else 'n'}"
                  f"  legs={row['legs']} ranks={row['ranks']}"
                  + (f" wall={row['wall_ms']}ms"
                     if row["wall_ms"] is not None else "")
                  + (f" model={labels.get('model')}"
                     if labels.get("model") else ""))
        if len(rows) > 64:
            print(f"... {len(rows) - 64} more")
        if not rows:
            print("(no joinable spans found)")
        return 0

    st = assemble(args.trace, router_spans, legs)
    if args.json:
        print(json.dumps(st, indent=2, default=str))
    else:
        print(render_waterfall(st))
    return 0


if __name__ == "__main__":
    sys.exit(main())
