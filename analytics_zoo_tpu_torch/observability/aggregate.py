"""Pod-level telemetry aggregation: N per-rank Prometheus snapshots in,
ONE pod scrape out.

Counterpart of ``analytics_zoo_tpu/observability/aggregate.py``, with
its merge rules and CLI; it reads either package's snapshots.

The cross-process half of the metrics plane: every worker's flight
recorder publishes atomic ``metrics.prom`` snapshots under the shared
``ZOO_FLIGHTREC_DIR`` (flightrec.py layout, ``rank{r}.i{i}/``); this
module merges them into a single exposition a Prometheus server (or a
serving router) can scrape from one place:

* every sample gains a ``rank`` label (a pre-existing ``rank`` label on
  a sample is preserved — the snapshot's own labeling wins);
* the same family name across snapshots merges into one ``# TYPE``
  block, with a type conflict raising rather than shipping an invalid
  exposition (the render-side rule, enforced here at parse time too);
* the same SERIES across a rank's incarnations follows metric
  semantics: **counters sum** (each restarted process restarts from 0,
  so the rank's true total is the sum over its incarnations) while
  **gauges last-write-win** (newest incarnation's value is the live
  one);
* counters additionally emit a **pod-total series** without the
  ``rank`` label — per-rank step counters sum to the pod total in the
  same scrape.

Summaries ride through per-rank (quantiles cannot be summed); their
``_sum``/``_count`` samples stay attached to the base family so the
output re-parses cleanly.

Also a CLI — the supervisor runs the same code in-process when it
writes ``pod_metrics.prom`` next to a postmortem::

    python -m analytics_zoo_tpu_torch.observability.aggregate DIR          # scrape
    python -m analytics_zoo_tpu_torch.observability.aggregate DIR --view   # stragglers
    python -m analytics_zoo_tpu_torch.observability.aggregate DIR --watch 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import (Family, parse_prometheus_text, render_prometheus)

#: the per-rank step counter (train/metrics.py) the straggler view keys
#: on
STEP_FAMILY = "zoo_train_steps_total"

_SUMMABLE = ("counter",)


def iter_snapshots(base_dir: str
                   ) -> List[Tuple[int, int, str]]:
    """``(rank, incarnation, path)`` for every snapshot under
    ``base_dir``: the flightrec layout (``rank{r}.i{i}/metrics.prom``)
    plus flat ``rank{r}.prom`` files workers may drop directly.
    Sorted by (rank, incarnation) so incarnation order — which the
    gauge last-write rule depends on — is deterministic."""
    out: List[Tuple[int, int, str]] = []
    try:
        names = os.listdir(base_dir)
    except OSError:
        return out
    for name in names:
        full = os.path.join(base_dir, name)
        if os.path.isdir(full) and name.startswith("rank") \
                and ".i" in name:
            try:
                rank_s, inc_s = name[4:].split(".i", 1)
                rank, inc = int(rank_s), int(inc_s)
            except ValueError:
                continue
            prom = os.path.join(full, "metrics.prom")
            if os.path.exists(prom):
                out.append((rank, inc, prom))
        elif name.startswith("rank") and name.endswith(".prom"):
            try:
                rank = int(name[4:-5])
            except ValueError:
                continue
            out.append((rank, 0, full))
    out.sort()
    return out


def rank_labeled(fams: Iterable[Family], rank: Any) -> List[Family]:
    """Stamp ``rank`` on every sample missing one — how a non-worker
    process (the fleet router scraping its own tracer) joins a pod
    exposition without colliding with either the per-rank worker
    series or the rank-less counter pod totals this module emits.
    A sample that already carries a rank keeps it (the snapshot's own
    labeling wins, same rule as :func:`merge_snapshots`)."""
    out: List[Family] = []
    for fam in fams:
        samples: List[Tuple] = []
        for s in fam.samples:
            labels = dict(s[0])
            labels.setdefault("rank", str(rank))
            samples.append((labels, *s[1:]))
        out.append(Family(fam.mtype, fam.name, fam.help, samples))
    return out


def _base_family(name: str, types: Dict[str, str]) -> Tuple[str, str]:
    """Resolve a sample name to its (family name, type): summary
    ``_sum``/``_count`` samples belong to their base family."""
    mtype = types.get(name)
    if mtype is not None:
        return name, mtype
    for suffix in ("_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            btype = types.get(base)
            if btype in ("summary", "histogram"):
                return base, btype
    return name, "untyped"


def merge_snapshots(parsed: Iterable[Tuple[int, Dict[str, Any]]]
                    ) -> List[Family]:
    """Merge already-parsed per-rank scrapes (``(rank, parsed)`` pairs
    in incarnation order) into one family list (module docstring for
    the merge semantics)."""
    # family -> {"mtype", "help", series: {(sample_name, labelkey): value}}
    fams: Dict[str, Dict[str, Any]] = {}
    totals: Dict[Tuple[str, str, Tuple], float] = {}
    for rank, p in parsed:
        types: Dict[str, str] = p.get("types", {})
        helps: Dict[str, str] = p.get("helps", {})
        for (name, labelkey), value in p.get("samples", {}).items():
            fam_name, mtype = _base_family(name, types)
            fam = fams.get(fam_name)
            if fam is None:
                fam = fams.setdefault(fam_name, {
                    "mtype": mtype, "help": helps.get(fam_name, ""),
                    "series": {}})
            elif fam["mtype"] != mtype and mtype != "untyped":
                if fam["mtype"] == "untyped":
                    fam["mtype"] = mtype
                else:
                    raise ValueError(
                        f"family {fam_name!r} collected as both "
                        f"{fam['mtype']} and {mtype} across snapshots")
            labels = dict(labelkey)
            labels.setdefault("rank", str(rank))
            key = (name, tuple(sorted(labels.items())))
            series = fam["series"]
            # sum/total decisions use the RESOLVED family type: a
            # snapshot that lost its # TYPE line (hand-dropped flat
            # files) must not demote an established counter to
            # last-write and fall out of the pod total
            resolved = fam["mtype"]
            if resolved in _SUMMABLE and key in series:
                series[key] += value  # counter across incarnations
            else:
                series[key] = value  # gauge/summary: last write wins
            if resolved in _SUMMABLE and "rank" not in dict(labelkey):
                # pod total, keyed by the rank-LESS label set (a sample
                # that already carried its own rank label has no
                # meaningful pod rollup)
                tkey = (fam_name, name, labelkey)
                totals[tkey] = totals.get(tkey, 0.0) + value
    out: List[Family] = []
    for fam_name in sorted(fams):
        fam = fams[fam_name]
        # histograms ride through untyped (Family has no histogram
        # mtype and nothing here emits one)
        mtype = (fam["mtype"] if fam["mtype"] in
                 ("counter", "gauge", "summary") else "untyped")
        samples: List[Tuple] = []
        for (name, labelkey), value in sorted(fam["series"].items()):
            samples.append((dict(labelkey), value, name))
        for (tfam, name, labelkey), value in sorted(totals.items()):
            if tfam == fam_name:
                # the pod total: the same family WITHOUT a rank label
                samples.append((dict(labelkey), value, name))
        out.append(Family(mtype, fam_name, fam["help"], samples))
    return out


def aggregate_files(entries: Iterable[Tuple[int, int, str]]
                    ) -> List[Family]:
    parsed: List[Tuple[int, Dict[str, Any]]] = []
    for rank, _inc, path in entries:
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue  # a snapshot mid-replace or a reaped worker's dir
        parsed.append((rank, parse_prometheus_text(text)))
    return merge_snapshots(parsed)


def aggregate_dir(base_dir: str) -> str:
    """The pod scrape: every snapshot under ``base_dir`` merged and
    rendered (empty exposition when there are none yet)."""
    fams = aggregate_files(iter_snapshots(base_dir))
    return render_prometheus(fams) if fams else "\n"


# ------------------------------------------------------- straggler view
def step_counts(base_dir: str) -> Dict[int, float]:
    """Per-rank completed-step totals (summed over incarnations) from
    the snapshots' ``zoo_train_steps_total``."""
    out: Dict[int, float] = {}
    for fam in aggregate_files(iter_snapshots(base_dir)):
        if fam.name != STEP_FAMILY:
            continue
        for s in fam.samples:
            labels = s[0]
            if "rank" in labels:
                try:
                    out[int(labels["rank"])] = float(s[1])
                except (TypeError, ValueError):
                    continue
    return out


def step_view(base_dir: str,
              prev: Optional[Dict[int, float]] = None,
              interval_s: Optional[float] = None) -> Dict[str, Any]:
    """A live step-rate / straggler summary: per-rank steps, step rate
    since the previous observation (when one is given), and each
    rank's lag behind the most advanced rank — the metrics plane's
    answer to "which worker is holding the pod back"."""
    counts = step_counts(base_dir)
    lead = max(counts.values()) if counts else 0.0
    ranks = {}
    for rank, steps in sorted(counts.items()):
        row: Dict[str, Any] = {"steps": steps, "lag": lead - steps}
        if prev is not None and interval_s and rank in prev:
            row["steps_per_s"] = round(
                max(steps - prev[rank], 0.0) / interval_s, 3)
        ranks[rank] = row
    stragglers = [r for r, row in ranks.items() if row["lag"] > 0]
    return {"ranks": ranks, "lead_steps": lead,
            "stragglers": stragglers, "counts": counts}


def _print_view(view: Dict[str, Any]) -> None:
    ranks = view["ranks"]
    if not ranks:
        print("(no snapshots yet)")
        return
    for rank, row in sorted(ranks.items()):
        rate = row.get("steps_per_s")
        print(f"rank {rank}: steps={row['steps']:.0f} "
              f"lag={row['lag']:.0f}"
              + (f" rate={rate}/s" if rate is not None else ""))
    if view["stragglers"]:
        print(f"stragglers: {view['stragglers']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.observability.aggregate",
        description="Merge per-rank Prometheus snapshots into one "
                    "pod-level scrape (flight-recorder layout)")
    ap.add_argument("dir", help="shared snapshot dir (ZOO_FLIGHTREC_DIR)")
    ap.add_argument("--out", default=None,
                    help="write the scrape here (atomically) instead "
                         "of stdout")
    ap.add_argument("--view", action="store_true",
                    help="print the per-rank step/straggler view "
                         "instead of the scrape")
    ap.add_argument("--watch", type=float, default=None, metavar="SEC",
                    help="repeat the step view every SEC seconds with "
                         "live step rates (Ctrl-C to stop)")
    ap.add_argument("--json", action="store_true",
                    help="emit the view as JSON (with --view)")
    args = ap.parse_args(argv)

    if args.watch:
        prev: Optional[Dict[int, float]] = None
        try:
            while True:
                view = step_view(args.dir, prev, args.watch)
                print(f"--- {time.strftime('%H:%M:%S')} ---")
                _print_view(view)
                prev = view["counts"]
                time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0

    if args.view:
        view = step_view(args.dir)
        if args.json:
            view.pop("counts", None)
            print(json.dumps(view, indent=2))
        else:
            _print_view(view)
        return 0

    text = aggregate_dir(args.dir)
    if args.out:
        from .flightrec import atomic_write
        atomic_write(args.out, text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
