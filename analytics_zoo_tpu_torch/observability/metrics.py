"""Unified metrics: primitives, a labeled registry, and Prometheus
text-format exposition with a stdlib round-trip parser.

Counterpart of ``analytics_zoo_tpu/observability/metrics.py``, with its
family names, label keys and text format, so one scrape, one parser and
the pod aggregator read both packages alike.  The one label that
differs: ``zoo_process_info`` carries the ``torch`` and ``cuda``
versions (``torch.version.cuda``, or ``"none"``) where the JAX package
carries ``jax`` and ``jaxlib``.

Three layers, smallest first:

* **primitives**: :class:`Counters` (a named bag of monotonic ints) and
  :class:`LatencyWindow` (sliding-window exact percentiles), shared by
  training, serving and tools;
* **:class:`MetricsRegistry`**: labeled counter/gauge families plus
  pluggable *collectors* (callables returning :class:`Family` lists at
  scrape time) for snapshot sources such as the tracer's phase
  aggregates and the profile hooks;
* **exposition**: ``render_prometheus()`` emits the Prometheus text
  format (``# HELP``/``# TYPE`` and escaped labels), and
  ``parse_prometheus_text()`` is the small stdlib parser every render
  round-trips through: a malformed label escape cannot ship unnoticed.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from .. import envcontract


# --------------------------------------------------------- primitives
class LatencyWindow:
    """Sliding window of the most recent N request latencies with
    percentile snapshots.

    A bounded deque, not a histogram: serving windows are small enough
    (default 2048 samples) that exact percentiles over the raw samples
    are cheaper and more faithful than bucket interpolation, and the
    window self-ages — a traffic spike's tail latencies wash out after
    N fresh requests instead of polluting a cumulative histogram
    forever.

    Percentiles are nearest-rank over the sorted window: the index is
    ``round(p/100 * (n-1))`` clamped into the window, so a single
    sample answers every percentile with itself and p0/p100 are the
    window min/max exactly.
    """

    def __init__(self, maxlen: int = 2048):
        self._samples: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._count = 0
        self._total_s = 0.0

    def add(self, seconds: float):
        with self._lock:
            self._samples.append(seconds)
            self._count += 1
            self._total_s += seconds

    @property
    def count(self) -> int:
        """Total samples ever added (not just the current window)."""
        with self._lock:
            return self._count

    def percentile(self, pct: float) -> Optional[float]:
        """Nearest-rank percentile over the current window, in SECONDS
        (None while empty).  The hedging threshold reads this directly
        — a full ``snapshot()`` per dispatched group would sort the
        window three times for two discarded quantiles."""
        with self._lock:
            data = sorted(self._samples)
        if not data:
            return None
        k = min(len(data) - 1,
                max(0, int(round((pct / 100.0) * (len(data) - 1)))))
        return data[k]

    def snapshot(self) -> Dict[str, Optional[float]]:
        with self._lock:
            data = sorted(self._samples)
            count, total = self._count, self._total_s

        def pick(pct):
            if not data:
                return None
            k = min(len(data) - 1,
                    max(0, int(round((pct / 100.0) * (len(data) - 1)))))
            return round(data[k] * 1e3, 3)

        return {"count": count,
                "mean_ms": (round(total / count * 1e3, 3)
                            if count else None),
                "total_s": round(total, 6),
                "p50_ms": pick(50), "p90_ms": pick(90),
                "p99_ms": pick(99),
                "window": len(data)}


class Counters:
    """A named bag of monotonically-increasing integers."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {n: 0 for n in names}

    def inc(self, name: str, by: int = 1):
        with self._lock:
            self._c[name] = self._c.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)


# ----------------------------------------------------------- registry
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Family:
    """One exposition family: metric type + name + help + samples.

    ``samples`` is a list of ``(labels_dict, value)`` pairs; for
    summaries a sample may override the sample name via a 3rd element
    (``name_sum`` / ``name_count`` ride in their base family).
    """

    __slots__ = ("mtype", "name", "help", "samples")

    def __init__(self, mtype: str, name: str, help: str,
                 samples: Sequence[Tuple]):
        if mtype not in ("counter", "gauge", "summary", "untyped"):
            raise ValueError(f"unknown metric type {mtype!r}")
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.mtype = mtype
        self.name = name
        self.help = help
        self.samples = list(samples)


def summary_family(name: str, help: str, labels: Dict[str, Any],
                   window_snapshot: Dict[str, Optional[float]]
                   ) -> Optional[Family]:
    """A Prometheus summary from a :class:`LatencyWindow` snapshot
    (quantile samples in SECONDS + ``_sum``/``_count``); None when the
    window has seen nothing."""
    count = window_snapshot.get("count") or 0
    if not count:
        return None
    samples: List[Tuple] = []
    for q, key in (("0.5", "p50_ms"), ("0.9", "p90_ms"),
                   ("0.99", "p99_ms")):
        v = window_snapshot.get(key)
        if v is not None:
            samples.append(({**labels, "quantile": q}, v / 1e3))
    total_s = window_snapshot.get("total_s")
    if total_s is None:  # older snapshots: reconstruct from the mean
        mean_ms = window_snapshot.get("mean_ms") or 0.0
        total_s = mean_ms * count / 1e3
    samples.append((dict(labels), total_s, name + "_sum"))
    samples.append((dict(labels), count, name + "_count"))
    return Family("summary", name, help, samples)


class _Child:
    """One labeled time series of a counter/gauge family."""

    __slots__ = ("_family", "labels", "_value", "_callback")

    def __init__(self, family: "_LabeledFamily", labels: Dict[str, str]):
        self._family = family
        self.labels = labels
        self._value = 0.0
        self._callback: Optional[Callable[[], float]] = None

    def inc(self, by: float = 1.0):
        if self._family.mtype == "gauge":
            pass  # gauges may inc too
        elif by < 0:
            raise ValueError("counters only go up")
        with self._family._lock:
            self._value += by

    def set(self, value: float):
        if self._family.mtype != "gauge":
            raise TypeError("set() is gauge-only — counters only go up")
        with self._family._lock:
            self._value = float(value)
            self._callback = None

    def set_fn(self, fn: Callable[[], float]):
        """Lazy gauge: ``fn`` is called at scrape time (live-buffer
        counts, queue depths — values that exist, not accumulate)."""
        if self._family.mtype != "gauge":
            raise TypeError("set_fn() is gauge-only")
        self._callback = fn

    def get(self) -> float:
        if self._callback is not None:
            try:
                return float(self._callback())
            except Exception:
                return float("nan")
        with self._family._lock:
            return self._value


class _LabeledFamily:
    """A counter/gauge family: ``labels(**l)`` returns the per-series
    child (created on first use); label-less use goes through the
    default child."""

    def __init__(self, mtype: str, name: str, help: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.mtype = mtype
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], _Child] = {}

    def labels(self, **labels: Any) -> _Child:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self, dict(key))
                self._children[key] = child
            return child

    # label-less convenience
    def inc(self, by: float = 1.0):
        self.labels().inc(by)

    def set(self, value: float):
        self.labels().set(value)

    def set_fn(self, fn: Callable[[], float]):
        self.labels().set_fn(fn)

    def get(self, **labels: Any) -> float:
        return self.labels(**labels).get()

    def family(self) -> Family:
        with self._lock:
            children = list(self._children.values())
        return Family(self.mtype, self.name, self.help,
                      [(c.labels, c.get()) for c in children])


_PROCESS_START_UNIX = round(time.time(), 3)
_versions_cache: Optional[Dict[str, str]] = None


def _runtime_versions() -> Dict[str, str]:
    """torch and CUDA versions, resolved once (``"none"`` for a CPU-only
    build's CUDA)."""
    global _versions_cache
    if _versions_cache is None:
        import torch
        _versions_cache = {"torch": torch.__version__,
                           "cuda": torch.version.cuda or "none"}
    return _versions_cache


def process_info_family() -> Family:
    """``zoo_process_info``: the info gauge (constant 1, identity in the
    labels) every process exports by default: pid, pod rank and
    supervisor incarnation (the env contract), torch and CUDA versions,
    and the process start time.  The pod aggregator joins per-rank
    scrapes on it."""
    versions = _runtime_versions()
    labels = {
        "pid": str(os.getpid()),
        "rank": envcontract.env_str("ZOO_TPU_PROCESS_ID", "0"),
        "incarnation": envcontract.env_str("ZOO_RESTART_COUNT", "0"),
        "torch": versions["torch"],
        "cuda": versions["cuda"],
        "start_unix": str(_PROCESS_START_UNIX),
    }
    return Family("gauge", "zoo_process_info",
                  "process identity info-gauge (labels carry the data)",
                  [(labels, 1.0)])


class MetricsRegistry:
    """The process-wide metric surface: owned counter/gauge families
    plus scrape-time collectors (module docstring).  Every registry
    exports ``zoo_process_info`` by default (``process_info=False``
    opts out) — the aggregator's join key must exist before anyone
    thinks to register it."""

    def __init__(self, process_info: bool = True):
        self._lock = threading.Lock()
        self._families: Dict[str, _LabeledFamily] = {}
        self._collectors: List[Callable[[], Iterable[Family]]] = []
        if process_info:
            self._collectors.append(lambda: [process_info_family()])

    def counter(self, name: str, help: str = "") -> _LabeledFamily:
        return self._family("counter", name, help)

    def gauge(self, name: str, help: str = "") -> _LabeledFamily:
        return self._family("gauge", name, help)

    def _family(self, mtype: str, name: str, help: str) -> _LabeledFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.mtype != mtype:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.mtype}, not {mtype}")
                return fam
            fam = _LabeledFamily(mtype, name, help)
            self._families[name] = fam
            return fam

    def register_collector(self, fn: Callable[[], Iterable[Family]]):
        """``fn()`` runs at every scrape and returns Family objects —
        the adapter for snapshot-oriented sources (registry metrics,
        tracer aggregates, XLA profile counters)."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> List[Family]:
        with self._lock:
            fams = [f.family() for f in self._families.values()]
            collectors = list(self._collectors)
        for fn in collectors:
            fams.extend(fn())
        return fams

    def render_prometheus(self) -> str:
        return render_prometheus(self.collect())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every family (the non-Prometheus side of
        the same data)."""
        out: Dict[str, Any] = {}
        for fam in self.collect():
            series = []
            for s in fam.samples:
                labels, value = s[0], s[1]
                name = s[2] if len(s) > 2 else fam.name
                series.append({"name": name, "labels": dict(labels),
                               "value": value})
            out[fam.name] = {"type": fam.mtype, "help": fam.help,
                             "series": series}
        return out


# --------------------------------------------------------- exposition
def _escape_label_value(v: str) -> str:
    return (v.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v: Any) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(families: Iterable[Family]) -> str:
    """Prometheus text exposition format 0.0.4.  Families render in
    name order; every line is guaranteed to round-trip through
    :func:`parse_prometheus_text`.

    Same-named families (e.g. one per model from independent
    collectors) are MERGED into one ``# TYPE`` block — real Prometheus
    parsers hard-reject duplicate TYPE lines, and our own lenient
    parser would never catch them; conflicting types for one name
    raise instead of shipping an invalid exposition."""
    merged: Dict[str, Family] = {}
    for fam in families:
        seen = merged.get(fam.name)
        if seen is None:
            merged[fam.name] = Family(fam.mtype, fam.name, fam.help,
                                      fam.samples)
        elif seen.mtype != fam.mtype:
            raise ValueError(
                f"metric {fam.name!r} collected as both "
                f"{seen.mtype} and {fam.mtype}")
        else:
            seen.samples.extend(fam.samples)
    lines: List[str] = []
    for fam in sorted(merged.values(), key=lambda f: f.name):
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.mtype}")
        for s in fam.samples:
            labels, value = s[0], s[1]
            name = s[2] if len(s) > 2 else fam.name
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{body}}} {_fmt_value(value)}")
            else:
                lines.append(f"{name} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?[0-9]+))?\s*$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|summary|histogram|untyped)$")
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")


def _parse_labels(body: str, line: str) -> Dict[str, str]:
    """Parse ``k="v",k2="v2"`` honoring backslash escapes."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        m = re.match(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"', body[i:])
        if not m:
            raise ValueError(
                f"unparseable exposition line (bad label segment at "
                f"offset {i}): {line!r}")
        key = m.group(1)
        i += m.end()
        out: List[str] = []
        while i < n:
            ch = body[i]
            if ch == "\\":
                if i + 1 >= n:
                    raise ValueError(
                        f"unparseable exposition line (dangling escape)"
                        f": {line!r}")
                nxt = body[i + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt))
                if out[-1] is None:
                    raise ValueError(
                        f"unparseable exposition line (bad escape "
                        f"\\{nxt}): {line!r}")
                i += 2
            elif ch == '"':
                i += 1
                break
            else:
                out.append(ch)
                i += 1
        else:
            raise ValueError(
                f"unparseable exposition line (unterminated label "
                f"value): {line!r}")
        labels[key] = "".join(out)
        rest = body[i:].lstrip()
        if rest.startswith(","):
            i = n - len(rest) + 1
        elif rest:
            raise ValueError(
                f"unparseable exposition line (junk after label "
                f"value): {line!r}")
        else:
            break
    return labels


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """The tiny stdlib parser the smoke gate round-trips the exposition
    through.  Returns ``{"samples": {(name, ((k,v),...)): value},
    "types": {...}, "helps": {...}}``; raises ``ValueError`` on any
    line that is not a valid comment, TYPE/HELP line, or sample."""
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line.strip():
            continue
        if line.startswith("#"):
            tm = _TYPE_RE.match(line)
            if tm:
                types[tm.group(1)] = tm.group(2)
                continue
            hm = _HELP_RE.match(line)
            if hm:
                helps[hm.group(1)] = hm.group(2)
                continue
            if line.startswith("# TYPE") or line.startswith("# HELP"):
                raise ValueError(
                    f"unparseable exposition line (malformed TYPE/HELP)"
                    f": {line!r}")
            continue  # free-form comment: legal, meaningless
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = (_parse_labels(m.group("labels"), line)
                  if m.group("labels") else {})
        value_s = m.group("value")
        try:
            value = float(value_s)
        except ValueError:
            if value_s in ("+Inf", "-Inf", "NaN"):
                value = float(value_s.replace("Inf", "inf")
                              .replace("NaN", "nan"))
            else:
                raise ValueError(
                    f"unparseable exposition line (bad value "
                    f"{value_s!r}): {line!r}")
        key = (m.group("name"), tuple(sorted(labels.items())))
        samples[key] = value
    return {"samples": samples, "types": types, "helps": helps}
