"""End-to-end observability for the port's train and serve paths.

Counterpart of ``analytics_zoo_tpu/observability/``, with the same
public names, span phases, Prometheus families and on-disk formats:

* :mod:`.trace`: per-request :class:`Span`/:class:`Tracer` with explicit
  cross-thread handoff through the coalescer and the decode engine, a
  bounded ring buffer of recent traces, and per-phase aggregation;
* :mod:`.metrics`: the :class:`MetricsRegistry` (labeled counters and
  gauges, ``LatencyWindow``/``Counters``) with Prometheus text
  exposition and the stdlib round-trip parser;
* :mod:`.profile`: compile-like events (kernel builds, CUDA-graph
  captures), explicit transfers and live buffers as metrics and span
  events;
* :mod:`.log`: the structured JSON logger with request-id correlation,
  stamping ``rank``/``incarnation`` from the supervisor's env contract;
* :mod:`.flightrec`: the crash-safe per-process flight recorder the
  supervising launcher harvests into ``pod_postmortem.json``;
* :mod:`.aggregate`: per-rank Prometheus snapshots merged into one pod
  scrape (``python -m analytics_zoo_tpu_torch.observability.aggregate``).

The fleet's cross-process trace stitching (``tracefleet``) comes with
the fleet.
"""

from . import aggregate, flightrec, profile, trace
from .flightrec import FlightRecorder
from .log import StructuredLogger, get_logger
from .metrics import (Counters, Family, LatencyWindow, MetricsRegistry,
                      parse_prometheus_text, process_info_family,
                      render_prometheus, summary_family)
from .trace import (PHASES, TRAIN_PHASES, Span, Tracer, activate,
                    current_span)

__all__ = [
    "Counters", "Family", "FlightRecorder", "LatencyWindow",
    "MetricsRegistry", "PHASES", "Span", "StructuredLogger",
    "TRAIN_PHASES", "Tracer", "activate", "aggregate", "current_span",
    "flightrec", "get_logger", "parse_prometheus_text",
    "process_info_family", "profile", "render_prometheus",
    "summary_family", "trace",
]
