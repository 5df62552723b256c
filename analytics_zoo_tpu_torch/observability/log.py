"""Structured logging with request correlation: the way to log from
serving-hot and training-loop code.

Counterpart of ``analytics_zoo_tpu/observability/log.py``: the same
record fields, so one log pipeline reads both packages.

Why not plain ``logging``: a free-text line from the middle of the
dispatch path cannot be joined back to the request that produced it.
Records here are single-line JSON with a stable field set —
``ts``/``level``/``logger``/``msg`` plus caller fields — and the
current request's ``request_id`` (span trace id) attached
automatically, so one ``grep request_id`` yields the request's full
story across threads.  Under the supervisor env contract
(``ZOO_TPU_PROCESS_ID`` / ``ZOO_RESTART_COUNT``) every record also
auto-stamps ``rank`` and ``incarnation``, so a pod's merged log
stream stays attributable per worker after aggregation; records
additionally feed the flight recorder's tail when one is configured
(``observability/flightrec.py``).

Delivery still goes through the stdlib root machinery (one
``logging.Logger`` per name underneath), so existing handler/level
configuration keeps working::

    from analytics_zoo_tpu_torch.observability.log import get_logger
    slog = get_logger("zoo.serving")
    slog.info("dispatch", bucket=8, rows=5)
    # {"ts": ..., "level": "info", "logger": "zoo.serving",
    #  "msg": "dispatch", "request_id": "4f0c...", "bucket": 8, "rows": 5}
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, Optional

from . import trace
from .. import envcontract

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "critical": logging.CRITICAL}

# process identity stamped onto every record when the supervisor's env
# contract is present (ZOO_TPU_PROCESS_ID rank, ZOO_RESTART_COUNT
# incarnation): a pod's merged log stream stays attributable per worker.
# Cached; faults.refresh() re-reads it at Trainer.fit entry.
_identity: "Optional[Dict[str, int]]" = None

# flight-recorder tail sink (flightrec.configure): sees every record,
# including levels the stdlib handler config would drop — the black
# box wants the full tail, the console keeps its own thresholds.
_TAIL_HOOK = None


def refresh_identity() -> None:
    """Re-read the rank/incarnation env contract (called by
    ``train.faults.refresh`` so a supervisor-provided environment takes
    effect without import-order coupling)."""
    global _identity
    rank = envcontract.env_str("ZOO_TPU_PROCESS_ID")
    incarnation = envcontract.env_str("ZOO_RESTART_COUNT")
    ident: Dict[str, int] = {}
    # tolerate empty/garbage values (a stale `export ZOO_RESTART_COUNT=`
    # must degrade to no stamp, never crash every log call)
    try:
        if rank:
            ident["rank"] = int(rank)
        if incarnation:
            ident["incarnation"] = int(incarnation)
    except ValueError:
        pass
    _identity = ident


def set_tail_hook(fn) -> None:
    global _TAIL_HOOK
    _TAIL_HOOK = fn


class StructuredLogger:
    """JSON-lines logger bound to one name; see module docstring."""

    __slots__ = ("name", "_logger")

    def __init__(self, name: str):
        self.name = name
        self._logger = logging.getLogger(name)

    def _emit(self, level: str, msg: str, fields: Dict[str, Any]):
        lvl = _LEVELS[level]
        tail = _TAIL_HOOK
        enabled = self._logger.isEnabledFor(lvl)
        if not enabled and tail is None:
            return
        global _identity
        if _identity is None:
            refresh_identity()
        record: Dict[str, Any] = {
            "ts": round(time.time(), 6), "level": level,
            "logger": self.name, "msg": msg}
        record.update(_identity)
        span = trace.current_span()
        if span is not None:
            record["request_id"] = span.trace_id
        record.update(fields)
        if tail is not None:
            try:
                tail(record)
            except Exception:
                pass  # the black box must never fail the caller
        if enabled:
            self._logger.log(lvl, "%s",
                             json.dumps(record, default=str,
                                        separators=(",", ":")))

    def debug(self, msg: str, **fields: Any):
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields: Any):
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields: Any):
        self._emit("warning", msg, fields)

    def error(self, msg: str, **fields: Any):
        self._emit("error", msg, fields)

    def critical(self, msg: str, **fields: Any):
        self._emit("critical", msg, fields)


_loggers: Dict[str, StructuredLogger] = {}


def get_logger(name: Optional[str] = None) -> StructuredLogger:
    """The structured logger for ``name`` (cached per name)."""
    key = name or "analytics_zoo_tpu_torch"
    slog = _loggers.get(key)
    if slog is None:
        slog = _loggers.setdefault(key, StructuredLogger(key))
    return slog
