"""Training-side counters: steps, restarts, and checkpoint saves,
commits and restores.

Counterpart of ``analytics_zoo_tpu/train/metrics.py``: process-local
counters (the supervisor and each worker count their own process's
events).  ``snapshot`` reads them as a dict; the launcher writes it into
its ``--summary-json``.  :func:`train_families` renders them as
Prometheus families (a ``MetricsRegistry`` collector; the flight
recorder snapshots them):

``zoo_train_steps_total``
    Worker-side: completed ``Trainer.fit`` steps; the pod aggregator's
    join and straggler key (per-rank series sum to the pod total).
``zoo_train_restarts_total{reason}``
    Supervisor-side: pod relaunches, by reason: ``exit`` (a worker
    exited non-zero), ``watchdog`` (a stale heartbeat; the worker was
    SIGKILLed), ``port`` (the coordinator's port race, retried on a
    fresh port).
``zoo_ckpt_saves_total{format}``
    Worker-side: checkpoint writes, by format (``flat``, ``sharded``).
``zoo_ckpt_commits_total``
    Worker-side (rank 0): commit manifests written.
``zoo_ckpt_restores_total{outcome}``
    Worker-side: ``ok``, ``corrupt_discarded`` (a tag failed its commit
    checksums and was deleted) or ``cold_start`` (a resume was asked
    for and no complete checkpoint existed).
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ..observability.metrics import Family

_lock = threading.Lock()
_restarts: Dict[str, int] = {}
_saves: Dict[str, int] = {}
_restores: Dict[str, int] = {}
_commits: int = 0
_steps: int = 0


def record_restart(reason: str) -> None:
    with _lock:
        _restarts[reason] = _restarts.get(reason, 0) + 1


def record_step() -> None:
    global _steps
    with _lock:
        _steps += 1


def record_ckpt_save(fmt: str) -> None:
    with _lock:
        _saves[fmt] = _saves.get(fmt, 0) + 1


def record_ckpt_commit() -> None:
    global _commits
    with _lock:
        _commits += 1


def record_ckpt_restore(outcome: str) -> None:
    with _lock:
        _restores[outcome] = _restores.get(outcome, 0) + 1


def snapshot() -> Dict[str, Dict[str, int]]:
    with _lock:
        return {"restarts": dict(_restarts), "ckpt_saves": dict(_saves),
                "ckpt_commits": _commits, "ckpt_restores": dict(_restores),
                "steps": _steps}


def reset() -> None:
    """Zero every counter (tests)."""
    global _commits, _steps
    with _lock:
        _restarts.clear()
        _saves.clear()
        _restores.clear()
        _commits = 0
        _steps = 0


def train_families() -> List[Family]:
    """Current counters as exposition families (a registry collector)."""
    with _lock:
        fams = []
        if _steps:
            fams.append(Family(
                "counter", "zoo_train_steps_total",
                "Completed training steps in this process",
                [({}, _steps)]))
        if _restarts:
            fams.append(Family(
                "counter", "zoo_train_restarts_total",
                "Supervised pod relaunches by reason",
                [({"reason": r}, v) for r, v in sorted(_restarts.items())]))
        if _saves:
            fams.append(Family(
                "counter", "zoo_ckpt_saves_total",
                "Checkpoint writes by on-disk format",
                [({"format": f}, v) for f, v in sorted(_saves.items())]))
        if _commits:
            fams.append(Family(
                "counter", "zoo_ckpt_commits_total",
                "Checkpoint commit manifests durably written",
                [({}, _commits)]))
        if _restores:
            fams.append(Family(
                "counter", "zoo_ckpt_restores_total",
                "Checkpoint restore attempts by outcome",
                [({"outcome": o}, v) for o, v in sorted(_restores.items())]))
        return fams
