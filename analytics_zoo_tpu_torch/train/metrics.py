"""Training-side counters: steps, restarts, and checkpoint saves,
commits and restores.

Counterpart of ``analytics_zoo_tpu/train/metrics.py``: process-local
counters (the supervisor and each worker count their own process's
events).  ``snapshot`` reads them as a dict; the launcher writes it into
its ``--summary-json``.  ``train_families``, which renders them as
Prometheus families, waits for the port's ``observability/metrics.py``
(see ROADMAP.md).

* steps: completed ``Trainer.fit`` steps;
* restarts by reason: ``exit`` (a worker exited non-zero), ``watchdog``
  (a stale heartbeat; the worker was SIGKILLed), ``port`` (the
  coordinator's port race, retried on a fresh port);
* checkpoint saves by format (``flat``, ``sharded``), commits, and
  restores by outcome (``ok``, ``corrupt_discarded``, ``cold_start``).
"""

from __future__ import annotations

import threading
from typing import Dict

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
