"""The ``ZOO_*`` environment-variable contract, in one place.

The port's copy of ``analytics_zoo_tpu/envcontract.py`` (the port
imports nothing of the JAX package): the same names, purposes and parse
rules, so one deployment's environment drives either package.  Every
``ZOO_*`` variable the port reads is declared in :data:`VARS` and read
through the accessors below; nothing else in the port touches
``os.environ`` for a ``ZOO_*`` name.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

# name -> one-line purpose: the single source of truth of the contract
VARS: Dict[str, str] = {
    "ZOO_TPU_COORDINATOR": "coordinator address (host:port) for multi-process torch.distributed init",
    "ZOO_TPU_NUM_PROCESSES": "process count for multi-process torch.distributed init",
    "ZOO_TPU_PROCESS_ID": "this process's rank in the pod (also stamps logs/metrics)",
    "ZOO_RESTART_COUNT": "supervisor-maintained incarnation counter for elastic restarts",
    "ZOO_RESUME": "flag: this incarnation is a restart and must resume from checkpoint",
    "ZOO_HEARTBEAT_FILE": "path the worker touches per step/loop for liveness detection",
    "ZOO_CKPT_SYNC": "flag: force synchronous (blocking) checkpoint saves",
    "ZOO_FAULT_CRASH_STEP": "fault drill: step at which the chosen rank hard-crashes",
    "ZOO_FAULT_CRASH_RANK": "fault drill: rank that crashes at ZOO_FAULT_CRASH_STEP",
    "ZOO_FAULT_HANG_STEP": "fault drill: step at which the chosen rank hangs",
    "ZOO_FAULT_HANG_RANK": "fault drill: rank that hangs at ZOO_FAULT_HANG_STEP",
    "ZOO_FAULT_CORRUPT_TAG": "fault drill: checkpoint tag to corrupt on save",
    "ZOO_FLIGHTREC_DIR": "directory for flight-recorder ring dumps and post-mortems",
    "ZOO_STEP_PROFILE": "flag: enable the per-step training profiler",
    "ZOO_STEP_TIMELINE": "path for the step profiler's JSON timeline dump",
    "ZOO_EXECSTORE_DIR": "root directory of the persistent executable store",
    "ZOO_EXECSTORE_BYTES": "byte budget for the executable store's LRU eviction",
    "ZOO_PAGER_RESIDENT": "worker pager residency budget (max resident models)",
    "ZOO_FLEET_WIRE": "fleet wire encoding override: 'json' disables binary frames",
    "ZOO_FLEET_MAX_FRAME": "max accepted fleet frame size in bytes (DoS guard)",
    "ZOO_TRACE_TAIL_Q": "tail-sampling retention quantile in (0,1) for exemplar traces (default 0.95; out-of-range disables)",
    "ZOO_TRACE_TAIL_CAP": "max tail-retained exemplar span trees per process (default 64)",
    "ZOO_TRAIN_STRATEGY": "default Trainer sharding strategy (replicate|fsdp|tp|fsdp_tp); constructor arg wins",
    "ZOO_TRAIN_ACCUM": "gradient-accumulation microbatches per optimizer step (default 1 = off)",
    "ZOO_TRAIN_DTYPE": "training compute dtype: 'bf16' enables mixed precision (f32 master weights); default full f32",
}


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw string value of a declared ``ZOO_*`` variable.  Empty
    values fall through to ``default``: an exported but empty variable
    means unset."""
    if name not in VARS:
        raise KeyError(f"undeclared env var {name!r}: add it to "
                       "envcontract.VARS (and the docs table)")
    return os.environ.get(name) or default


def env_int(name: str, default: int = 0) -> int:
    """Integer parse of a declared variable; unset, empty or not a
    number gives ``default`` (an operator's typo must not crash a
    worker)."""
    raw = env_str(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def env_flag(name: str) -> bool:
    """Any non-empty value is on."""
    return env_str(name) is not None
