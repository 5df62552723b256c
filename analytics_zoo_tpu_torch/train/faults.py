"""Fault-tolerance environment contract: resume, heartbeat and fault
injection.

Counterpart of ``analytics_zoo_tpu/train/faults.py``: the process-level
contract that the supervising launcher (``launcher.py``) and the
training loop (``train/trainer.py``) share.

``ZOO_RESUME``
    Set by the supervisor on every relaunch of a crashed pod.  A
    ``Trainer.fit`` with a ``set_checkpoint`` directory restores the
    weights, optimizer state, step and epoch from the newest complete
    checkpoint and fast-forwards the data to the restored position.  No
    complete checkpoint: a cold start.
``ZOO_RESTART_COUNT``
    Which relaunch this incarnation is (1-based); informational.
``ZOO_HEARTBEAT_FILE``
    The worker's liveness file, touched (throttled) by the training
    loop at every step, from the training thread itself: a heartbeat
    thread would go on beating under a deadlocked loop, the very failure
    the supervisor's watchdog exists to catch.
``ZOO_CKPT_SYNC``
    Iteration-trigger checkpoints become synchronous, so a fault at step
    k finds every earlier checkpoint committed (the fault drill).

The injection hooks are one-shot per pod: they disarm when
``ZOO_RESUME`` is set, so a relaunched pod does not crash again at the
same step.

``ZOO_FAULT_CRASH_STEP`` / ``ZOO_FAULT_CRASH_RANK`` (default 1)
    SIGKILL this process after it completes the given step.
``ZOO_FAULT_HANG_STEP`` / ``ZOO_FAULT_HANG_RANK`` (default 1)
    Stop heartbeating after the given step (the watchdog's case).
``ZOO_FAULT_CORRUPT_TAG``
    After rank 0 commits this checkpoint tag, flip a byte of its own
    shard file: the commit's checksums convict the tag at restore.

The rank is the launcher's ``ZOO_TPU_PROCESS_ID``.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

from .. import envcontract

ENV_RESUME = "ZOO_RESUME"
ENV_RESTART_COUNT = "ZOO_RESTART_COUNT"
ENV_HEARTBEAT = "ZOO_HEARTBEAT_FILE"
ENV_CKPT_SYNC = "ZOO_CKPT_SYNC"
ENV_CRASH_STEP = "ZOO_FAULT_CRASH_STEP"
ENV_CRASH_RANK = "ZOO_FAULT_CRASH_RANK"
ENV_HANG_STEP = "ZOO_FAULT_HANG_STEP"
ENV_HANG_RANK = "ZOO_FAULT_HANG_RANK"
ENV_CORRUPT_TAG = "ZOO_FAULT_CORRUPT_TAG"

_HEARTBEAT_MIN_INTERVAL_S = 0.5

# refreshed from the environment by refresh(); cached so that the
# per-step hooks cost one load and a branch when nothing is armed
_hb_path: Optional[str] = None
_hb_last: float = 0.0
_crash_step: Optional[int] = None
_hang_step: Optional[int] = None


def _rank() -> int:
    return envcontract.env_int("ZOO_TPU_PROCESS_ID", 0)


def resume_requested() -> bool:
    return envcontract.env_flag(ENV_RESUME)


def sync_checkpoints() -> bool:
    return envcontract.env_flag(ENV_CKPT_SYNC)


def refresh() -> None:
    """Re-read the contract (``Trainer.fit`` calls this at entry, so the
    supervisor's environment, or a test's, takes effect whatever the
    import order)."""
    global _hb_path, _crash_step, _hang_step
    _hb_path = envcontract.env_str(ENV_HEARTBEAT)
    _crash_step = None
    _hang_step = None
    # the structured logger stamps rank and incarnation from the same
    # contract: re-read it alongside
    from ..observability import log as _log
    _log.refresh_identity()
    if resume_requested():
        return  # the hooks are one-shot: disarmed on a resumed pod
    rank = _rank()
    step = envcontract.env_str(ENV_CRASH_STEP)
    if step and rank == envcontract.env_int(ENV_CRASH_RANK, 1):
        _crash_step = int(step)
    step = envcontract.env_str(ENV_HANG_STEP)
    if step and rank == envcontract.env_int(ENV_HANG_RANK, 1):
        _hang_step = int(step)


def heartbeat() -> None:
    """Touch the supervisor's liveness file (throttled; a no-op unless
    the launcher set ``ZOO_HEARTBEAT_FILE``)."""
    global _hb_last
    if _hb_path is None:
        return
    now = time.monotonic()
    if now - _hb_last < _HEARTBEAT_MIN_INTERVAL_S:
        return
    _hb_last = now
    try:
        with open(_hb_path, "a"):
            os.utime(_hb_path, None)
    except OSError:
        pass  # liveness is best effort; never fail training for it


def maybe_fault(step: int) -> None:
    """The injected crash or hang at the given completed step."""
    if _crash_step is not None and step == _crash_step:
        # SIGKILL: no atexit, no flush, a torn in-flight checkpoint
        os.kill(os.getpid(), signal.SIGKILL)
    if _hang_step is not None and step == _hang_step:
        while True:  # no more heartbeats; only the watchdog ends this
            time.sleep(1.0)


def maybe_corrupt_shard(directory: str, tag) -> None:
    """Flip a byte in the middle of rank 0's shard file of ``tag``.
    Called only after the tag's commit is durable: corrupting before the
    digest would bake the bad bytes into the checksums."""
    if resume_requested():
        return
    want = envcontract.env_str(ENV_CORRUPT_TAG)
    if not want or str(tag) != want:
        return
    path = os.path.join(directory, f"ckpt_{tag}.shard-p0.npz")
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]) if byte else b"\xff")
    except OSError:
        pass
