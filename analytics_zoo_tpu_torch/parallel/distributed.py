"""Multi-process execution: the ``torch.distributed`` bootstrap from the
launcher's environment contract.

Counterpart of ``analytics_zoo_tpu/parallel/distributed.py``.  The
launcher (``launcher.py``) sets, for every process of a pod:

  ZOO_TPU_COORDINATOR   host:port of process 0
  ZOO_TPU_NUM_PROCESSES number of processes
  ZOO_TPU_PROCESS_ID    this process's rank

and :func:`maybe_initialize_distributed` joins the process group from
them: ``nccl`` when the model lives on a CUDA device (one card a rank),
``gloo`` on the CPU.  ``process_count``, ``process_index`` and
``is_coordinator`` read the group (1, 0 and True in one process), and
:func:`barrier` is the pod barrier of the sharded checkpoint and of
``fit``'s end.  In the port every rank holds every parameter whole;
``put_global`` and ``local_rows`` (batches assembled across processes)
wait for the parallel strategies (see ROADMAP.md).
"""

from __future__ import annotations

import logging
from datetime import timedelta

import torch

from .. import envcontract

log = logging.getLogger("analytics_zoo_tpu_torch")

ENV_COORD = "ZOO_TPU_COORDINATOR"
ENV_NPROC = "ZOO_TPU_NUM_PROCESSES"
ENV_PID = "ZOO_TPU_PROCESS_ID"


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def _initialized() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


def cluster_env_present() -> bool:
    """True when the launcher's multi-process variables are set."""
    return bool(envcontract.env_str(ENV_COORD)
                or envcontract.env_str(ENV_NPROC))


def maybe_initialize_distributed(device=None,
                                 timeout_s: float = 300.0) -> bool:
    """Join the pod's process group when the contract's variables are
    set (``nccl`` for a CUDA ``device``, else ``gloo``).  Returns True
    when this process is part of a multi-process group after the
    call."""
    if _initialized():
        return True
    if not cluster_env_present():
        return False
    dist = _dist()
    coord = envcontract.env_str(ENV_COORD)
    nproc = envcontract.env_int(ENV_NPROC, 1)
    pid = envcontract.env_int(ENV_PID, 0)
    if not coord:
        raise RuntimeError(f"{ENV_NPROC} is set but {ENV_COORD} is not")
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coord}",
                            world_size=nproc, rank=pid,
                            timeout=timedelta(seconds=timeout_s))
    log.info("torch.distributed: process %d/%d (%s)", pid, nproc,
             dist.get_backend())
    # the first liveness touch at the join: the supervisor's watchdog
    # then covers the first step's warm-up too
    from ..train import faults
    faults.refresh()
    faults.heartbeat()
    return True


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def barrier(name: str = "") -> None:
    """Wait for every process of the group (a no-op in one process).
    Called from the main thread by every process."""
    if process_count() > 1:
        _dist().barrier()
