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
``fit``'s end.  :func:`put_global` assembles a global (DTensor) batch
from every rank's local rows and :func:`local_rows` gives a rank its own
rows of one back.
"""

from __future__ import annotations

import atexit
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


def shutdown_at_exit() -> None:
    """Leave the process group when the interpreter exits: a barrier
    (every rank done communicating), then ``destroy_process_group``.  A
    rank that tears its gloo group down while a peer still talks to it
    can abort at exit (``terminate called without an active
    exception``), which a supervisor reads as a crash.  After an
    uncaught exception the barrier is skipped: the peers may never reach
    it."""
    import sys
    failed = []
    previous = sys.excepthook

    def excepthook(*exc):
        failed.append(True)
        previous(*exc)

    def shutdown():
        if not _initialized():
            return
        if not failed and process_count() > 1:
            try:
                _dist().barrier()
            except RuntimeError as e:  # a peer gone, or the timeout
                log.warning("barrier at exit failed: %s", e)
        _dist().destroy_process_group()

    sys.excepthook = excepthook
    atexit.register(shutdown)


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
    shutdown_at_exit()
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


def put_global(a, sharding, batch_sharded: bool = True, batch_dim: int = 0):
    """A DTensor on ``sharding.mesh`` from this rank's local data.

    ``batch_sharded``: ``a`` is this rank's block of the global batch
    along ``batch_dim`` (the block of its data shard,
    ``mesh.data_index``), and the global tensor is the ranks' blocks in
    data-shard order, split as ``sharding.spec`` says (``data_sharding``:
    dim 0 over the data axes; for the (accum, micro, ...) layout of
    accumulation microbatches, a spec that splits dim 1).  With
    ``batch_sharded=False`` every rank passes the same ``a`` and it is
    placed replicated.  No data moves: each rank keeps its rows."""
    import numpy as np
    from .mesh import device_of
    from .sharding import to_dtensor
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    if not batch_sharded:
        spec = ()
    elif batch_dim and spec and spec[0] is not None:
        spec = (None,) * batch_dim + spec
    local = torch.as_tensor(a if isinstance(a, torch.Tensor)
                            else np.asarray(a)).to(device_of(mesh))
    return to_dtensor(local, spec, mesh)


def local_rows(arr):
    """Host numpy of this rank's rows of a batch-split global array:
    its own block of the leading dim, with every other dim assembled to
    its global extent (tensor-parallel logits).  A plain tensor or array
    is returned whole."""
    import numpy as np
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(arr, DTensor):
        if isinstance(arr, torch.Tensor):
            return arr.detach().cpu().numpy()
        return np.asarray(arr)
    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in arr.placements]
    if list(keep) != list(arr.placements):
        arr = arr.redistribute(arr.device_mesh, keep)
    return arr.to_local().detach().cpu().numpy()
