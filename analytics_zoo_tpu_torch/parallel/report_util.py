"""Shared plumbing of the report modules (``strategy_report``,
``ring_report``, ``scripts/profile_torch_parallel.py``): the world a
report runs on, the collectives a step made, and the device's peak
memory.

Counterpart of ``analytics_zoo_tpu/parallel/report_util.py``.  The JAX
package's reports force a virtual multi-device CPU platform in one
process and read XLA's memory analysis; here a report runs on a world of
ranks, one process each (:func:`run_world` starts it when the module is
run by hand), counts the collectives a call makes from the profiler's
record of the ``c10d`` operators (point-to-point sends included, which
DTensor's ``CommDebugMode`` does not count), and reads memory from
``torch.cuda.max_memory_allocated`` on the card, or counts the bytes of
the tensors involved on the CPU.  So the JAX file's
``force_cpu_mesh_env`` (a virtual multi-device CPU platform) and
``memory_analysis_bytes`` (XLA's memory analysis) have no counterparts:
:func:`run_world` and :func:`peak_bytes` take their places.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict

import torch

#: ``torch.distributed`` operator -> the JAX package's HLO collective
#: name (a send is one half of a ``collective-permute``)
COLLECTIVE_NAMES = {"allreduce_": "all-reduce",
                    "_allgather_base_": "all-gather",
                    "allgather_": "all-gather",
                    "allgather_into_tensor_coalesced_": "all-gather",
                    "reduce_scatter_": "reduce-scatter",
                    "_reduce_scatter_base_": "reduce-scatter",
                    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
                    "send": "collective-permute", "barrier": "barrier"}


def run_world(module: str, n: int, args=(), timeout_s: float = 600.0) -> int:
    """Run ``python -m module args...`` on ``n`` ranks of a local world
    (the launcher's environment contract, one process a rank, rank 0's
    output passed through); returns the first non-zero exit code, else
    0."""
    from ..launcher import _free_port
    from .distributed import ENV_COORD, ENV_NPROC, ENV_PID
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update({ENV_COORD: coord, ENV_NPROC: str(n),
                    ENV_PID: str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args], env=env,
            stdout=None if rank == 0 else subprocess.DEVNULL))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout_s))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0)


def collective_counts(fn):
    """``(fn(), counts)``: the collectives ``fn`` made, by the JAX
    package's names, from the profiler's ``c10d`` operator events (the
    receiving half of a permute is not counted again)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    counts: Dict[str, int] = {}
    for event in prof.events():
        if not event.name.startswith("c10d::"):
            continue
        op = event.name[len("c10d::"):]
        if op == "recv_":
            continue
        key = COLLECTIVE_NAMES.get(op, op)
        counts[key] = counts.get(key, 0) + 1
    return result, counts


def peak_bytes(device) -> int:
    """Peak bytes allocated on a CUDA device since the last reset."""
    return int(torch.cuda.max_memory_allocated(device))


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def report_args(argv, default_ranks: int, description: str):
    """The reports' command line: ``--ranks`` (the world it starts when
    run by hand) and ``--device`` (``cuda``, or ``cpu`` for gloo)."""
    import argparse
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--ranks", type=int, default=default_ranks)
    parser.add_argument("--device", default="cuda",
                        help="cuda (one card a rank, NCCL) or cpu (gloo)")
    return parser.parse_args(argv)


def device_kind(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
