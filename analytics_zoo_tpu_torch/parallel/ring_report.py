"""Ring-attention scaling: sequence length against per-device memory
and time, ring against one device.

Counterpart of ``analytics_zoo_tpu/parallel/ring_report.py``.  Ring
attention exists for sequences that do not fit one device: each rank
holds its seq/n block of q/k/v and the k/v blocks rotate, so per-rank
memory is O(seq/n) where one device holds O(seq).  For each sequence
length this runs both (the ring on the mesh's ``seq`` axis, each rank
given only its own blocks; blockwise attention of the whole sequence on
one rank) and reports per-rank bytes and wall time.  Bytes are
``torch.cuda.max_memory_allocated``'s peak over the call on the card;
on the CPU they are counted: the tensors the call holds at its peak
(inputs, the rotating k/v copies, one score tile and its exponentials,
the running statistics and output).  CPU wall times are the CPU's.

Run by hand it starts its own world (``--ranks`` processes, gloo with
``--device cpu``) on the mesh {seq ranks}::

    python -m analytics_zoo_tpu_torch.parallel.ring_report --device cpu
"""

from __future__ import annotations

import json
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .mesh import device_of
from .report_util import (device_kind, peak_bytes, report_args, reset_peak,
                          run_world)


def _counted_bytes(b, s, h, d, block_k, copies):
    """f32 bytes of a call holding q/k/v of ``s`` rows (``copies`` sets
    of k/v), one (b, h, s, block_k) score tile and its exponentials, the
    running max and sum and the (b, h, s, d) output."""
    qkv = b * s * h * d * (1 + 2 * copies)
    tile = 2 * b * h * s * block_k
    stats = 2 * b * h * s + b * h * s * d
    return 4 * (qkv + tile + stats)


def _time(fn, iters: int, device) -> float:
    fn()  # warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    else:
        float(out.reshape(-1)[0])
    return (time.perf_counter() - t0) / iters * 1e3


def compare_ring(mesh=None, seq_lengths: Sequence[int] = (2048, 8192,
                                                          32768),
                 batch: int = 1, heads: int = 2, head_dim: int = 64,
                 causal: bool = True, run_single_up_to: int = 8192,
                 run_ring_up_to: int = 8192, iters: int = 1) -> Dict:
    """Ring (over the mesh's ``seq`` axis) against one rank's blockwise
    attention for each of ``seq_lengths``; every rank of the mesh calls
    this.  Lengths past ``run_single_up_to`` / ``run_ring_up_to`` are
    not run (their bytes counted only, the measured figure None).
    Returns {seq: {ring: {...}, single_device: {...}}}."""
    from . import mesh as mesh_lib
    from ._compat import axis_index
    from .ring_attention import ring_attention
    from ..ops.attention import _largest_divisor, blockwise_attention

    mesh = mesh or mesh_lib.get_default_mesh()
    if "seq" not in (mesh.mesh_dim_names or ()):
        raise ValueError("mesh must carry a 'seq' axis "
                         "(create_mesh({'seq': n}))")
    n = mesh_lib.axis_sizes(mesh)["seq"]
    device = device_of(mesh)
    me = axis_index("seq", mesh)
    rows: Dict[str, Dict] = {}
    for seq in seq_lengths:
        if seq % n:
            raise ValueError(f"seq {seq} not divisible by ring size {n}")
        local = seq // n
        rng = np.random.default_rng(seq)
        entry: Dict = {"ring": {}, "single_device": {}}
        ring_bk = _largest_divisor(local, min(1024, local))
        entry["ring"]["counted_bytes"] = _counted_bytes(
            batch, local, heads, head_dim, ring_bk, 2)
        single_bk = min(1024, seq)
        entry["single_device"]["counted_bytes"] = _counted_bytes(
            batch, seq, heads, head_dim, single_bk, 1)
        shape = (batch, seq, heads, head_dim)
        q, k, v = (rng.normal(size=shape).astype(np.float32)
                   for _ in range(3))
        if seq <= run_ring_up_to:
            block = slice(me * local, (me + 1) * local)
            ql, kl, vl = (torch.as_tensor(a[:, block], device=device)
                          for a in (q, k, v))
            reset_peak(device)
            with torch.no_grad():
                entry["ring"]["wall_ms"] = _time(
                    lambda: ring_attention(ql, kl, vl, causal=causal,
                                           mesh=mesh), iters, device)
            if device.type == "cuda":
                entry["ring"]["peak_bytes"] = peak_bytes(device)
        else:
            entry["ring"]["wall_ms"] = None
        if seq <= run_single_up_to:
            qf, kf, vf = (torch.as_tensor(a, device=device)
                          for a in (q, k, v))
            reset_peak(device)
            with torch.no_grad():
                entry["single_device"]["wall_ms"] = _time(
                    lambda: blockwise_attention(qf, kf, vf, causal=causal,
                                                block_k=single_bk),
                    iters, device)
            if device.type == "cuda":
                entry["single_device"]["peak_bytes"] = peak_bytes(device)
        else:
            entry["single_device"]["wall_ms"] = None
            entry["single_device"]["note"] = (
                "not run: past the single-device budget (bytes counted "
                "only)")
        entry["memory_ratio_single_over_ring"] = (
            entry["single_device"]["counted_bytes"]
            / entry["ring"]["counted_bytes"])
        rows[str(seq)] = entry
    return {"mesh": mesh_lib.axis_sizes(mesh), "batch": batch,
            "heads": heads, "head_dim": head_dim, "causal": causal,
            "ring_devices": n, "device_kind": device_kind(device),
            "rows": rows}


def main(argv=None):
    from . import distributed as dist_lib
    args = report_args(argv, 8, "ring attention: memory and time by "
                                "sequence length")
    if not dist_lib.cluster_env_present():
        raise SystemExit(run_world(__name__, args.ranks,
                                   ["--device", args.device]))
    torch.set_num_threads(1)
    from . import mesh as mesh_lib
    mesh = mesh_lib.create_mesh({"seq": args.ranks}, device=args.device)
    out = compare_ring(mesh)
    if dist_lib.is_coordinator():
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
