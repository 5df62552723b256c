#!/usr/bin/env python3
"""The port's parallel strategies on a pod of ranks, one card each.

    python -m analytics_zoo_tpu_torch.launcher --num-processes 4 \\
        scripts/profile_torch_parallel.py [--out chiprun_out/parallel.json]

Every rank of the pod (NCCL on the cards) builds TransformerLM at
chip_smoke.py's training width (12 layers, d_model 768, 12 heads, vocab
32000, seq_len 2048, adam 3e-4, f32, dropout 0) from seed 0 and trains
it on one global batch of 8 periodic sequences a step under each plan:

* ``replicate`` on {data n}: data parallelism, each rank 8/n rows;
* ``fsdp`` on {fsdp n}: the same rows, weights and moments split;
* ``fsdp_tp`` on {fsdp n/2, tensor 2} with chip_smoke's per-layer
  tensor rules: attention on its head blocks and the MLP on column and
  row blocks, 8/(n/2) rows a rank;
* ``tp`` on {tensor n} with the same rules: every rank all 8 rows.

Each plan takes a warm-up step and ``--steps`` one-step fits, each
ending synchronised; per plan the median step ms, tokens/s, each rank's
peak GiB, the kernels' launches a step, the collectives of one step
(the profiler's ``c10d`` operators) and the largest relative
difference of its losses from the plain Trainer's on the same 8
sequences, which every rank also runs alone on its own card (the
reference: a mesh whose one axis is ``pipe``, which the Trainer leaves
alone, so no leaf is split, no data axis averages and no collective
runs; a pod with no mesh would train data-parallel).  Then ring
attention (``parallel/ring_report.py``) on {seq n} against one card's
blockwise attention at growing lengths.  Rank 0 prints one JSON object
(with every card's name and power limit) and writes it to ``--out``.

``--device cpu --small`` rehearses it on a gloo pod at a tiny width.
TF32 off, as chip_smoke.py runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: chip_smoke.py's training width and its per-layer tensor rules
FULL = dict(vocab_size=32000, seq_len=2048, n_layers=12, d_model=768,
            n_heads=12, d_ff=3072)
SMALL = dict(vocab_size=64, seq_len=32, n_layers=2, d_model=32, n_heads=4,
             d_ff=64)
RULES = {r"attn_\d+/W[qkv]$": 1, r"attn_\d+/Wo$": 0,
         r"mlp_up_\d+/W$": 1, r"mlp_down_\d+/W$": 0}
BATCH, LR = 8, 3e-4


def periodic_tokens(n, vocab, seq, seed):
    """chip_smoke.py's periodic next-token task."""
    import numpy as np
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, n)
    start = rng.integers(0, vocab, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_plan(torch, device, cfg, x, y, steps, plan):
    """(losses, step seconds, launches over the timed steps, peak GiB,
    collectives of one step) of one plan, (strategy, mesh axes)."""
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.ops import _kernels as kernels
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.report_util import (
        collective_counts)
    strategy, axes = plan
    mesh = mesh_lib.create_mesh(axes, device=device.type)
    per = BATCH // mesh_lib.dp_size(mesh)
    me = mesh_lib.data_index(mesh)
    model = TransformerLM(**cfg, device=device, seed=0)
    model.compile({"name": "adam", "lr": LR}, "class_nll", mesh=mesh,
                  strategy=strategy, tp_rules=RULES)

    def fit(i):
        rows = slice(i * BATCH + me * per, i * BATCH + (me + 1) * per)
        return model.fit(x[rows], y[rows], batch_size=BATCH,
                         shuffle=False)["loss"]

    losses = fit(0)
    sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    step_s = []
    for i in range(1, steps + 1):
        t = time.perf_counter()
        losses += fit(i)
        sync(torch, device)
        step_s.append(time.perf_counter() - t)
    launches = {k: v / steps for k, v in kernels.launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    _, comm = collective_counts(lambda: fit(steps + 1))
    sync(torch, device)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return losses, step_s, launches, peak, comm


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.parallel import distributed
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.ring_report import compare_ring
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cpu":
        torch.set_num_threads(1)
    if not distributed.maybe_initialize_distributed(args.device,
                                                    timeout_s=300):
        print("profile_torch_parallel: start it through the launcher "
              "(python -m analytics_zoo_tpu_torch.launcher "
              "--num-processes N ...)", file=sys.stderr)
        return 2
    n, rank = distributed.process_count(), distributed.process_index()
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    cfg = SMALL if args.small else FULL
    x, y = periodic_tokens(BATCH * (args.steps + 2), cfg["vocab_size"],
                           cfg["seq_len"], seed=1)
    out = {"ranks": n, "device": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
           "torch": torch.__version__, "config": cfg, "batch": BATCH,
           "steps": args.steps, "plans": {}}
    plain = run_plan(torch, device, cfg, x, y, args.steps,
                     ("replicate", {"pipe": n}))
    out["plain"] = dict(step_ms=statistics.median(plain[1]) * 1e3,
                        peak_gib=plain[3], launches_per_step=plain[2],
                        losses=plain[0])
    plans = {"replicate": ("replicate", {"data": n}),
             "fsdp": ("fsdp", {"fsdp": n}),
             "tp": ("tp", {"tensor": n})}
    if n % 2 == 0 and n > 2:
        plans["fsdp_tp"] = ("fsdp_tp", {"fsdp": n // 2, "tensor": 2})
    for name, plan in plans.items():
        losses, step_s, launches, peak, comm = run_plan(
            torch, device, cfg, x, y, args.steps, plan)
        step = statistics.median(step_s)
        peaks = [None] * n
        dist.all_gather_object(peaks, peak)
        out["plans"][name] = dict(
            axes=plan[1], step_ms=step * 1e3,
            step_ms_all=[t * 1e3 for t in step_s],
            tokens_per_s=BATCH * cfg["seq_len"] / step,
            peak_gib_by_rank=peaks, launches_per_step=launches,
            collectives_one_step=comm, losses=losses,
            loss_max_rel_diff=max(abs(a - b) / abs(b) for a, b in
                                  zip(losses, plain[0])))
    seq_lengths = (256, 1024) if args.small else (8192, 32768, 131072)
    ring = compare_ring(mesh_lib.create_mesh({"seq": n},
                                             device=device.type),
                        seq_lengths=seq_lengths, batch=1, heads=12,
                        head_dim=64, causal=True,
                        run_single_up_to=seq_lengths[1],
                        run_ring_up_to=seq_lengths[-1], iters=3)
    out["ring"] = ring["rows"]
    cards = [None] * n
    dist.all_gather_object(cards, card() if device.type == "cuda"
                           else "cpu")
    out["cards"] = cards
    if rank == 0:
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
