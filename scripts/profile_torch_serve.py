#!/usr/bin/env python3
"""Where the time of the port's serving decode goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_serve.py [--new 64] [--capacity 8]

Builds TransformerLM at chip_smoke.py's full width (max_len 640) from
seeded weights and a warmed ``DecodeEngine`` (prompt buckets 128/256/512),
then profiles under ``torch.profiler`` and prints one JSON object:

* ``engine``: ``capacity`` requests of 128-token prompts streamed to
  ``--new`` tokens each through ``generate`` (admission, CUDA-graph steps
  and fan-out): wall time, summed device time of the kernels and the
  device's idle share, and the ten kernels that took the most device
  time;
* ``step_graph`` and ``step_eager``: 32 replays of the single-step CUDA
  graph, and 32 runs of the same step body eagerly, at full capacity:
  wall and device time per step and kernel launches per step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STEPS = 32


def profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
        "idle_share": (1 - dev_us / 1e6 / wall) if dev_us else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in top],
    }


def per_step(row, steps):
    return dict(row, wall_ms_per_step=row["wall_ms"] / steps,
                device_ms_per_step=row["device_ms"] / steps,
                launches_per_step=row["kernel_launches"] / steps,
                top=row["top"][:5])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new", type=int, default=64,
                    help="tokens each request decodes in the engine run")
    ap.add_argument("--capacity", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    model = TransformerLM(vocab_size=32000, seq_len=640, n_layers=12,
                          d_model=768, n_heads=12, d_ff=3072, device="cuda",
                          seed=0).eval()
    engine = DecodeEngine(model, capacity=args.capacity, max_len=640,
                          prompt_buckets=(128, 256, 512))
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, 32000, (args.capacity, 128),
                            generator=g).numpy()
    engine.generate(prompts, 4, timeout=120)  # the dispatcher's first run
    try:
        out = {"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
            "capacity": args.capacity, "new": args.new,
            "warmup_s": warm_s}
        before = engine.stats()
        out["engine"] = profiled(torch, lambda: engine.generate(
            prompts, args.new, timeout=300))
        after = engine.stats()
        out["engine"].update(
            steps=after["steps"] - before["steps"],
            tokens=after["tokens"] - before["tokens"],
            fused_dispatches=(after["fused_dispatches"]
                              - before["fused_dispatches"]))
        with engine._on_device():
            graph = engine._step_plan.graph

            def replays():
                for _ in range(STEPS):
                    graph.replay()

            def eager():
                for _ in range(STEPS):
                    engine._step_body()

            replays()
            eager()
            out["step_graph"] = per_step(profiled(torch, replays), STEPS)
            out["step_eager"] = per_step(profiled(torch, eager), STEPS)
    finally:
        engine.close()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
