#!/usr/bin/env python3
"""Where the time of the port's serving decode goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_serve.py [--new 64] [--capacity 8]
    python3 scripts/profile_torch_serve.py --mode detect
    python3 scripts/profile_torch_serve.py --mode moe

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

``--mode moe`` does the same with chip_smoke.py's MoE blocks (every
second MLP a SwitchMoE of 8 experts, decoded drop-free).  ``--mode
detect`` builds chip_smoke.py's detect phase instead
(SSD-VGG16-300, 21 classes, f32, batch 8 of 300x300 images from seed 0,
TF32 off) and profiles ``predict`` (``predict``) and ``decode_output``
on the card (``decode``), each after a warm-up call, with the same
fields.
"""

from __future__ import annotations

import argparse
import json
import os
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


def detect(torch) -> dict:
    """chip_smoke's detect phase: predict and decode_output, profiled."""
    import numpy as np
    from analytics_zoo_tpu_torch import models
    from chip_smoke import DETECT, smi_card
    torch.backends.cudnn.allow_tf32 = False
    D = DETECT
    post = dict(conf_threshold=D["conf_threshold"],
                nms_threshold=D["nms_threshold"], top_k=D["top_k"],
                max_detections=D["max_detections"])
    x = np.random.default_rng(0).uniform(
        0, 255, (D["batch"], D["size"], D["size"], 3)).astype(np.float32)
    det = models.ObjectDetector(D["name"], num_classes=D["classes"], seed=0)
    raw = torch.from_numpy(det.predict(x, batch_size=D["batch"])).cuda()

    def decode():
        return models.decode_output(raw, det.priors, D["classes"], **post)

    decode()
    return {"card": smi_card(), "model": D["name"], "batch": D["batch"],
            "predict": profiled(torch, lambda: det.predict(
                x, batch_size=D["batch"])),
            "decode": profiled(torch, decode)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("decode", "moe", "detect"),
                    default="decode", help="what to profile")
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
    if args.mode == "detect":
        print(json.dumps(detect(torch), indent=1))
        return 0
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    from chip_smoke import FULL, MOE, smi_card
    moe = MOE if args.mode == "moe" else {}
    model = TransformerLM(**dict(FULL, seq_len=640, **moe), device="cuda",
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
        out = {"card": smi_card(), "mode": args.mode,
               "capacity": args.capacity,
               "new": args.new, "warmup_s": warm_s}
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
