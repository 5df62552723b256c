#!/usr/bin/env python3
"""Where the time of the port's generate() goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_generate.py [--new 16]

Builds TransformerLM at chip_smoke.py's full width from seeded weights,
warms it up, then runs ``generate`` on 8 prompts of 512 tokens under
``torch.profiler`` and prints one JSON object: the wall time, the summed
device time of the kernels and the device's idle share, the kernel
launches per decode step, and the ten kernels that took the most device
time.  Prefill and decode are profiled separately (``--new 1`` is the
prefill plus the first token).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def profile(model, prompt, new, torch):
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(prompt, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "new_tokens": new, "wall_ms": wall * 1e3,
        "device_ms": dev_us / 1e3,
        "idle_share": (1 - dev_us / 1e6 / wall) if dev_us else None,
        "kernel_launches": launches,
        "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new", type=int, default=16,
                    help="tokens to decode in the profiled run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_generate: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.ops import _kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    model = TransformerLM(vocab_size=32000, seq_len=1024, n_layers=12,
                          d_model=768, n_heads=12, d_ff=3072, device="cuda",
                          seed=0).eval()
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, 32000, (8, 512), generator=g).numpy()
    model.generate(prompt, 2)  # warm-up
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(),
        "prefill": profile(model, prompt, 1, torch),
        "generate": profile(model, prompt, args.new, torch)}
    pre, gen = out["prefill"], out["generate"]
    steps = args.new - 1
    out["decode_launches_per_step"] = (
        (gen["kernel_launches"] - pre["kernel_launches"]) / steps)
    out["decode_ms_per_step"] = (gen["wall_ms"] - pre["wall_ms"]) / steps
    out["decode_device_ms_per_step"] = (
        (gen["device_ms"] - pre["device_ms"]) / steps)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
