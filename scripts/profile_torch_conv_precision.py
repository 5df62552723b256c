#!/usr/bin/env python3
"""How close the card's f32 convolutions come to an f64 reference, and
what that does to the conv VAE's card-against-CPU check.

    python3 scripts/profile_torch_conv_precision.py

For a 64->64 convolution over a batch of 8 64x64 NHWC images (3x3 stride
1, 3x3 dilation 2, 4x4 stride 2, as chip_smoke's ``layers`` sweep has
them), the forward, the input gradient, the weight gradient and the bias
gradient of ``sum(y * cot)`` on the card (cuDNN as PyTorch picks its
algorithm, then with ``cudnn.deterministic``, then without cuDNN) and on
the CPU, each as max|x - f64| over max|f64| against an f64 CPU run, with
the kernels the card ran by default.  Then chip_smoke's ``vae_vs_cpu``
(3 adam steps of the full-width conv VAE against a CPU copy) with cuDNN
and without.  TF32 off, as chip_smoke runs.  Prints one JSON object with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

MODES = ("default", "deterministic", "no_cudnn")
CASES = [(3, 1, 1), (3, 1, 2), (4, 2, 1)]  # kernel, stride, dilation


def set_mode(torch, mode):
    torch.backends.cudnn.deterministic = mode == "deterministic"
    torch.backends.cudnn.enabled = mode != "no_cudnn"


def conv_errors(torch, k, s, d, g):
    """The four tensors' errors against f64, by mode and on the CPU, and
    the default mode's kernel names."""
    import torch.nn.functional as F
    x = torch.randn(8, 64, 64, 64, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = 0.05 * torch.randn(64, 64, k, k, generator=g)
    b = torch.randn(64, generator=g)
    pad = (k - 1) * d // 2

    def run(dev, dtype):
        xi, wi, bi = (t.to(dev, dtype).requires_grad_() for t in (x, w, b))
        y = F.conv2d(xi, wi, bi, stride=s, padding=pad, dilation=d)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            1)).to(dev, dtype)
        grads = torch.autograd.grad((y * cot).sum(), [xi, wi, bi])
        return [t.detach().double().cpu() for t in (y,) + grads]

    ref = run("cpu", torch.float64)
    runs = {"cpu_f32": run("cpu", torch.float32)}
    for mode in MODES:
        set_mode(torch, mode)
        runs[mode] = run("cuda", torch.float32)
    set_mode(torch, "default")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run("cuda", torch.float32)
        torch.cuda.synchronize()
    kernels = [e.key[:80] for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    errors = {name: dict(zip(("y", "grad_x", "grad_w", "grad_b"), [
        float((a - r).abs().max() / r.abs().max()) for a, r in zip(o, ref)]))
        for name, o in runs.items()}
    return errors, kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.models import to_jax_state
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api import keras
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "convolutions": {}, "vae": {}}
    for k, s, d in CASES:
        errors, kernels = conv_errors(torch, k, s, d, g)
        out["convolutions"][f"k{k}_s{s}_d{d}"] = dict(errors=errors,
                                                      kernels=kernels)
    V = cs.VAE
    x, y = cs.vae_data(V["size"], V["latent"], V["batch"])
    for mode in ("default", "no_cudnn"):
        set_mode(torch, mode)
        model = cs.conv_vae(keras.layers, A, keras.Model, V["size"],
                            V["widths"], V["dec_widths"], V["latent"],
                            seed=0)
        weights, state = model.get_weights(), to_jax_state(model)
        model.compile({"name": "adam", "lr": V["lr"]},
                      cs.vae_loss(A, V["size"], V["latent"]))
        out["vae"][mode] = cs.vae_vs_cpu(torch, keras, A, model, weights,
                                         state, x, y)
    set_mode(torch, "default")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
