#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--model lenet] [--steps 2]
    python3 scripts/profile_torch_train.py --model resnet50 [--naive-bn]
    python3 scripts/profile_torch_train.py --model ncf [--steps 20]
    python3 scripts/profile_torch_train.py --model textclass_lstm
    python3 scripts/profile_torch_train.py --model transformer_lm_moe

``--model transformer_lm`` (the default) builds TransformerLM at
chip_smoke.py's training width (12 layers, d_model 768, 12 heads, vocab
32000, seq_len 2048; its constants and data) from seeded weights,
compiles it with adam 3e-4 and warms it up with one ``fit`` step on 8
periodic sequences; ``--model transformer_lm_mixed`` is the same model
compiled as chip_smoke.py's mixed phase compiles it
(``compute_dtype=torch.bfloat16``, ``accum_steps=2``).  ``--model lenet``
builds chip_smoke.py's LeNet
(the reference's Sequential) with adam 1e-3 and warms it up with one
step on 64 of its synthetic 28x28 blobs.  ``--model resnet50`` builds
chip_smoke.py's resnet phase (the JAX bench's plan: ResNet-50 at
224x224, 1000 classes, batch 128, sgd 0.1 momentum 0.9, bf16 compute,
x ~ N(0, 1) from seed 0) and warms it up with one step; ``--naive-bn``
trains its BatchNormalization layers on the plain formulation
(``ops.batchnorm.set_naive_bn``, the JAX bench's A/B) instead of the
closed form.  ``--model ncf`` builds chip_smoke.py's recommend phase
(NeuralCF on the JAX bench's plan: 6040 users x 3706 items, 5 classes,
batch 2800, adam 1e-3, class_nll, ids and labels from seed 0) and warms
it up with one step.  ``--model textclass_{cnn,lstm,gru}`` builds
chip_smoke.py's textclass phase for that encoder (TextClassifier: 20
classes, a WordEmbedding over its 5,000-word 200-d GloVe file written
from seed 0 into a temporary directory, sequence_length 500,
encoder_output_dim 256, batch 128, adagrad 0.01) and warms it up with
one step.  ``--model transformer_lm_moe`` is transformer_lm with
chip_smoke.py's MOE blocks (every second MLP a SwitchMoE of 8 experts,
capacity factor 1.25); its SwitchMoE forwards run inside a labelled
span, so the JSON adds the device time of their kernels and the span
they cover on the device.  Then ``--steps`` more one-step
``fit`` calls run under ``torch.profiler``, and one JSON object is
printed: wall and device time per step, the device's idle share,
launches per step, the device time of the GEMMs, the convolutions, each
flash kernel and the rest (elementwise work, reductions and the
optimizer's kernels), the optimizer update's kernel time and its span on
the device (first to last kernel, gaps included), and the fifteen
kernels that took the most device time; with BatchNormalization layers
also the device time of the kernels launched inside their forward and
inside the closed form's backward (labelled spans); with SwitchMoE layers
the same for their forward.  TF32 off, as
chip_smoke.py runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# cuBLAS's GEMMs (nvjet_* at bf16 on the H100)
GEMM = re.compile(r"gemm|gemv|cutlass|xmma|nvjet", re.IGNORECASE)
# cuDNN's convolution kernels (forward, data and weight gradients)
CONV = re.compile(r"conv|fprop|dgrad|wgrad", re.IGNORECASE)


def kind(name: str) -> str:
    for k in FLASH:  # the forward's kernel is flash_fwd_sm90_kernel at d 64
        if f"{k}_kernel" in name or f"{k}_sm90_kernel" in name:
            return k
    if CONV.search(name):
        return "conv"
    return "gemm" if GEMM.search(name) else "other"


def transformer_lm(torch, steps, moe=None, **compile_args):
    """(model, x, y, batch) at chip_smoke's training width, with the
    Switch-MoE settings ``moe`` when given."""
    from analytics_zoo_tpu_torch.models import TransformerLM
    from chip_smoke import (FULL, TRAIN_BATCH, TRAIN_LR, TRAIN_SEQ,
                            periodic_tokens)
    cfg = dict(FULL, seq_len=TRAIN_SEQ, **(moe or {}))
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                  **compile_args)
    x, y = periodic_tokens(TRAIN_BATCH * (steps + 1), cfg["vocab_size"],
                           TRAIN_SEQ, seed=1)
    return model, x, y, TRAIN_BATCH


def lenet(torch, steps):
    """(model, x, y, batch): chip_smoke's LeNet and blobs."""
    from analytics_zoo_tpu_torch.pipeline.api import keras
    from chip_smoke import LENET_BATCH, build_lenet, lenet_blobs
    model = build_lenet(keras, "cuda")
    model.compile({"name": "adam", "lr": 1e-3},
                  "sparse_categorical_crossentropy")
    x, y = lenet_blobs(LENET_BATCH * (steps + 1), seed=0)
    return model, x, y, LENET_BATCH


def transformer_lm_mixed(torch, steps):
    """transformer_lm as chip_smoke's mixed phase compiles it."""
    from chip_smoke import MIXED_ACCUM
    return transformer_lm(torch, steps, compute_dtype=torch.bfloat16,
                          accum_steps=MIXED_ACCUM)


def resnet50(torch, steps):
    """(model, x, y, batch): chip_smoke's resnet phase; every step sees
    the same batch, as there."""
    import numpy as np
    from analytics_zoo_tpu_torch.models import ImageClassifier
    from chip_smoke import RESNET, RESNET_OPTIMIZER
    shape = (RESNET["size"], RESNET["size"], 3)
    b = RESNET["batch"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b,) + shape).astype(np.float32)
    y = rng.integers(0, RESNET["classes"], b).astype(np.int32)
    model = ImageClassifier("resnet-50", input_shape=shape,
                            num_classes=RESNET["classes"], seed=0)
    model.compile(RESNET_OPTIMIZER, "sparse_categorical_crossentropy",
                  compute_dtype=torch.bfloat16)
    return (model, np.concatenate([x] * (steps + 1)),
            np.concatenate([y] * (steps + 1)), b)


def ncf(torch, steps):
    """(model, x, y, batch): chip_smoke's recommend phase; every step
    sees the same batch, as there."""
    import numpy as np
    from analytics_zoo_tpu_torch import models
    from chip_smoke import NCF, NCF_OPTIMIZER, build_ncf, ncf_data
    x, y = ncf_data()
    model = build_ncf(models, "cuda")
    model.compile(NCF_OPTIMIZER, "class_nll")
    return (model, np.concatenate([x] * (steps + 1)),
            np.concatenate([y] * (steps + 1)), NCF["batch"])


def transformer_lm_moe(torch, steps):
    """transformer_lm with chip_smoke's MoE blocks."""
    from chip_smoke import MOE
    return transformer_lm(torch, steps, moe=MOE)


def textclass(encoder):
    def build(torch, steps):
        """(model, x, y, batch): chip_smoke's textclass phase for one
        encoder; every step sees the same batch, as there."""
        import tempfile
        import numpy as np
        from analytics_zoo_tpu_torch import models
        from chip_smoke import (TEXTCLASS_OPTIMIZER, build_textclass,
                                glove_file, textclass_data)
        with tempfile.TemporaryDirectory() as d:
            model = build_textclass(models, encoder, glove_file(d), "cuda")
        model.compile(TEXTCLASS_OPTIMIZER, "sparse_categorical_crossentropy")
        x, y = textclass_data()
        return (model, np.concatenate([x] * (steps + 1)),
                np.concatenate([y] * (steps + 1)), len(x))
    return build


MODELS = {"transformer_lm": transformer_lm,
          "transformer_lm_mixed": transformer_lm_mixed,
          "transformer_lm_moe": transformer_lm_moe, "lenet": lenet,
          "resnet50": resnet50, "ncf": ncf,
          **{f"textclass_{e}": textclass(e) for e in ("cnn", "lstm", "gru")}}


def label(owner, attr, name, record_function):
    """Wrap ``owner.attr`` so that its kernels run inside a profiler span
    named ``name``."""
    fn = getattr(owner, attr)

    def labelled(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)

    setattr(owner, attr, labelled)


def span_ms(events, name, cuda):
    """Device time of the kernels launched inside the span ``name`` (its
    CPU op's device total)."""
    return sum(e.device_time_total for e in events
               if e.key == name and e.device_type != cuda) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS),
                    default="transformer_lm", help="what to train")
    ap.add_argument("--steps", type=int, default=2,
                    help="one-step fit calls to profile")
    ap.add_argument("--naive-bn", action="store_true",
                    help="BatchNormalization on the plain formulation")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("profile_torch_train: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops import batchnorm as bn_ops
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        BatchNormalization, SwitchMoE)
    bn_ops.set_naive_bn(args.naive_bn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    model, x, y, B = MODELS[args.model](torch, args.steps)
    model.fit(x[:B], y[:B], batch_size=B)  # warm-up
    label(model.trainer.optimizer, "apply", "zoo_optimizer",
          record_function)
    label(BatchNormalization, "forward", "zoo_batchnorm", record_function)
    label(bn_ops.BatchNormTrain, "backward", "zoo_batchnorm_backward",
          record_function)
    label(SwitchMoE, "forward", "zoo_moe", record_function)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, args.steps + 1):
            model.fit(x[B * i:B * (i + 1)], y[B * i:B * (i + 1)],
                      batch_size=B)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the label shows twice: as a CPU op whose device time is that of the
    # kernels launched inside it, and as a device-side annotation spanning
    # them, idle gaps included; neither is a kernel
    spans = ("zoo_optimizer", "zoo_batchnorm", "zoo_batchnorm_backward",
             "zoo_moe")
    kernels = [e for e in events
               if e.device_type == cuda and e.key not in spans]

    def span_on_device_ms(name):
        return sum(e.self_device_time_total for e in events
                   if e.key == name and e.device_type == cuda) / 1e3
    by_kind = {}
    for e in kernels:
        k = kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total
    dev_us = sum(by_kind.values())
    n = args.steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    out = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "model": args.model, "steps": n, "wall_ms_per_step": wall * 1e3 / n,
        "device_ms_per_step": dev_us / 1e3 / n,
        "idle_share": 1 - dev_us / 1e6 / wall,
        "launches_per_step": sum(e.count for e in kernels) / n,
        "device_ms_per_step_by_kind": {k: v / 1e3 / n
                                       for k, v in sorted(by_kind.items())},
        "optimizer_kernels_ms_per_step":
            span_ms(events, "zoo_optimizer", cuda) / n,
        "optimizer_span_ms_per_step":
            span_on_device_ms("zoo_optimizer") / n,
        "batchnorm_forward_kernels_ms_per_step":
            span_ms(events, "zoo_batchnorm", cuda) / n,
        "batchnorm_backward_kernels_ms_per_step":
            span_ms(events, "zoo_batchnorm_backward", cuda) / n,
        "moe_forward_kernels_ms_per_step":
            span_ms(events, "zoo_moe", cuda) / n,
        "moe_forward_span_ms_per_step": span_on_device_ms("zoo_moe") / n,
        "naive_bn": args.naive_bn,
        "top": [{"kernel": e.key[:90], "ms_per_step":
                 e.self_device_time_total / 1e3 / n,
                 "count_per_step": e.count / n} for e in top],
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
