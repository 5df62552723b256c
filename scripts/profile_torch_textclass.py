#!/usr/bin/env python3
"""Where chip_smoke's textclass phase spends its seconds, on one NVIDIA
GPU.

    python3 scripts/profile_torch_textclass.py

Prints two JSON lines:

* ``launch_count``: for the phase's cnn and lstm text classifiers and
  its sentiment model, one training step's kernels counted by
  ``torch.profiler`` twice with the CPU's ops traced beside the CUDA
  activity and twice with the CUDA activity alone (chip_smoke's
  ``device_launches``): the count and the seconds of each trace, and of
  its aggregation;
* ``phase``: ``chip_smoke.phase_textclass`` once, with the seconds spent
  in each of its steps (building the models, the card's and the CPU
  copy's fits and predicts, ``one_step_fits``, ``device_launches``,
  ``text_vs_cpu``), each ended by a synchronise.
"""

import collections
import json
import os
import sys
import tempfile
import time


def count(torch, fn, activities):
    """Kernels of ``fn()`` in a trace of ``activities`` (copies and fills
    left out), and the seconds of the aggregation."""
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    t = time.perf_counter()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    return n, time.perf_counter() - t


def launch_count(torch, cs, models, keras):
    import numpy as np
    from torch.profiler import ProfilerActivity
    modes = (("cpu_cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
             ("cuda", [ProfilerActivity.CUDA]))
    x, y = cs.textclass_data()
    rng = np.random.default_rng(1)
    xs = rng.integers(0, cs.SENTIMENT["vocab"],
                      (cs.SENTIMENT["batch"], cs.SENTIMENT["seq"]))
    ys = rng.integers(0, 2, cs.SENTIMENT["batch"])
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = cs.glove_file(d)
        for name in ("cnn", "lstm", "sentiment"):
            if name == "sentiment":
                m = cs.build_sentiment(keras, "cuda")
                bx, by, opt = xs.astype(np.int32), ys.astype(np.int32), "adam"
            else:
                m = cs.build_textclass(models, name, path, "cuda")
                bx, by, opt = x, y, cs.TEXTCLASS_OPTIMIZER
            m.compile(opt, "sparse_categorical_crossentropy")
            m.fit(bx, by, batch_size=len(bx))
            runs = []
            for label, acts in modes * 2:
                t = time.perf_counter()
                n, agg = count(torch, lambda: m.fit(bx, by,
                                                    batch_size=len(bx)),
                               acts)
                runs.append(dict(mode=label, launches=n,
                                 s=time.perf_counter() - t, aggregate_s=agg))
            out[name] = runs
            del m
    return out


def phase(torch, cs, models, keras, kernels):
    from analytics_zoo_tpu_torch.pipeline.api.keras import engine
    spent = collections.defaultdict(float)

    def clocked(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t
        return run

    for name in ("glove_file", "build_textclass", "build_sentiment",
                 "one_step_fits", "device_launches"):
        setattr(cs, name, clocked(name, getattr(cs, name)))
    text_vs_cpu = cs.text_vs_cpu

    def clocked_text_vs_cpu(torch_, models_, build, *a):
        return text_vs_cpu(torch_, models_, lambda dev: clocked(
            f"build_{dev}", build)(dev), *a)

    cs.text_vs_cpu = clocked("text_vs_cpu", clocked_text_vs_cpu)
    for method in ("fit", "predict"):
        orig = getattr(engine.KerasNet, method)

        def by_device(self, *a, _orig=orig, _method=method, **k):
            return clocked(f"{_method}_{self.device.type}", _orig)(
                self, *a, **k)

        setattr(engine.KerasNet, method, by_device)
    t = time.perf_counter()
    ok, _ = cs.phase_textclass(torch, models, keras, kernels)
    return dict(ok=ok, total_s=time.perf_counter() - t, **spent)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_textclass: needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from analytics_zoo_tpu_torch import models
    from analytics_zoo_tpu_torch.ops import _kernels as kernels
    from analytics_zoo_tpu_torch.pipeline.api import keras
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    card = cs.smi_card()
    print(json.dumps({"launch_count": launch_count(torch, cs, models,
                                                   keras), "card": card}),
          flush=True)
    print(json.dumps({"phase": phase(torch, cs, models, keras, kernels),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
