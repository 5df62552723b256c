#!/usr/bin/env python3
"""The port's int8 route on one NVIDIA GPU: which shapes cuBLASLt's int8
GEMM takes, and where a quantized request's time goes.

    python3 scripts/profile_torch_int8.py

Prints one JSON object:

* ``int_mm_refused``: ``torch._int_mm`` called unpadded on the card over
  a grid of rows (17 to 100,352), depths (8 to 4,608) and widths (8 to
  2,048), all multiples of 8 but the rows, with a row-major second
  operand: how many shapes it refuses, and at which depths;
* ``int_matmul``: ``ops.quantize.int_matmul`` (zero-padded) over a
  wider grid (rows 1-69 and larger, depths and widths off multiples of
  8): shapes whose int32 product differs from the CPU's (or raises);
* ``requests``: ResNet-50 (224x224x3, 1000 classes, seed 0, TF32 off)
  served by ``InferenceModel`` in f32 and quantized, one request of 4
  images: median wall ms of 5, then one profiled request (device ms,
  idle share, kernel launches, the ten kernels that took the most device
  time);
* ``concurrent``: the quantized handle at a concurrency of 1 and of 4,
  served from 4 threads (each warmed by a request of its own) by
  chip_smoke's ``serve_image_requests``: requests/s of 3 passes of 64
  requests, then one profiled pass (device ms, idle share, launches and
  wall microseconds a launch);
* ``launch_rate``: bare ops (``add_`` on a 1,024-element tensor) from
  1, 2 and 4 threads at once, on the card and on the host's CPU: ops a
  second in all: the host's op path without the model, and on host
  tensors without CUDA at all;
* ``depth_floor``: what padding the depth to 128 costs ResNet-50's
  1x1 convolutions of 64 input channels at a batch of 32 (100,352
  rows): ``conv_accumulate`` (the patches copied into the padded
  matrix, then ``_int_mm`` at depth 128) against ``torch._int_mm`` on
  the unpadded view at depth 64, median of 20 by CUDA events, with the
  count of such layers in the model;

with the card's name and power limit.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import sys
import time

ROWS = (17, 64, 256, 1350, 4096, 100352)
DEPTHS = (8, 16, 24, 32, 40, 48, 64, 72, 96, 128, 152, 256, 576, 1152,
          2048, 4608)
WIDTHS = (8, 16, 24, 32, 48, 64, 88, 128, 256, 512, 1000, 1024, 2048)
PAD_ROWS = tuple(range(1, 70)) + (100, 1350, 1351, 1352, 4095, 100352,
                                  100353)
PAD_DEPTHS = (3, 8, 16, 24, 27, 32, 48, 64, 96, 127, 128, 147, 152, 576,
              2048, 4608)
PAD_WIDTHS = (1, 5, 8, 16, 21, 32, 48, 64, 84, 88, 126, 128, 256, 1000,
              2048)
MAX_ELEMENTS = 100353 * 1152   # rows x depth of the largest operand


def refused_shapes(torch):
    g = torch.Generator(device="cuda").manual_seed(0)
    refused, total = [], 0
    for m, k, n in itertools.product(ROWS, DEPTHS, WIDTHS):
        if m * k > MAX_ELEMENTS:
            continue
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        total += 1
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
        except RuntimeError:
            refused.append((m, k, n))
    return {"shapes": total, "refused": len(refused),
            "refused_depths": sorted({k for _, k, _ in refused}),
            "refused_rows": sorted({m for m, _, _ in refused})}


def padded_products(torch, int_matmul):
    g = torch.Generator().manual_seed(0)
    bad, total = [], 0
    for m, k, n in itertools.product(PAD_ROWS, PAD_DEPTHS, PAD_WIDTHS):
        if m * k > 100353 * 600:
            continue
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        total += 1
        try:
            same = torch.equal(int_matmul(a.cuda(), b.cuda()).cpu(),
                               int_matmul(a, b))
        except RuntimeError:
            same = False
        if not same:
            bad.append([m, k, n])
    return {"shapes": total, "differ_or_raise": bad}


def requests(torch, profiled, tmp):
    import numpy as np
    from analytics_zoo_tpu_torch.models import ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    net = ImageClassifier("resnet-50", seed=0)
    net.save_model(tmp)
    x = np.random.default_rng(0).normal(size=(4, 224, 224, 3)).astype(
        np.float32)
    out = {}
    for quantize in (False, True):
        im = InferenceModel().load(tmp, quantize=quantize)
        try:
            im.predict(x)  # warm-up
            walls = []
            for _ in range(5):
                t = time.perf_counter()
                im.predict(x)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            prof = profiled(torch, lambda: im.predict(x))
        finally:
            im.close()
        out["int8" if quantize else "f32"] = dict(
            rows=len(x), wall_ms_median=statistics.median(walls) * 1e3,
            wall_ms=[w * 1e3 for w in walls], profiled=prof)
    return out


def concurrent(torch, profiled, tmp):
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from chip_smoke import serve_image_requests
    x = np.random.default_rng(0).normal(size=(64, 224, 224, 3)).astype(
        np.float32)
    out = {}
    for level in (1, 4):
        im = InferenceModel(supported_concurrent_num=level).load(
            tmp, quantize=True)
        try:
            rps = [serve_image_requests(im, x, 4, 4, 64)[1]
                   for _ in range(3)]
            prof = profiled(torch, lambda: serve_image_requests(
                im, x, 4, 4, 64))
        finally:
            im.close()
        prof["wall_us_per_launch"] = (prof["wall_ms"] * 1e3
                                      / prof["kernel_launches"])
        prof["top"] = prof["top"][:5]
        out[f"concurrency_{level}"] = dict(
            threads=4, requests=64, rows_per_request=4,
            requests_per_s=rps, profiled_pass=prof)
    return out


def launch_rate(torch, n=20000):
    import threading
    out = {}
    for device in ("cuda", "cpu"):
        for threads in (1, 2, 4):
            bufs = [torch.zeros(1024, device=device) for _ in range(threads)]
            barrier = threading.Barrier(threads + 1)

            def client(k):
                b = bufs[k]
                for _ in range(100):  # warm this thread's launch path
                    b.add_(1)
                barrier.wait()
                for _ in range(n // threads):
                    b.add_(1)

            workers = [threading.Thread(target=client, args=(k,))
                       for k in range(threads)]
            for w in workers:
                w.start()
            barrier.wait()
            t = time.perf_counter()
            for w in workers:
                w.join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            out[f"{device}_threads_{threads}"] = {
                "ops": n // threads * threads,
                "ops_per_s": n // threads * threads / wall}
    return out


def depth_floor(torch):
    from analytics_zoo_tpu_torch.models import ImageClassifier
    from analytics_zoo_tpu_torch.ops import quantize as Q
    net = ImageClassifier("resnet-50", seed=0)
    convs = [l for l in net.quantize().to_graph().layers
             if isinstance(l, Q.QuantizedConv)]
    thin = [l for l in convs if l.Wq.shape[0] == 1 and l.Wq.shape[2] < 128]
    g = torch.Generator(device="cuda").manual_seed(0)
    xq = torch.randint(-127, 128, (32, 56, 56, 64), generator=g,
                       device="cuda", dtype=torch.int8)

    def ms(fn, reps=20):
        fn()
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    out = {"layers": len(thin),
           "shapes": sorted({tuple(l.Wq.shape) for l in thin})}
    for cout in sorted({l.Wq.shape[3] for l in thin}):
        w = next(l.Wq for l in thin if l.Wq.shape[3] == cout)
        flat = w.reshape(64, cout)
        assert torch.equal(Q.conv_accumulate(xq, w, (1, 1), "VALID"),
                           torch._int_mm(xq.view(-1, 64), flat).view(
                               32, 56, 56, cout))
        out[f"64->{cout}"] = {
            "padded_ms": ms(lambda: Q.conv_accumulate(xq, w, (1, 1),
                                                      "VALID")),
            "unpadded_ms": ms(lambda: torch._int_mm(xq.view(-1, 64),
                                                    flat))}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_int8: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from analytics_zoo_tpu_torch.ops.quantize import int_matmul
    from chip_smoke import smi_card
    from profile_torch_serve import profiled
    tmp = os.path.join(root, "build", "profile_int8", "resnet50")
    result = {"int_mm_refused": refused_shapes(torch),
              "int_matmul": padded_products(torch, int_matmul),
              "requests": requests(torch, profiled, tmp),
              "concurrent": concurrent(torch, profiled, tmp),
              "launch_rate": launch_rate(torch),
              "depth_floor": depth_floor(torch),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "card": smi_card()}
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
