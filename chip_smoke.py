#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (analytics_zoo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero):

1. build: compile every CUDA kernel of the port from ``ops/csrc``, and
   count the tensor-core MMA, ``cp.async``, ``ldmatrix`` and atomic
   instructions of each kernel instantiation (every one must have the
   first two and no atomics, and the forward ``ldmatrix``);
2. kernels: hold each kernel (the flash forward, and the backward's dq
   and dk/dv) against its plain PyTorch version on the card, at the
   paths' shapes and at edge cases, and time the kernel, the plain
   version and one PyTorch library call that computes the same function
   (a yardstick only; the port never calls it);
3. path: ``TransformerLM.generate`` at full width (12 layers, d_model 768,
   12 heads, vocab 32000; batch 8, prompt 512, 128 greedy tokens) from
   seeded random weights, with the kernel launch counts read around it,
   then the full forward as an oracle for every greedy token;
4. serve: the serving plane at the same width (max_len 640):
   ``InferenceModel(decode_capacity=8, decode_prompt_buckets=(128, 256,
   512), decode_prefix_pool=8)`` warmed, 32 requests of 16-512 prompt
   tokens and 8 or 128 new ones streamed from 4 threads (every greedy
   token against the forward's argmax, the flash forward launched 12 times
   an admission, no CUDA graph captured after warm-up), the same requests
   at step_fuse=1 (equal streams; fused and single-step dispatch timed in
   turns, with a steady decode beside), 24 requests sharing a 256-token
   prefix with the prefix pool on and off, speculative decoding with a
   0-layer draft against the plain engine, coalesced LeNet predict from 8
   threads against solo predict, and beam search (4 beams) against the
   forward's log-probs;
5. train: ``TransformerLM.compile``/``fit`` at the same width with
   seq_len 2048 (adam 3e-4, batch 8, 4 steps on 32 periodic sequences
   after a warm-up fit), with the launch counts read around the 4 steps,
   then a gradient check of the kernels' backward against blockwise
   attention on one batch;
6. small: a small model on the card against the same weights on the CPU,
   for predict, greedy streams and 3 training steps;
7. lenet: the reference's LeNet (a Sequential of Convolution2D,
   MaxPooling2D, Flatten, Dense) fitted for 3 epochs on 512 synthetic
   28x28 blobs with validation, then predict, predict_classes, evaluate,
   save_model/load_model and to_model, and the same weights on the CPU;
8. graph: a functional attention Model (Input, Embedding,
   PositionalEmbedding, LayerNorm, MultiHeadSelfAttention(flash), Dense)
   at d_model 768, 12 heads, seq 2048, batch 2: 2 fit steps, each of which
   must launch all three kernels, and predict against the same weights
   under blockwise attention;
9. mixed: the train phase's model and data compiled with
   ``compute_dtype=torch.bfloat16`` and ``accum_steps=2`` (two
   microbatches of 4): a warm-up fit and 4 one-step fits, each of which
   must launch every kernel at bf16 once a layer and microbatch and none
   at f32, with f32 master weights and adam moments after, and losses
   within atol 0.05, rtol 0.05 of the train phase's f32 losses; then, at
   f32 and 2 layers, one step with accum_steps=2 against one with
   accum_steps=1 from the same weights.

The line before the last is a JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

F32_PEAK = 67e12      # FLOP/s, H100 SXM, f32 outside the tensor cores
TF32_PEAK = 495e12    # FLOP/s, H100 SXM, dense TF32 tensor cores
BF16_PEAK = 989e12    # FLOP/s, H100 SXM, dense bf16 tensor cores
HBM_RATE = 3.35e12    # bytes/s, H100 SXM
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # o, dq, dk, dv
#: the forward's lse, which both backward kernels replay p from
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}

FULL = dict(vocab_size=32000, seq_len=1024, n_layers=12, d_model=768,
            n_heads=12, d_ff=3072)
BATCH, PROMPT, NEW = 8, 512, 128
# the repo's training configuration (bench.py transformer_lm_b8_seq2048)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 2048, 8, 4, 3e-4
GRAD_TOL = 1e-3     # per parameter, max|kernels - blockwise| / max|ref|
# LeNet (tests/test_lenet_e2e.py): 512 blobs, 3 epochs at batch 64
LENET_N, LENET_EPOCHS, LENET_BATCH, LENET_TIMED_STEPS = 512, 3, 64, 20
# the graph phase's functional attention model
GRAPH = dict(vocab=32000, d_model=768, n_heads=12, seq=2048, batch=2,
             steps=2)
# the mixed phase: bf16 compute, two microbatches a step; its losses
# track the f32 ones within the JAX package's own bf16 bound
# (tests/test_trainer_sharded.py::test_bf16_keeps_f32_master_weights_...)
MIXED_ACCUM = 2
MIXED_LOSS_TOL = dict(atol=0.05, rtol=0.05)
# accum_steps=2 against 1 at f32, 2 layers, one sgd step at rate 1, so
# that the weights move by the (accumulated) gradient itself: adam's
# first step, lr * g / (|g| + eps), is +-lr wherever |g| >> eps (it
# hides a wrongly scaled gradient) and amplifies the rounding of
# gradients near eps.  The bound of the JAX package's accumulation test
# on the weights, and 1e-4 (not the CPU's 1e-5) on the losses: the
# 3xTF32 kernels and the GEMMs re-associate differently at half the
# batch
ACCUM_LAYERS = 2
ACCUM_OPTIMIZER = {"name": "sgd", "lr": 1.0}
ACCUM_TOL = dict(loss_rtol=1e-4, rtol=1e-4, atol=1e-6)
# the serve phase: the handle of bench.py's decode cells at full width
SERVE = dict(capacity=8, max_len=640, buckets=(128, 256, 512), pool=8,
             requests=32, threads=4, max_new=(8, 8, 8, 8, 128),
             prefix_len=256, prefix_tail=32, prefix_requests=24,
             spec_requests=8, steady_len=16, steady_new=128,
             spec_new=32, spec_tokens=4, spec_scale=0.02,
             predict_threads=8, predict_requests=4, beams=4, beam_batch=2)
TIE = 1e-4          # top-2 log-prob gap below which a greedy pick is a tie
BEAM_TOL = 1e-3     # beam score against the forward's summed log-probs
PREDICT_TOL = 1e-5  # coalesced predict against solo predict
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_fwd": ("analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu",
                  "analytics_zoo_tpu/ops/attention.py:149"),
    "flash_bwd_dq": ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/attention.py:214"),
    "flash_bwd_dkv": ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
                      "analytics_zoo_tpu/ops/attention.py:265"),
}
#: FLOP per valid (query, key) pair and head-dim element, per kernel:
#: 2 per product, and 2, 3 or 4 products
PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(q, k, lens, causal, kernel="flash_fwd"):
    """The least time for this call's work, as a dict: ``bound_ms`` and
    ``bound_by`` ("bytes" or "operations") on the tensor cores, where f32
    products at f32 accuracy cost three TF32 products (3xTF32, 3 x ops at
    495 TFLOP/s) and bf16 ones one (989 TFLOP/s); ``bound_f32_cuda_ms``,
    the same work in f32 on the CUDA cores (67 TFLOP/s) or bytes.
    Operations: 2*d FLOP per product per valid (query, key) pair, with 2
    products in the forward (q.k, p.v), 3 in dq (q.k, do.v, ds.k) and 4 in
    dk/dv (k.q, v.do, p.do, ds.q).  Bytes: each input read once and each
    output written once -- per query row q-sized tensors (fwd: q, o; dq:
    q, do, dq; dkv: q, do) and f32 statistics (lse; lse and delta), the
    keys and values each row may see, and dk, dv in full; and lens."""
    import torch
    bh, sq, d = q.shape
    sk = k.shape[1]
    limit = torch.full((sq,), sk, dtype=torch.float64, device=q.device)
    if causal:
        limit = torch.arange(sq, device=q.device, dtype=torch.float64) \
            + (sk - sq + 1)
    per_bh = (torch.full((bh,), float(sk), dtype=torch.float64,
                         device=q.device) if lens is None
              else lens.double())
    pairs = float(torch.minimum(limit[None, :], per_bh[:, None]).sum())
    ops = 2.0 * d * PRODUCTS[kernel] * pairs
    keys = float(per_bh.sum())
    item = q.element_size()
    q_side, stats, full_kv = {"flash_fwd": (2, 1, 0),
                              "flash_bwd_dq": (3, 2, 0),
                              "flash_bwd_dkv": (2, 2, 2)}[kernel]
    nbytes = (q_side * bh * sq * d * item + 2 * keys * d * item
              + full_kv * bh * sk * d * item + stats * bh * sq * 4
              + (0 if lens is None else bh * 4))
    t_ops = (3 * ops / TF32_PEAK if q.dtype == torch.float32
             else ops / BF16_PEAK)
    t_bytes = nbytes / HBM_RATE
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_f32_cuda_ms=max(ops / F32_PEAK, t_bytes) * 1e3)


#: SDPA's backends, fused ones first (names of torch's SDPBackend)
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_call(q, k, v, lens, causal, scale):
    """(fn, backend): one F.scaled_dot_product_attention call on the
    (1, bh, s, d) view of folded (bh, s, d) inputs -- the fused backends
    take 4-D inputs only -- held to the first backend of SDPA_BACKENDS
    that runs it, and that backend's name."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = q[None], k[None], v[None]
    sq, sk = q.shape[1], k.shape[1]
    kw = dict(scale=scale)
    if lens is None and (not causal or sq == sk):
        kw["is_causal"] = causal
    else:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask.tril(sk - sq)
        mask = mask[None]
        if lens is not None:
            mask = mask & (torch.arange(sk, device=q.device)[None, None, :]
                           < lens[:, None, None])
        kw["attn_mask"] = mask[None]
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def fn(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4, **kw)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fn()
        except RuntimeError:
            continue
        return fn, name.lower()
    raise RuntimeError("no SDPA backend runs this case")


# name, bh, sq, sk, d, dtype, causal, longest length (None: no lens),
# timed
CASES = [
    ("prefill", 96, 512, 512, 64, "float32", True, None, True),
    ("predict", 96, 1024, 1024, 64, "float32", True, None, True),
    ("train", 96, TRAIN_SEQ, TRAIN_SEQ, 64, "float32", True, None, True),
    ("prefill", 96, 512, 512, 64, "bfloat16", True, None, True),
    # the serve phase's prefills, one prompt (12 heads) per bucket: the
    # admission's and the prefix block's
    *[("serve admit", 12, s, s, 64, "float32", True, None, True)
      for s in SERVE["buckets"]],
    ("predict", 96, 1024, 1024, 64, "bfloat16", True, None, True),
    ("cross causal", 24, 192, 512, 64, "float32", True, None, False),
    ("cross", 24, 200, 777, 64, "float32", False, None, False),
    ("kv_lengths", 24, 512, 512, 64, "float32", True, 512, False),
    ("kv_lengths", 24, 300, 300, 64, "bfloat16", False, 300, False),
    ("prime", 12, 37, 37, 64, "float32", True, None, False),
    ("prime d128", 12, 251, 251, 128, "float32", False, 251, False),
    ("d128", 24, 384, 384, 128, "bfloat16", True, None, False),
    ("d16", 4, 40, 40, 16, "float32", True, None, False),
    # lengths of at most 130 of 700 keys: whole key tiles lie past them
    ("tiles past lens", 8, 160, 700, 64, "float32", False, 130, False),
    # the backward kernels' tile edges: lengths one short of and one past
    # 64 and 128 (own tiles of 64 rows, walked tiles of 32), head dims
    # that are no multiple of the MMA depth (8 f32, 16 bf16) and whose
    # rows are no 16-byte multiple (plain-load staging), cross causal
    ("edge 63", 8, 63, 63, 64, "float32", True, None, False),
    ("edge 65", 8, 65, 65, 64, "bfloat16", True, 65, False),
    ("edge 127", 8, 127, 127, 64, "float32", False, 127, False),
    ("edge 129", 8, 129, 129, 64, "float32", True, None, False),
    ("d20", 8, 129, 129, 20, "float32", True, 129, False),
    ("d20", 8, 127, 127, 20, "bfloat16", True, None, False),
    ("d72", 8, 200, 200, 72, "float32", True, None, False),
    ("d72", 8, 65, 65, 72, "bfloat16", False, 65, False),
    ("d37", 4, 65, 65, 37, "float32", True, None, False),
    ("d5", 4, 63, 63, 5, "bfloat16", False, 63, False),
    ("d128 edge", 8, 129, 129, 128, "float32", True, 129, False),
    ("d128 cross causal", 8, 63, 129, 128, "bfloat16", True, None, False),
    ("cross causal lens", 8, 65, 127, 64, "float32", True, 127, False),
    ("cross causal d72", 8, 127, 129, 72, "bfloat16", True, None, False),
    ("train", 96, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16", True, None, True),
    # the mixed phase's microbatch: 4 of the 8 sequences
    ("mixed", 48, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16", True, None, True),
    # head dims past 128 (DP = 256: 16-row walked tiles at f32, dk/dv in
    # two 128-column halves); rows of 130 f32 or 250 bf16 are no 16-byte
    # multiple, and d = 130 leaves one column tile in the second half
    ("d192", 8, 129, 129, 192, "float32", True, 129, False),
    ("d192", 8, 127, 127, 192, "bfloat16", True, None, False),
    ("d256", 8, 200, 200, 256, "float32", True, None, False),
    ("d256 cross causal", 8, 65, 129, 256, "bfloat16", True, 129, False),
    ("d130", 4, 63, 63, 130, "float32", False, 63, False),
    ("d250", 4, 65, 65, 250, "bfloat16", True, None, False),
    # the forward's ragged query edge at its extreme: one or two query
    # rows at the end of a long causal key range; and f32 d = 256 (16-key
    # walked tiles) with lengths
    ("sq 1", 8, 1, 512, 64, "float32", True, None, False),
    ("sq 2", 8, 2, 512, 64, "float32", True, 512, False),
    ("sq 2", 8, 2, 512, 64, "bfloat16", True, None, False),
    ("d256 lens", 8, 129, 300, 256, "float32", False, 300, False),
]


def case_inputs(torch, g, bh, sq, sk, d, dtype, lens_max):
    dtype = getattr(torch, dtype)
    q, do = (torch.randn((bh, sq, d), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bh, sk, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lens = None
    if lens_max is not None:
        lens = torch.randint(1, lens_max + 1, (bh,), generator=g,
                             device="cuda").float()
    return q, k, v, do, lens


def sdpa_backward_call(torch, q, k, v, do, lens, causal, scale):
    """(fn, backend): the library yardstick of the backward, autograd of
    scaled_dot_product_attention (:func:`sdpa_call`) from one saved
    forward (retain_graph), timed apart from that forward."""
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fwd, backend = sdpa_call(qs, ks, vs, lens, causal, scale)
    out = fwd()
    return (lambda: torch.autograd.grad(out, (qs, ks, vs), do[None],
                                        retain_graph=True)), backend


SASS_OPS = ("HMMA", "LDGSTS", "LDSM", "ATOM", "RED")


def sass_counts(kernels):
    """Per kernel instantiation of the built libraries, counts of the SASS
    instructions that show the design (``cuobjdump -sass``): HMMA
    (tensor-core MMA), LDGSTS (cp.async), LDSM (ldmatrix), ATOM and RED
    (atomics).  None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts, fn = {}, None
    for lib in sorted(kernels._build_dir().glob("*.so")):
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        for line in text.splitlines():
            if "Function :" in line:
                m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                              r"I(f|13__nv_bfloat16)Li(\d+)E", line)
                fn = (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}>"
                      if m else line.split("Function :")[1].strip())
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
                continue
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z]+)",
                          line)
            if fn and op and op[1] in counts[fn]:
                counts[fn][op[1]] += 1
    return counts


def phase_kernels(torch, ops_attn, kernels):
    """Each kernel against its plain version, case by case: flash_fwd
    against flash_attention_reference (o within TOL, lse within LSE_TOL),
    flash_bwd_dq and flash_bwd_dkv against flash_bwd_dq_reference and
    flash_bwd_dkv_reference (dq, dk, dv each within max|diff| / max|ref|
    <= TOL), dk = dv = 0 exactly past every length, and a second launch
    of each backward kernel equal to the first, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = [], True
    for name, bh, sq, sk, d, dt, causal, lens_max, timed in CASES:
        q, k, v, do, lens = case_inputs(torch, g, bh, sq, sk, d, dt,
                                        lens_max)
        masked = lens is not None
        scale = d ** -0.5
        o, lse = kernels.flash_fwd(q, k, v, lens, causal, scale)
        o_ref, lse_ref = ops_attn.flash_attention_reference(
            q, k, v, causal, scale, lens)
        delta = ops_attn._flash_delta(o, do)
        args = (q, k, v, do, lse, delta, lens, causal, scale)
        dq = kernels.flash_bwd_dq(*args)
        dk, dv = kernels.flash_bwd_dkv(*args)
        deterministic = (torch.equal(dq, kernels.flash_bwd_dq(*args))
                         and all(map(torch.equal, (dk, dv),
                                     kernels.flash_bwd_dkv(*args))))
        dq_ref = ops_attn.flash_bwd_dq_reference(*args)
        dk_ref, dv_ref = ops_attn.flash_bwd_dkv_reference(*args)
        torch.cuda.synchronize()
        diff = lambda a, b: float((a.double() - b.double()).abs().max())
        rel = lambda a, b: diff(a, b) / max(float(b.double().abs().max()),
                                            1e-30)
        base = dict(case=name, dtype=dt, bh=bh, sq=sq, sk=sk, d=d,
                    causal=causal, lens=masked)
        fwd = dict(base, kernel="flash_fwd", abs_err=diff(o, o_ref),
                   err_lse=diff(lse, lse_ref))
        fwd["ok"] = (fwd["abs_err"] <= TOL[dt]
                     and fwd["err_lse"] <= LSE_TOL[dt]
                     and bool(torch.isfinite(o).all()))
        dq_row = dict(base, kernel="flash_bwd_dq", err=rel(dq, dq_ref),
                      abs_err=diff(dq, dq_ref), deterministic=deterministic)
        dq_row["ok"] = dq_row["err"] <= TOL[dt] and bool(
            torch.isfinite(dq).all()) and deterministic
        dkv_row = dict(base, kernel="flash_bwd_dkv", err=max(
            rel(dk, dk_ref), rel(dv, dv_ref)), err_dk=rel(dk, dk_ref),
            err_dv=rel(dv, dv_ref),
            abs_err=max(diff(dk, dk_ref), diff(dv, dv_ref)),
            deterministic=deterministic)
        dkv_row["ok"] = dkv_row["err"] <= TOL[dt] and bool(
            torch.isfinite(dk).all() and torch.isfinite(dv).all()
        ) and deterministic
        if masked:
            past = (torch.arange(sk, device="cuda")[None, :]
                    >= lens[:, None])[..., None]
            zero = bool((dk.masked_select(past) == 0).all()
                        and (dv.masked_select(past) == 0).all())
            dkv_row["zero_past_lens"] = zero
            dkv_row["ok"] &= zero
        if timed:
            fwd_fn = lambda: kernels.flash_fwd(q, k, v, lens, causal, scale)
            lib_fn, lib_backend = sdpa_call(q, k, v, lens, causal, scale)
            fwd.update(
                ms=cuda_ms(fwd_fn, 20),
                plain_ms=cuda_ms(lambda: ops_attn.flash_attention_reference(
                    q, k, v, causal, scale, lens), 3),
                library_ms=cuda_ms(lib_fn, 20), library_backend=lib_backend)
            if sq == TRAIN_SEQ:
                lib_fn, lib_backend = sdpa_backward_call(
                    torch, q, k, v, do, lens, causal, scale)
                lib_ms = cuda_ms(lib_fn, 10)
                for row, kern, ref in (
                        (dq_row, kernels.flash_bwd_dq,
                         ops_attn.flash_bwd_dq_reference),
                        (dkv_row, kernels.flash_bwd_dkv,
                         ops_attn.flash_bwd_dkv_reference)):
                    row.update(ms=cuda_ms(lambda: kern(*args), 10),
                               plain_ms=cuda_ms(lambda: ref(*args), 2),
                               library_ms=lib_ms, library_backend=lib_backend)
            for row in (fwd, dq_row, dkv_row):
                if "ms" in row:
                    row.update(attention_bound(q, k, lens, causal,
                                               row["kernel"]))
                    row["bound_share"] = row["bound_ms"] / row["ms"]
        for row in (fwd, dq_row, dkv_row):
            ok &= row["ok"]
            rows.append(row)
            log("kernel", json.dumps(row))
    return ok, rows


def phase_path(torch, TransformerLM, kernels):
    """Full-width generate with the launch counts around it, then the
    full forward as the oracle of every greedy token."""
    t0 = time.perf_counter()
    model = TransformerLM(**FULL, device="cuda", seed=0).eval()
    torch.cuda.synchronize()
    log(f"path: model built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, FULL["vocab_size"], (BATCH, PROMPT),
                           generator=g).numpy()

    def timed_generate(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.generate(prompt, n)  # returns host ids: synchronised
        return out, time.perf_counter() - t

    timed_generate(2)  # warm-up: cuBLAS handles, allocator
    t_first = min(timed_generate(1)[1] for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, t_all = timed_generate(NEW)
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    decode_ms = (t_all - t_first) / (NEW - 1) * 1e3
    stats = dict(prefill_ms=t_first * 1e3, generate_ms=t_all * 1e3,
                 decode_ms_per_token=decode_ms,
                 tokens_per_s=BATCH * NEW / t_all,
                 launches=counts, peak_gib=peak_gib)
    log("path:", json.dumps(stats))
    ok = out.shape == (BATCH, PROMPT + NEW) and (out[:, :PROMPT]
                                                 == prompt).all()
    ok &= counts["flash_fwd"] >= FULL["n_layers"]
    if counts["flash_fwd"] < FULL["n_layers"]:
        log(f"path: FAIL flash_fwd launched {counts['flash_fwd']} times, "
            f"expected >= {FULL['n_layers']}")

    # oracle: token t of the stream is the argmax of the forward at the
    # position before it; positions whose top two log-probs lie within
    # 1e-4 are ties at f32 noise and are counted, not compared
    ids = torch.as_tensor(out[:, :PROMPT + NEW - 1], device="cuda")
    with torch.no_grad():
        logp = model(ids)[:, PROMPT - 1:]
    finite = bool(torch.isfinite(logp).all())
    top2 = logp.topk(2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    expect = top2.indices[..., 0].cpu().numpy()
    checked = (margin > 1e-4).cpu().numpy()
    mismatched = int(((expect != out[:, PROMPT:]) & checked).sum())
    oracle = dict(finite=finite, shape=list(logp.shape),
                  checked=int(checked.sum()), total=int(checked.size),
                  mismatched=mismatched)
    log("oracle:", json.dumps(oracle))
    ok &= (finite and mismatched == 0
           and oracle["checked"] >= oracle["total"] // 2)
    return bool(ok), stats


def percentile(values, q):
    import numpy as np
    return float(np.percentile(values, q)) if len(values) else None


def greedy_oracle(torch, model, prompts, outs):
    """Each greedy token against the argmax of the model's forward at the
    position before it, one request at a time: (checked, ties,
    mismatched), positions whose top two log-probs lie within TIE counted
    as ties and not compared."""
    checked = ties = mismatched = 0
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = torch.as_tensor(list(p) + list(o[:-1]), device=model.device)
            logp = model(ids[None])[0, len(p) - 1:]
            top2 = logp.topk(2, dim=-1)
            tie = (top2.values[:, 0] - top2.values[:, 1] <= TIE).cpu()
            bad = (top2.indices[:, 0].cpu()
                   != torch.as_tensor(o, dtype=torch.long)) & ~tie
            ties += int(tie.sum())
            checked += int((~tie).sum())
            mismatched += int(bad.sum())
    return checked, ties, mismatched


def compare_streams(torch, model, prompts, a, b):
    """Two runs' streams of the same greedy requests: (equal, tied,
    differing).  Where two streams part, the pick at the parting
    position must be a tie of the forward (top-2 gap within TIE), or the
    pair counts as differing."""
    equal = tied = differing = 0
    with torch.no_grad():
        for p, x, y in zip(prompts, a, b):
            x, y = list(x), list(y)
            if x == y:
                equal += 1
                continue
            j = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                     min(len(x), len(y)))
            ids = torch.as_tensor(list(p) + x[:j], device=model.device)
            top2 = model(ids[None])[0, -1].topk(2)
            if len(x) == len(y) and float(
                    top2.values[0] - top2.values[1]) <= TIE:
                tied += 1
            else:
                differing += 1
    return equal, tied, differing


def mixed_requests(cfg, rng):
    """The mixed stream's requests: SERVE["requests"] prompts of lengths
    drawn from 16-512, max_new cycling SERVE["max_new"]."""
    n = SERVE["requests"]
    lens = rng.integers(16, SERVE["buckets"][-1] + 1, n)
    prompts = [rng.integers(0, cfg["vocab_size"], int(L)) for L in lens]
    news = [SERVE["max_new"][i % len(SERVE["max_new"])] for i in range(n)]
    return prompts, news


def serve_stream(submit, prompts, news):
    """``prompts`` submitted from SERVE["threads"] threads at once through
    ``submit`` (``generate_stream`` or an engine's ``submit``): the
    outputs, the wall seconds, and each request's time to first token,
    inter-token gaps and time per output token after the first."""
    import threading
    n = len(prompts)
    streams = [None] * n
    errors = []
    go = threading.Event()

    def client(t):
        try:
            go.wait(10)
            mine = range(t, n, SERVE["threads"])
            for i in mine:
                streams[i] = submit(prompts[i], news[i])
            for i in mine:
                streams[i].result(timeout=120)
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE["threads"])]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    go.set()
    for t in threads:
        t.join(180)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    outs = [s.result(timeout=1) for s in streams]
    ttft = [s.t_tokens[0] - s.t_submit for s in streams]
    itl = [b - a for s in streams for a, b in zip(s.t_tokens, s.t_tokens[1:])]
    # time per output token after the first, per request
    tpot = [(s.t_tokens[-1] - s.t_tokens[0]) / (len(s.t_tokens) - 1)
            for s in streams if len(s.t_tokens) > 1]
    return outs, wall, ttft, itl, tpot


def stream_metrics(outs, wall, ttft, itl, tpot):
    """A served stream's end-to-end numbers (the serve line's keys)."""
    tokens = sum(len(o) for o in outs)
    return dict(
        requests=len(outs), generated_tokens=tokens, wall_s=wall,
        requests_per_s=len(outs) / wall, tokens_per_s=tokens / wall,
        ttft_ms_p50=percentile(ttft, 50) * 1e3,
        ttft_ms_p99=percentile(ttft, 99) * 1e3,
        itl_ms_p50=percentile(itl, 50) * 1e3,
        itl_ms_p99=percentile(itl, 99) * 1e3,
        tpot_ms_p50=percentile(tpot, 50) * 1e3,
        tpot_ms_p99=percentile(tpot, 99) * 1e3)


def fusion_timing(torch, submits, vocab, prompts, news):
    """Fused (step_fuse 4) against single-step dispatch, in turns fused,
    unfused, unfused, fused on one card: the mixed stream, then a steady
    decode with no admission in its way (capacity prompts of
    SERVE["steady_len"] tokens, SERVE["steady_new"] new tokens each),
    each run's tokens/s, TPOT p50 and TTFT p50.  Returns the unfused
    engine's first mixed-stream outputs too."""
    import numpy as np
    rng = np.random.default_rng(5)
    steady = [rng.integers(0, vocab, SERVE["steady_len"])
              for _ in range(SERVE["capacity"])]
    steady_new = [SERVE["steady_new"]] * len(steady)
    runs = {"fused": [], "unfused": []}
    first_unfused = None
    for name in ("fused", "unfused", "unfused", "fused"):
        row = {}
        for cell, (ps, ns) in (("mixed", (prompts, news)),
                               ("steady", (steady, steady_new))):
            outs, wall, ttft, itl, tpot = serve_stream(submits[name], ps, ns)
            m = stream_metrics(outs, wall, ttft, itl, tpot)
            row[cell] = dict(tokens_per_s=m["tokens_per_s"],
                             tpot_ms_p50=m["tpot_ms_p50"],
                             ttft_ms_p50=m["ttft_ms_p50"])
            if name == "unfused" and cell == "mixed" and first_unfused is None:
                first_unfused = outs
        runs[name].append(row)
    return runs, first_unfused


def step_times(torch, engine, reps=50):
    """Device ms of one replay of the engine's single-step graph and of
    its fused window (per token), and of the same step run eagerly, at
    the engine's capacity (the engine idle, its state don't-care)."""
    out = {}
    with engine._on_device():
        plans = {"step_ms": (engine._step_plan.graph.replay, 1),
                 "step_ms_eager": (engine._step_body, 1)}
        for k, plan in engine._stepk_plans.items():
            plans[f"window{k}_ms_per_token"] = (plan.graph.replay, k)
        for name, (fn, k) in plans.items():
            out[name] = cuda_ms(fn, reps) / k
    return out


def scaled_copy(torch, TransformerLM, cfg, scale, device):
    """The serve model's weights with every block weight scaled by
    ``scale``: a target its 0-layer draft agrees with often."""
    model = TransformerLM(**cfg, device=device, seed=0).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("attn_", "mlp_", "ln_attn", "ln_mlp")):
                p.mul_(scale)
    return model


def beam_check(torch, model, cfg, generation):
    """generate(num_beams) at the path phase's prompt and length, batch
    SERVE["beam_batch"]; then the plan's beams: descending scores, each
    within BEAM_TOL of the forward's summed log-probs of its tokens, and
    the first equal to generate's answer."""
    import numpy as np
    W, b = SERVE["beams"], SERVE["beam_batch"]
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg["vocab_size"], (b, PROMPT), generator=g)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = model.generate(prompt.numpy(), NEW, num_beams=W)
    beam_s = time.perf_counter() - t
    with torch.no_grad():
        seqs, scores = generation._backtrack_beams(
            *generation.build_beam_fn(PROMPT, NEW, W)(
                model, prompt.to(model.device)))
        ids = torch.cat([prompt.repeat_interleave(W, 0), torch.as_tensor(
            seqs.reshape(b * W, NEW), dtype=torch.long)], 1).to(model.device)
        logp = model(ids[:, :-1])[:, PROMPT - 1:]
        tok = ids[:, PROMPT:]
        ref = logp.gather(-1, tok[..., None])[..., 0].double().sum(-1)
    err = float(np.abs(ref.cpu().numpy().reshape(b, W) - scores).max())
    ok = (out.shape == (b, PROMPT + NEW)
          and (out[:, PROMPT:] == seqs[:, 0]).all()
          and bool((np.diff(scores, axis=1) <= 0).all()) and err <= BEAM_TOL)
    return bool(ok), dict(beams=W, batch=b, new=NEW, seconds=beam_s,
                          score_max_abs_err=err, scores=scores.tolist())


def predict_check(torch, keras, device="cuda"):
    """LeNet through to_serving(coalescing=True) from SERVE[
    "predict_threads"] threads of ragged 1-32-row batches, each result
    within PREDICT_TOL of a solo predict, one build per bucket."""
    import threading
    import numpy as np
    net = build_lenet(keras, device)
    coal = net.to_serving(supported_concurrent_num=2, max_batch_size=32,
                          coalescing=True, warmup_shapes=(28, 28, 1))
    solo = net.to_serving(max_batch_size=32)
    rng = np.random.default_rng(3)
    jobs = [rng.normal(size=(int(rng.integers(1, 33)), 28, 28, 1)).astype(
        np.float32) for _ in range(SERVE["predict_threads"]
                                   * SERVE["predict_requests"])]
    results = [None] * len(jobs)
    errors = []

    def client(t):
        try:
            for i in range(t, len(jobs), SERVE["predict_threads"]):
                results[i] = coal.predict(jobs[i])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE["predict_threads"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    wall = time.perf_counter() - t0
    try:
        if errors:
            raise errors[0]
        err = max(float(np.abs(r - solo.predict(x)).max())
                  for r, x in zip(results, jobs))
        stats = coal.serving_stats()
    finally:
        coal.close()
        solo.close()
    ok = (err <= PREDICT_TOL
          and set(stats["misses"].values()) == {1}
          and set(stats["misses"]) == set(stats["buckets"]))
    return bool(ok), dict(requests=len(jobs), rows=sum(len(x) for x in jobs),
                          seconds=wall, max_abs_err=err,
                          dispatches=stats["dispatches"],
                          misses=stats["misses"])


def phase_serve(torch, TransformerLM, keras, kernels, inference,
                generation, device="cuda"):
    """The serving plane at full width (SERVE): the mixed stream with
    the launch counts read around it, step times, then the fused,
    prefix, speculative, predict and beam checks.  What it holds is
    freed before the next phase, lest it stand in that phase's peak
    memory: its engines and models (a plan's body closes over its
    engine, so they live in reference cycles until a collection), and
    the cuBLAS workspace PyTorch keeps for each stream it ran a GEMM on
    (every engine and coalescer runs on a stream of its own)."""
    import gc
    try:
        return serve_checks(torch, TransformerLM, keras, kernels, inference,
                            generation, device)
    finally:
        gc.collect()
        if device == "cuda":
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()


def serve_checks(torch, TransformerLM, keras, kernels, inference,
                 generation, device):
    import numpy as np
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    model = TransformerLM(**cfg, device=device, seed=0).eval()
    handle = inference.InferenceModel(
        decode_capacity=SERVE["capacity"], decode_max_len=SERVE["max_len"],
        decode_prompt_buckets=SERVE["buckets"],
        decode_prefix_pool=SERVE["pool"])
    t = time.perf_counter()
    handle.load_keras_net(model)
    warm_s = time.perf_counter() - t
    engine = handle.decode_engine
    before = engine.stats()
    rng = np.random.default_rng(2)
    checks, stats = {}, {}
    try:
        prompts, news = mixed_requests(cfg, rng)
        kernels.reset_launch_counts()
        outs, wall, ttft, itl, tpot = serve_stream(handle.generate_stream,
                                                   prompts, news)
        launches = kernels.launch_counts()
        after = engine.stats()
        admitted = after["admitted"] - before["admitted"]
        computed = admitted - (after["prefix_hits"] - before["prefix_hits"])
        tokens = sum(len(o) for o in outs)
        checked, ties, mismatched = greedy_oracle(torch, model, prompts,
                                                  outs)
        checks["mixed"] = (
            all(len(o) == m for o, m in zip(outs, news))
            and mismatched == 0 and checked >= tokens // 2
            and launches["flash_fwd"] == cfg["n_layers"] * admitted
            and computed == admitted
            and after["captures"] == before["captures"])
        stats.update(stream_metrics(outs, wall, ttft, itl, tpot))
        stats.update(
            oracle=dict(checked=checked, ties=ties, mismatched=mismatched),
            admitted=admitted, flash_fwd_launches=launches["flash_fwd"],
            launches=launches, captures=after["captures"],
            captures_at_warmup=before["captures"], warmup_s=warm_s,
            steps=after["steps"] - before["steps"],
            fused_dispatches=(after["fused_dispatches"]
                              - before["fused_dispatches"]))
        stats.update(step_times(torch, engine))

        # the same requests one step a dispatch, timed against the fused
        # handle
        unfused = inference.DecodeEngine(
            model, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"], prefix_pool=SERVE["pool"],
            step_fuse=1)
        try:
            unfused.warmup()
            stats["fusion"], unfused_outs = fusion_timing(
                torch, {"fused": handle.generate_stream,
                        "unfused": unfused.submit}, cfg["vocab_size"],
                prompts, news)
            res = compare_streams(torch, model, prompts, outs, unfused_outs)
        finally:
            unfused.close()
        stats["fused_vs_unfused"] = dict(zip(("equal", "tied",
                                              "differing"), res))
        checks["fused"] = res[2] == 0

        # a shared 256-token prefix, pool on (the handle) and off
        head = rng.integers(0, cfg["vocab_size"], SERVE["prefix_len"])
        pp = [np.concatenate([head, rng.integers(0, cfg["vocab_size"],
                                                 int(u))])
              for u in rng.integers(1, SERVE["prefix_tail"],
                                    SERVE["prefix_requests"])]
        pn = [8 if i % 8 == 7 else 2 for i in range(len(pp))]
        s0 = engine.stats()
        on = handle.generate(pp, pn, timeout=120)
        s1 = engine.stats()
        plain = inference.DecodeEngine(
            model, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"])
        try:
            plain.warmup()
            kernels.reset_launch_counts()
            off = plain.generate(pp, pn, timeout=120)
            off_launches = kernels.launch_counts()["flash_fwd"]
            off_prefills = plain.stats()["prefills"]
        finally:
            plain.close()
        res = compare_streams(torch, model, pp, on, off)
        misses = s1["prefix_misses"] - s0["prefix_misses"]
        stats["prefix"] = dict(zip(("equal", "tied", "differing"), res),
                               misses=misses,
                               hits=s1["prefix_hits"] - s0["prefix_hits"],
                               pool_off_prefills=off_prefills,
                               pool_off_flash_fwd=off_launches)
        checks["prefix"] = (res[2] == 0 and misses == 1
                            and off_prefills == len(pp)
                            and off_launches == cfg["n_layers"] * len(pp))
    finally:
        handle.close()
    del handle, engine

    # speculative decoding against the plain engine, same weights
    target = scaled_copy(torch, TransformerLM, cfg, SERVE["spec_scale"],
                         device)
    sp = prompts[:SERVE["spec_requests"]]
    sn = [SERVE["spec_new"]] * len(sp)
    runs, window_ms = {}, None
    for name, draft in (("spec", inference.skeleton_draft(target)),
                        ("plain", None)):
        eng = inference.DecodeEngine(
            target, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"], draft=draft,
            spec_tokens=SERVE["spec_tokens"])
        try:
            eng.warmup()
            t = time.perf_counter()
            runs[name] = (eng.generate(sp, sn, timeout=120),
                          time.perf_counter() - t, eng.stats())
            if draft is not None and device == "cuda":
                with eng._on_device():
                    window_ms = cuda_ms(eng._spec_plan.graph.replay, 20)
        finally:
            eng.close()
    res = compare_streams(torch, target, sp, runs["spec"][0],
                          runs["plain"][0])
    st = runs["spec"][2]
    stats["spec"] = dict(zip(("equal", "tied", "differing"), res),
                         acceptance=st["spec_acceptance"],
                         windows=st["spec_windows"],
                         window_ms=window_ms,
                         spec_s=runs["spec"][1], plain_s=runs["plain"][1])
    checks["spec"] = res[2] == 0 and st["spec_windows"] > 0
    del target

    checks["predict"], stats["predict"] = predict_check(torch, keras,
                                                        device)
    checks["beam"], stats["beam"] = beam_check(torch, model, cfg,
                                               generation)
    stats["checks"] = checks
    stats["card"] = smi_card()
    log("serve:", json.dumps(stats))
    for name, ok in checks.items():
        if not ok:
            log(f"serve: FAIL {name}")
    return all(checks.values()), stats


def periodic_tokens(n, vocab, seq, seed):
    """The periodic next-token task of tests/test_transformer_lm.py:
    token[t] = (start + step * t) % vocab, step in 1..3 per sequence."""
    import numpy as np
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, n)
    start = rng.integers(0, vocab, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def gradient_check(torch, model, objectives, x, y):
    """One backward through the kernels and one through blockwise
    attention, same weights and batch: per parameter tensor
    max|diff| / max|blockwise|."""
    attns = [getattr(model, f"attn_{i}")
             for i in range(model.hyper["n_layers"])]
    params = [p for p in model.parameters() if p.requires_grad]
    ids = torch.as_tensor(x, device="cuda")
    labels = torch.as_tensor(y, device="cuda")
    grads = {}
    try:
        for impl in ("flash", "blockwise"):
            for a in attns:
                a.implementation = impl
            loss = objectives.class_nll(labels, model(ids)).mean()
            grads[impl] = torch.autograd.grad(loss, params)
            del loss
    finally:
        for a in attns:
            a.implementation = "auto"
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(grads["flash"], grads["blockwise"])]


def phase_train(torch, TransformerLM, kernels, objectives):
    """Full-width compile/fit: a warm-up fit, then TRAIN_STEPS fits of one
    step each (each ends synchronised: fit reads its losses back), with
    the launch counts read around them; then the gradient check."""
    import statistics
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                  metrics=["accuracy"])
    x, y = periodic_tokens(TRAIN_BATCH * (TRAIN_STEPS + 1),
                           cfg["vocab_size"], TRAIN_SEQ, seed=1)
    model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH], batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    log(f"train: model built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(1, TRAIN_STEPS + 1):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        t = time.perf_counter()
        hist = model.fit(x[rows], y[rows], batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses += hist["loss"]
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = statistics.median(step_s)
    stats = dict(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step,
                 peak_gib=peak_gib, losses=losses, launches=counts,
                 launches_per_step={n: c / TRAIN_STEPS
                                    for n, c in counts.items()})
    log("train:", json.dumps(stats))
    ok = (len(losses) == TRAIN_STEPS
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0])
    for name in KERNELS:
        if counts[name] < cfg["n_layers"] * TRAIN_STEPS:
            ok = False
            log(f"train: FAIL {name} launched {counts[name]} times in "
                f"{TRAIN_STEPS} steps, expected >= {cfg['n_layers']} a "
                "step")
    errs = gradient_check(torch, model, objectives, x[:2], y[:2])
    stats["grad_max_rel_err"] = max(errs)
    log(f"train: gradient check against blockwise over {len(errs)} "
        f"tensors, max rel err {max(errs):.3g} (tol {GRAD_TOL})")
    ok &= max(errs) <= GRAD_TOL
    return bool(ok), stats


def phase_small(torch, TransformerLM, from_jax_params, to_jax_params):
    """A small model on the card against the same weights on the CPU:
    predict log-probs within 1e-4, equal greedy streams, and the losses
    of 3 adam steps within 1e-4."""
    small = dict(vocab_size=59, seq_len=32, n_layers=2, d_model=32,
                 n_heads=2)
    gpu = TransformerLM(**small, device="cuda", seed=3).eval()
    cpu = TransformerLM(**small, device="cpu", seed=4).eval()
    from_jax_params(cpu, to_jax_params(gpu))
    rng = torch.Generator().manual_seed(5)
    x = torch.randint(0, 59, (3, 32), generator=rng).numpy()
    err = float(abs(gpu.predict(x, 3) - cpu.predict(x, 3)).max())
    prompt = x[:, :8]
    same = (gpu.generate(prompt, 6) == cpu.generate(prompt, 6)).all()
    lens = [8, 5, 3]
    same &= (gpu.generate(prompt, 6, prompt_lengths=lens)
             == cpu.generate(prompt, 6, prompt_lengths=lens)).all()
    log(f"small: predict max abs err {err:.3g} (tol 1e-4), greedy streams "
        f"equal: {bool(same)}")
    xt, yt = periodic_tokens(24, 59, 32, seed=6)
    fits = []
    for m in (gpu, cpu):
        m.compile({"name": "adam", "lr": 3e-3}, "class_nll")
        fits.append(m.fit(xt, yt, batch_size=8)["loss"])
    loss_err = max(abs(a - b) for a, b in zip(*fits))
    log(f"small: 3 training steps, losses {fits[0]} (card) {fits[1]} (CPU), "
        f"max abs diff {loss_err:.3g} (tol 1e-4)")
    return (err <= 1e-4 and bool(same) and len(fits[0]) == 3
            and loss_err <= 1e-4)


def smi_card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: no output"


def lenet_blobs(n, seed, classes=10):
    """tests/test_lenet_e2e.py's make_data: class-dependent blobs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    for i in range(n):
        x[i, 2 * y[i]:2 * y[i] + 3, 2 * y[i]:2 * y[i] + 3, 0] += 2.0
    return x, y.astype(np.int32)


def build_lenet(keras, device, seed=0):
    """tests/test_lenet_e2e.py's LeNet, unchanged but for the device."""
    L = keras.layers
    model = keras.Sequential(device=device, seed=seed)
    model.add(L.Convolution2D(6, 5, 5, activation="relu",
                              border_mode="same", input_shape=(28, 28, 1)))
    model.add(L.MaxPooling2D())
    model.add(L.Convolution2D(16, 5, 5, activation="relu"))
    model.add(L.MaxPooling2D())
    model.add(L.Flatten())
    model.add(L.Dense(120, activation="relu"))
    model.add(L.Dropout(0.1))
    model.add(L.Dense(84, activation="relu"))
    model.add(L.Dense(10, activation="softmax"))
    return model


def phase_lenet(torch, keras, kernels, tmp):
    """LeNet on the card: fit with validation (losses fall, accuracy above
    0.5), predict (rows sum to 1 within 1e-4, the CPU's answer on the
    same weights within 1e-4), predict_classes, evaluate (accuracy and
    top5accuracy), save_model/load_model and to_model (predictions within
    1e-6); then LENET_TIMED_STEPS synchronised one-step fits, timed."""
    import statistics
    import numpy as np
    x, y = lenet_blobs(LENET_N, seed=0)
    xv, yv = lenet_blobs(128, seed=1)
    model = build_lenet(keras, "cuda")
    model.compile(optimizer={"name": "adam", "lr": 1e-3},
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "top5accuracy"])
    kernels.reset_launch_counts()
    hist = model.fit(x, y, batch_size=LENET_BATCH, nb_epoch=LENET_EPOCHS,
                     validation_data=(xv, yv))
    counts = kernels.launch_counts()
    losses, val = hist["loss"], hist["val"]
    probs = model.predict(x[:100], batch_size=LENET_BATCH)
    row_err = float(abs(probs.sum(axis=1) - 1).max())
    classes = model.predict_classes(x[:100])
    results = model.evaluate(x, y, batch_size=LENET_BATCH)
    cpu = build_lenet(keras, "cpu", seed=1)
    cpu.set_weights(model.get_weights())
    cpu_err = float(abs(cpu.predict(x[:100], LENET_BATCH) - probs).max())
    model.save_model(os.path.join(tmp, "lenet"))
    loaded = keras.load_model(os.path.join(tmp, "lenet"), device="cuda")
    load_err = float(abs(loaded.predict(x[:100], LENET_BATCH)
                         - probs).max())
    model_err = float(abs(model.to_model().predict(x[:100], LENET_BATCH)
                          - probs).max())

    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(LENET_TIMED_STEPS):
        rows = slice((i % (LENET_N // LENET_BATCH)) * LENET_BATCH,
                     (i % (LENET_N // LENET_BATCH) + 1) * LENET_BATCH)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.fit(x[rows], y[rows], batch_size=LENET_BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    step = statistics.median(step_s)
    stats = dict(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 images_per_s=LENET_BATCH / step,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 card=smi_card(), losses_first_last=[losses[0], losses[-1]],
                 steps=len(losses), val=val, evaluate=results,
                 row_sum_err=row_err, cpu_err=cpu_err,
                 load_model_err=load_err, to_model_err=model_err,
                 launches=counts)
    log("lenet:", json.dumps(stats))
    ok = (len(losses) == LENET_EPOCHS * (LENET_N // LENET_BATCH)
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0]
          and len(val) == LENET_EPOCHS and val[-1]["accuracy"] > 0.5
          and probs.shape == (100, 10) and row_err <= 1e-4
          and classes.shape == (100,)
          and set(results) >= {"accuracy", "top5accuracy", "loss"}
          and cpu_err <= 1e-4 and load_err <= 1e-6 and model_err <= 1e-6
          and all(p.is_cuda for p in loaded.parameters()))
    return bool(ok), stats


def build_attention_model(keras, impl, seed=0):
    L = keras.layers
    x = L.Input((GRAPH["seq"],))
    h = L.Embedding(GRAPH["vocab"], GRAPH["d_model"])(x)
    h = L.PositionalEmbedding(GRAPH["seq"])(h)
    h = L.LayerNorm()(h)
    h = L.MultiHeadSelfAttention(GRAPH["n_heads"], causal=True,
                                 implementation=impl)(h)
    y = L.Dense(GRAPH["vocab"], activation="log_softmax")(h)
    return keras.Model(input=x, output=y, device="cuda", seed=seed)


def phase_graph(torch, keras, kernels):
    """The functional attention Model: GRAPH["steps"] synchronised
    one-step fits, each of which must launch the flash forward, dq and
    dk/dv kernels (the counts read around each); then predict under
    flash against predict under blockwise on the same weights, within
    1e-4."""
    import numpy as np
    model = build_attention_model(keras, "flash")
    attn = [l for l in model.to_graph().layers
            if type(l).__name__ == "MultiHeadSelfAttention"]
    model.compile({"name": "adam", "lr": 3e-4}, "class_nll")
    x, y = periodic_tokens(GRAPH["batch"] * (GRAPH["steps"] + 1),
                           GRAPH["vocab"], GRAPH["seq"], seed=2)
    b = GRAPH["batch"]
    model.fit(x[:b], y[:b], batch_size=b)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    per_step, losses, step_s = [], [], []
    for i in range(1, GRAPH["steps"] + 1):
        before = kernels.launch_counts()
        t = time.perf_counter()
        losses += model.fit(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b],
                            batch_size=b)["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    flash = model.predict(x[:b], batch_size=b)
    try:
        for layer in attn:
            layer.implementation = "blockwise"
        plain = model.predict(x[:b], batch_size=b)
    finally:
        for layer in attn:
            layer.implementation = "flash"
    err = float(np.abs(flash - plain).max())
    stats = dict(step_ms_all=[t * 1e3 for t in step_s], losses=losses,
                 launches=counts, launches_per_step=per_step,
                 peak_gib=peak_gib, predict_vs_blockwise_max_abs_err=err,
                 shape=list(flash.shape))
    log("graph:", json.dumps(stats))
    ok = (len(attn) == 1 and len(losses) == GRAPH["steps"]
          and all(math.isfinite(v) for v in losses)
          and all(step[n] >= 1 for step in per_step for n in KERNELS)
          and flash.shape == (b, GRAPH["seq"], GRAPH["vocab"])
          and bool(np.isfinite(flash).all()) and err <= 1e-4)
    return bool(ok), stats


def initial_weights(torch, TransformerLM, cfg):
    model = TransformerLM(**cfg, device="cuda", seed=0)
    return [p.detach().clone() for p in model.parameters()]


def accumulation_check(torch, TransformerLM, x, y):
    """At f32 and ACCUM_LAYERS layers, one ACCUM_OPTIMIZER step with
    accum_steps=2 and one with accum_steps=1, from the same seeded
    weights and batch: the losses within ACCUM_TOL["loss_rtol"], every
    weight within isclose(rtol, atol)."""
    cfg = dict(FULL, seq_len=TRAIN_SEQ, n_layers=ACCUM_LAYERS)
    runs = {}
    for accum in (1, MIXED_ACCUM):
        model = TransformerLM(**cfg, device="cuda", seed=0)
        model.compile(ACCUM_OPTIMIZER, "class_nll", accum_steps=accum)
        loss = model.fit(x, y, batch_size=len(x))["loss"]
        runs[accum] = (loss, [p.detach().clone()
                              for p in model.parameters()])
        del model
    (l1, w1), (l2, w2) = runs[1], runs[MIXED_ACCUM]
    loss_err = abs(l2[0] - l1[0]) / abs(l1[0])
    bad = sum(int((~torch.isclose(b, a, rtol=ACCUM_TOL["rtol"],
                                  atol=ACCUM_TOL["atol"])).sum())
              for a, b in zip(w1, w2))
    weight_err = max(float((b - a).abs().max()) for a, b in zip(w1, w2))
    moved = max(float((a - b).abs().max())
                for a, b in zip(w1, initial_weights(torch, TransformerLM,
                                                    cfg)))
    stats = dict(losses={"accum_1": l1, f"accum_{MIXED_ACCUM}": l2},
                 loss_rel_err=loss_err, weights_outside_tol=bad,
                 weight_max_abs_err=weight_err,
                 largest_weight_move=moved, optimizer=ACCUM_OPTIMIZER,
                 tol=ACCUM_TOL)
    # the step must move the weights well past the bound, or the
    # comparison says nothing
    ok = (len(l1) == len(l2) == 1 and loss_err <= ACCUM_TOL["loss_rtol"]
          and bad == 0 and moved > 10 * ACCUM_TOL["atol"])
    return ok, stats


def phase_mixed(torch, TransformerLM, kernels, f32_losses):
    """The train phase's model and data at bf16 compute with
    MIXED_ACCUM microbatches a step: a warm-up fit, then TRAIN_STEPS
    synchronised one-step fits with the launch counts by dtype read
    around them; then the accumulation check at f32."""
    import statistics
    import numpy as np
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                  compute_dtype=torch.bfloat16, accum_steps=MIXED_ACCUM)
    x, y = periodic_tokens(TRAIN_BATCH * (TRAIN_STEPS + 1),
                           cfg["vocab_size"], TRAIN_SEQ, seed=1)
    model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH], batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    log(f"mixed: model built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(1, TRAIN_STEPS + 1):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        t = time.perf_counter()
        hist = model.fit(x[rows], y[rows], batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses += hist["loss"]
    counts = kernels.launch_counts_by_dtype()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    adam = model.trainer.state.opt_state.states[0]
    f32_state = (all(p.dtype == torch.float32 for p in model.parameters())
                 and all(t.dtype == torch.float32
                         for t in adam["mu"] + adam["nu"]))
    step = statistics.median(step_s)
    per_step = cfg["n_layers"] * MIXED_ACCUM
    stats = dict(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step,
                 peak_gib=peak_gib, losses=losses, f32_losses=f32_losses,
                 launches=counts,
                 launches_per_step={n: c / TRAIN_STEPS
                                    for n, c in counts.items()},
                 f32_master_weights_and_moments=f32_state,
                 accum_steps=MIXED_ACCUM, card=smi_card())
    del model, adam
    torch.cuda.empty_cache()
    ok = (len(losses) == TRAIN_STEPS
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0] and f32_state)
    for name in KERNELS:
        if (counts[f"{name}[bf16]"] < per_step * TRAIN_STEPS
                or counts[f"{name}[f32]"]):
            ok = False
            log(f"mixed: FAIL {name} launched {counts[f'{name}[bf16]']} "
                f"times at bf16 and {counts[f'{name}[f32]']} at f32 in "
                f"{TRAIN_STEPS} steps, expected >= {per_step} a step at "
                "bf16 and none at f32")
    if not f32_losses or len(f32_losses) != len(losses) or not np.allclose(
            losses, f32_losses, **MIXED_LOSS_TOL):
        ok = False
        log(f"mixed: FAIL losses {losses} do not track the train phase's "
            f"f32 losses {f32_losses} within {MIXED_LOSS_TOL}")
    rows = slice(TRAIN_BATCH, 2 * TRAIN_BATCH)
    accum_ok, stats["accumulation"] = accumulation_check(
        torch, TransformerLM, x[rows], y[rows])
    log("mixed:", json.dumps(stats))
    return bool(ok and accum_ok), stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from analytics_zoo_tpu_torch.models import (
            TransformerLM, from_jax_params, to_jax_params)
        from analytics_zoo_tpu_torch.models import generation
        from analytics_zoo_tpu_torch.pipeline import inference
        from analytics_zoo_tpu_torch.ops import _kernels as kernels
        from analytics_zoo_tpu_torch.ops import attention as ops_attn
        from analytics_zoo_tpu_torch.pipeline.api import keras
        from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    except ImportError as e:
        print(f"chip_smoke: analytics_zoo_tpu_torch is not importable "
              f"beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # saved models go under build/ (git ignores it), beside the kernels
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    failed = []

    t0 = time.perf_counter()
    try:
        kernels.build()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        for line in kernels.LIBRARY.build_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log("build:", line.strip())
        sass = sass_counts(kernels)
    except (RuntimeError, subprocess.SubprocessError) as e:
        log(f"build: FAIL {e}")
        return 1
    log("build: sass", json.dumps(sass))
    # the kernels' design: tensor-core MMA and cp.async in every
    # instantiation, no atomics, and ldmatrix in the forward (its Q.K^T
    # operands at both dtypes, P.V's V at bf16)
    bad = [fn for fn, c in (sass or {}).items() if "_kernel<" in fn and (
        not c["HMMA"] or not c["LDGSTS"] or c["ATOM"] or c["RED"]
        or ("fwd" in fn and not c["LDSM"]))]
    missing = [k for k in KERNELS
               if sass is not None and not any(f"{k}_kernel<" in fn
                                               for fn in sass)]
    if bad or missing:
        log(f"build: FAIL instantiations off their design: {bad}; "
            f"kernels not found: {missing}")
        return 1

    phases = [
        ("kernels", lambda: phase_kernels(torch, ops_attn, kernels)),
        ("path", lambda: phase_path(torch, TransformerLM, kernels)),
        ("serve", lambda: phase_serve(torch, TransformerLM, keras, kernels,
                                      inference, generation)),
        ("train", lambda: phase_train(torch, TransformerLM, kernels,
                                      objectives)),
        ("small", lambda: (phase_small(torch, TransformerLM,
                                       from_jax_params, to_jax_params),
                           None)),
        ("lenet", lambda: phase_lenet(torch, keras, kernels, tmp)),
        ("graph", lambda: phase_graph(torch, keras, kernels)),
        ("mixed", lambda: phase_mixed(
            torch, TransformerLM, kernels,
            (results.get("train") or {}).get("losses"))),
    ]
    results = {}
    for name, run in phases:
        t = time.perf_counter()
        try:
            ok, results[name] = run()
        except Exception as e:  # a phase's crash fails that phase only
            import traceback
            traceback.print_exc()
            ok = False
            log(f"{name}: raised {type(e).__name__}: {e}")
        log(f"phase {name}: {'ok' if ok else 'FAIL'} "
            f"({time.perf_counter() - t:.1f} s)")
        if not ok:
            failed.append(name)

    log(smi_card())

    # every kernel at the shape of the mixed phase's microbatch, bf16,
    # with its launches there; the f32 numbers at the training shape and
    # each path's own count beside them
    path_launches = {
        path: (results.get(path) or {}).get("launches") or {}
        for path in ("path", "serve", "train", "graph", "mixed")}

    def timed_row(name, case, dtype, sq=None):
        row = next((r for r in results.get("kernels") or []
                    if r["kernel"] == name and r["case"] == case
                    and r["dtype"] == dtype and r.get("ms") is not None
                    and sq in (None, r["sq"])), None)
        if row is None:
            return {}
        return dict(max_abs_err=row["abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    bound_f32_cuda_ms=row["bound_f32_cuda_ms"],
                    library_ms=row["library_ms"],
                    library_backend=row["library_backend"],
                    shape=[row["bh"], row["sq"], row["d"]], dtype=dtype)

    entries = []
    for name, (source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": path_launches["mixed"].get(f"{name}[bf16]", 0),
                 "launches_by_path": {
                     "generate": path_launches["path"].get(name, 0),
                     "serve": path_launches["serve"].get(name, 0),
                     "train": path_launches["train"].get(name, 0),
                     "graph": path_launches["graph"].get(name, 0),
                     "mixed": path_launches["mixed"].get(f"{name}[bf16]",
                                                         0)}}
        entry.update(timed_row(name, "mixed", "bfloat16"))
        entry["f32"] = timed_row(name, "train", "float32")
        entry["bf16_batch8"] = timed_row(name, "train", "bfloat16")
        if name == "flash_fwd":  # the serve phase's prefill shapes
            entry["serve"] = [timed_row(name, "serve admit", "float32", s)
                              for s in SERVE["buckets"]]
        entries.append(entry)
    log(json.dumps({"kernels": entries}))
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
