#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (analytics_zoo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero):

1. build: compile every CUDA kernel of the port from ``ops/csrc``;
2. kernels: hold each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge cases, and time the
   kernel, the plain version and one PyTorch library call that computes
   the same function (a yardstick only; the port never calls it);
3. path: ``TransformerLM.generate`` at full width (12 layers, d_model 768,
   12 heads, vocab 32000; batch 8, prompt 512, 128 greedy tokens) from
   seeded random weights, with the kernel launch counts read around it,
   then the full forward as an oracle for every greedy token;
4. small: a small model on the card against the same weights on the CPU.

The line before the last is a JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

F32_PEAK = 67e12      # FLOP/s, H100 SXM, f32 outside the tensor cores
BF16_PEAK = 989e12    # FLOP/s, H100 SXM, dense bf16 tensor cores
HBM_RATE = 3.35e12    # bytes/s, H100 SXM
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # o; the f32 lse uses 1e-4

FULL = dict(vocab_size=32000, seq_len=1024, n_layers=12, d_model=768,
            n_heads=12, d_ff=3072)
BATCH, PROMPT, NEW = 8, 512, 128


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


def attention_bound(q, k, lens, causal):
    """(ms, "bytes" or "operations"): the least time for this call's work.
    Operations: 4*d per valid (query, key) pair (two products); bytes:
    q and o, the keys and values each row may see, lse and lens."""
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
    ops = 4.0 * d * pairs
    keys = float(per_bh.sum())
    item = q.element_size()
    nbytes = (2 * bh * sq * d * item + 2 * keys * d * item + bh * sq * 4
              + (0 if lens is None else bh * 4))
    peak = F32_PEAK if q.dtype == torch.float32 else BF16_PEAK
    t_ops, t_bytes = ops / peak, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_call(q, k, v, lens, causal, scale):
    import torch
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    if lens is None and (not causal or sq == sk):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril(sk - sq)
    mask = mask[None]
    if lens is not None:
        mask = mask & (torch.arange(sk, device=q.device)[None, None, :]
                       < lens[:, None, None])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)


def phase_kernels(torch, ops_attn, kernels):
    """Each flash_fwd case against flash_attention_reference."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # name, bh, sq, sk, d, dtype, causal, with lens, timed
        ("prefill", 96, 512, 512, 64, torch.float32, True, False, True),
        ("predict", 96, 1024, 1024, 64, torch.float32, True, False, True),
        ("prefill", 96, 512, 512, 64, torch.bfloat16, True, False, True),
        ("predict", 96, 1024, 1024, 64, torch.bfloat16, True, False, True),
        ("cross causal", 24, 192, 512, 64, torch.float32, True, False,
         False),
        ("cross", 24, 200, 777, 64, torch.float32, False, False, False),
        ("kv_lengths", 24, 512, 512, 64, torch.float32, True, True, False),
        ("kv_lengths", 24, 300, 300, 64, torch.bfloat16, False, True,
         False),
        ("prime", 12, 37, 37, 64, torch.float32, True, False, False),
        ("prime d128", 12, 251, 251, 128, torch.float32, False, True,
         False),
        ("d128", 24, 384, 384, 128, torch.bfloat16, True, False, False),
        ("d16", 4, 40, 40, 16, torch.float32, True, False, False),
    ]
    rows, ok = [], True
    for name, bh, sq, sk, d, dtype, causal, masked, timed in cases:
        q = torch.randn((bh, sq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((bh, sk, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((bh, sk, d), generator=g, device="cuda").to(dtype)
        lens = None
        if masked:
            lens = torch.randint(1, sk + 1, (bh,), generator=g,
                                 device="cuda").float()
        scale = d ** -0.5
        o, lse = kernels.flash_fwd(q, k, v, lens, causal, scale)
        o_ref, lse_ref = ops_attn.flash_attention_reference(
            q, k, v, causal, scale, lens)
        torch.cuda.synchronize()
        err_o = float((o.double() - o_ref.double()).abs().max())
        err_l = float((lse - lse_ref).abs().max())
        dt = str(dtype).replace("torch.", "")
        good = (err_o <= TOL[dt] and err_l <= 1e-4
                and bool(torch.isfinite(o).all()))
        ok &= good
        row = dict(case=name, dtype=dt, bh=bh, sq=sq, sk=sk, d=d,
                   causal=causal, lens=masked, err_o=err_o, err_lse=err_l,
                   ok=good)
        if timed:
            row["ms"] = cuda_ms(
                lambda: kernels.flash_fwd(q, k, v, lens, causal, scale), 20)
            row["plain_ms"] = cuda_ms(
                lambda: ops_attn.flash_attention_reference(
                    q, k, v, causal, scale, lens), 3)
            row["library_ms"] = cuda_ms(
                sdpa_call(q, k, v, lens, causal, scale), 20)
            row["bound_ms"], row["bound_by"] = attention_bound(
                q, k, lens, causal)
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


def phase_small(torch, TransformerLM, from_jax_params, to_jax_params):
    """A small model on the card against the same weights on the CPU:
    predict log-probs within 1e-4 and equal greedy streams."""
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
    return err <= 1e-4 and bool(same)


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
        from analytics_zoo_tpu_torch.ops import _kernels as kernels
        from analytics_zoo_tpu_torch.ops import attention as ops_attn
    except ImportError as e:
        print(f"chip_smoke: analytics_zoo_tpu_torch is not importable "
              f"beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    failed = []

    t0 = time.perf_counter()
    try:
        kernels.build()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        for line in kernels.LIBRARY.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("build:", line.strip())
    except RuntimeError as e:
        log(f"build: FAIL {e}")
        return 1

    phases = [
        ("kernels", lambda: phase_kernels(torch, ops_attn, kernels)),
        ("path", lambda: phase_path(torch, TransformerLM, kernels)),
        ("small", lambda: (phase_small(torch, TransformerLM,
                                       from_jax_params, to_jax_params),
                           None)),
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")

    main_row = next((r for r in results.get("kernels") or []
                     if r.get("ms") is not None
                     and r["dtype"] == "float32" and r["sq"] == PROMPT),
                    None)
    launches = ((results.get("path") or {}).get("launches") or {})
    entry = {"name": "flash_fwd", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu",
             "replaces": "analytics_zoo_tpu/ops/attention.py:149",
             "launches": launches.get("flash_fwd", 0)}
    if main_row is not None:
        entry.update(max_abs_err=main_row["err_o"], ms=main_row["ms"],
                     plain_ms=main_row["plain_ms"],
                     bound_ms=main_row["bound_ms"],
                     bound_by=main_row["bound_by"],
                     library_ms=main_row["library_ms"])
    log(json.dumps({"kernels": [entry]}))
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
