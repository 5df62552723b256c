#!/usr/bin/env python3
"""Where the sm90 flash backward's time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_flash_bwd.py [--dtype bf16|f32]

Copies the package under ``build/flash_bwd_ablate/`` once a variant,
each with one part of the sm90 kernels at the chosen dtype removed from
``flash_bwd_sm90.cu`` by a text substitution (the exp2 of p; one of the
products: S = Q.K^T, dP = dO.V^T, the output products dQ, dV, dK, whose
removal keeps the packed or split operand alive; the second consumer
warpgroup, which f32's dk/dv never has; at f32 also the converting
warps' work, the transposes and the TF32 splits of each walked tile,
fewer converting warps in dk/dv, and the raw tiles rewritten as their
hi parts),
builds them all at once (``profile_torch_flash_fwd.ablate``) and prints
the device ms of ``flash_bwd_dq`` and ``flash_bwd_dkv`` in each
(``chip_smoke.device_ms``: replayed from a CUDA graph, the median of
three replays) at bf16 (48, 2048, 64) or f32 (96, 2048, 64) causal,
twice in turns, then the card's name and power limit.
The variants' outputs are wrong by construction; the times say what each
part costs.  The kernels' per-case checks and times at both designs are
``chip_smoke.py --phases kernels``.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = os.path.join("analytics_zoo_tpu_torch", "ops", "csrc",
                      "flash_bwd_sm90.cu")


def _fill(name, n=32):
    """A stand-in for a removed S or dP product: its ``n`` accumulators
    filled with values the rest of the tile reads."""
    return (f"#pragma unroll\n      for (int i = 0; i < {n}; ++i) {name}[i] "
            "= 0.01f * i;")


def _kept(acc, *parts):
    """A stand-in for a removed output product: its packed (bf16) or split
    (f32) operand added into the sums, so that the work forming it
    stays."""
    return "\n".join(
        f"#pragma unroll\n      for (int i = 0; i < DP / 2; ++i) "
        f"{acc}[i] += __uint_as_float({a}[(i / 4) % 4][i % 4]);"
        for a in parts)


#: the f32 kernels' parts, as ``ablation_sources``'s at bf16
F32_SUBS = {
    "no_exp2": [("flash::exp2_ftz(", "(")],
    "no_qk": [("      abt3<C>(sc, Qw, Kt);", _fill("sc", 16)),
              ("      abt3<C>(st, Ks, Qt);", _fill("st", 16))],
    "no_dov": [("      abt3<C>(dp, dOw, Kt + T);", _fill("dp", 16)),
               ("      abt3<C>(dpt, Vs, Qt + T);", _fill("dpt", 16))],
    "no_dq": [("      add_pb3<C>(acc, ah, al, Kt + 4 * T);",
               _kept("acc", "ah", "al").replace("DP / 2", "C::DP / 2"))],
    "no_dv": [("      add_pb3<C>(dv_acc, ah, al, Qt + 6 * T);",
               _kept("dv_acc", "ah", "al").replace("DP / 2", "C::DP / 2"))],
    "no_dk": [("      add_pb3<C>(dk_acc, ah, al, Qt + 4 * T);",
               _kept("dk_acc", "ah", "al").replace("DP / 2", "C::DP / 2"))],
    "one_consumer": [(
        "  return (size_t)bh * ((own_rows + 127) / 128) >= "
        "(size_t)sm_count();", "  return false;")],
    # dk/dv's converting warps: three or five in place of seven
    "dkv_3_converters": [("CONVERTERS + (DKV ? 128 : 0)",
                          "CONVERTERS + (DKV ? 0 : 0)")],
    "dkv_5_converters": [("CONVERTERS + (DKV ? 128 : 0)",
                          "CONVERTERS + (DKV ? 64 : 0)")],
    # the raw tiles also rewritten as their hi parts, as an explicit split
    # would (wgmma reads the raw values the same)
    "hi_written": [("    reinterpret_cast<uint4*>(lo)[i] = l;\n  }",
                    "    reinterpret_cast<uint4*>(lo)[i] = l;\n"
                    "    const_cast<uint4*>(reinterpret_cast<const uint4*>"
                    "(x))[i] = h;\n  }")],
    # the converting warps only arrive: each stage's tiles stay as TMA
    # landed them, no lo parts and no transposes
    "no_convert": [
        ("        convert_stage<C, 1>(KV + s * C::STAGE_BYTES, pt - 32);",
         ""),
        ("        convert_stage<C, 2>(QD + s * C::STAGE_BYTES, ct);", "")],
}


def ablation_sources(src, dtype="bf16"):
    """{variant: source} of flash_bwd_sm90.cu with one part of the
    kernels at ``dtype`` removed."""
    subs = F32_SUBS if dtype == "f32" else {
        "no_exp2": [("flash::exp2_ftz(", "(")],
        "no_qk": [("      abt<DP, NC>(sc, Qw, Kt);", _fill("sc")),
                  ("      abt<DP, NC>(st, Kw, Qt);", _fill("st"))],
        "no_dov": [("      abt<DP, NC>(dp, dOw, Vt);", _fill("dp")),
                   ("      abt<DP, NC>(dpt, Vw, dOt);", _fill("dpt"))],
        "no_dq": [("      pb<DP>(acc, a, Kt);", _kept("acc", "a"))],
        "no_dv": [("      pb<DP>(dv_acc, ap, dOt);", _kept("dv_acc", "ap"))],
        "no_dk": [("      pb<DP>(dk_acc, ads, Qt);", _kept("dk_acc", "ads"))],
        "one_consumer": [(
            "  return (size_t)bh * ((own_rows + 127) / 128) >= "
            "(size_t)sm_count();", "  return false;")],
    }
    out = {"whole": src}
    for name, pairs in subs.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"ablation {name}: {old!r} is not in the "
                                   "source")
            text = text.replace(old, new)
        out[name] = text
    return out


#: the shape each dtype is timed at: bf16 at the mixed phase's
#: microbatch, f32 at the train phase's batch
SHAPES = {"bf16": (48, "bfloat16"), "f32": (96, "float32")}

TIME_ONE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from analytics_zoo_tpu_torch.ops import _kernels as K
from analytics_zoo_tpu_torch.ops import attention as A
import chip_smoke as cs
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do, _ = cs.case_inputs(torch, g, BH, 2048, 2048, 64, DTYPE, None)
o, lse = K.flash_fwd(q, k, v, None, True, 0.125)
args = (q, k, v, do, lse, A._flash_delta(o, do), None, True, 0.125)
print(json.dumps({
    "dq": cs.device_ms(lambda: K.flash_bwd_dq._run("sm90", *args), 10),
    "dkv": cs.device_ms(lambda: K.flash_bwd_dkv._run("sm90", *args), 10)}))
"""


def main() -> int:
    import argparse
    import functools
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=sorted(SHAPES), default="bf16")
    dtype = parser.parse_args().dtype
    import torch
    if not torch.cuda.is_available():
        print("needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from profile_torch_flash_fwd import ablate
    bh, name = SHAPES[dtype]
    ablate(SOURCE, functools.partial(ablation_sources, dtype=dtype),
           TIME_ONE.replace("BH", str(bh)).replace("DTYPE", repr(name)),
           os.path.join(REPO, "build", "flash_bwd_ablate"))
    print(cs.smi_card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
