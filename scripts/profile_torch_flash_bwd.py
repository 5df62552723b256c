#!/usr/bin/env python3
"""Where the sm90 flash backward's time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_flash_bwd.py

Copies the package under ``build/flash_bwd_ablate/`` once a variant,
each with one part of the sm90 kernels removed from
``flash_bwd_sm90.cu`` by a text substitution (the exp2 of p; one of the
products: S = Q.K^T, dP = dO.V^T, the output products dQ, dV, dK, whose
removal keeps the packed operand alive; or the second consumer
warpgroup), builds them all at once (``profile_torch_flash_fwd.ablate``)
and prints the device ms of ``flash_bwd_dq`` and ``flash_bwd_dkv`` in
each (``chip_smoke.device_ms``: replayed from a CUDA graph, the median
of three replays) at bf16 (48, 2048, 64) causal, twice in turns, then
the card's name and power limit.
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


def _fill(name):
    """A stand-in for a removed S or dP product: its accumulator filled
    with values the rest of the tile reads."""
    return (f"#pragma unroll\n      for (int i = 0; i < 32; ++i) {name}[i] "
            "= 0.01f * i;")


def _kept(acc, a):
    """A stand-in for a removed output product: its packed operand added
    into the sums, so that the work forming it stays."""
    return (f"#pragma unroll\n      for (int i = 0; i < DP / 2; ++i) "
            f"{acc}[i] += __uint_as_float({a}[(i / 4) % 4][i % 4]);")


def ablation_sources(src):
    """{variant: source} of flash_bwd_sm90.cu with one part removed."""
    subs = {
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


TIME_ONE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from analytics_zoo_tpu_torch.ops import _kernels as K
from analytics_zoo_tpu_torch.ops import attention as A
import chip_smoke as cs
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do, _ = cs.case_inputs(torch, g, 48, 2048, 2048, 64, "bfloat16",
                                None)
o, lse = K.flash_fwd(q, k, v, None, True, 0.125)
args = (q, k, v, do, lse, A._flash_delta(o, do), None, True, 0.125)
print(json.dumps({
    "dq": cs.device_ms(lambda: K.flash_bwd_dq._run("sm90", *args), 10),
    "dkv": cs.device_ms(lambda: K.flash_bwd_dkv._run("sm90", *args), 10)}))
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from profile_torch_flash_fwd import ablate
    ablate(SOURCE, ablation_sources, TIME_ONE,
           os.path.join(REPO, "build", "flash_bwd_ablate"))
    print(cs.smi_card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
