#!/usr/bin/env python3
"""Where the sm90 flash forward's time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_flash_fwd.py

Copies the package under ``build/flash_ablate/`` once a variant, each
with one part of the sm90 walk removed from ``flash_fwd_sm90.cu`` by a
text substitution (the softmax, its exp2, the P.V product, the Q.K^T
product, or the second consumer warpgroup), builds them all at once and
prints the device ms of each (``chip_smoke.device_ms``: replayed from a
CUDA graph) at bf16 (48, 2048, 64), bf16 (96, 2048, 64) and f32 (96,
2048, 64), causal, twice in turns, then the card's name and power limit.
The variants' outputs are wrong by construction; the times say what each
part costs.  The forward's per-case checks and times at both designs
are ``chip_smoke.py --phases kernels``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = os.path.join("analytics_zoo_tpu_torch", "ops", "csrc",
                      "flash_fwd_sm90.cu")


def ablation_sources(src):
    """{variant: source} of flash_fwd_sm90.cu with one part removed."""
    start = src.index("      if (!flash::tile_unmasked(row0, 16, k0, BK,")
    end = src.index("      pv_product<T, DP, NC>(pv, sc,")
    exp = "flash::exp2_ftz(fmaf(sc[i], scale2, -m2[(i >> 1) & 1]))"
    pv = src[end:src.index(";", end) + 1]
    qk = "      qk<T, DP, NC>(sc, sx, Qw, st);"
    nc = src[src.index("  const int nc = "):src.index(";", src.index(
        "  const int nc = ")) + 1]
    out = {
        "whole": src,
        "no_softmax": src[:start] + "      corr[0] = corr[1] = 1.f;\n"
        + src[end:],
        "no_exp2": src.replace(exp, "fmaf(sc[i], scale2, -m2[(i >> 1) & 1])"),
        "no_pv": src.replace(pv, "#pragma unroll\n      for (int i = 0; "
                             "i < DP / 2; ++i) pv[i] = sc[i % (BK / 2)];"),
        "no_qk": src.replace(qk, "#pragma unroll\n      for (int i = 0; "
                             "i < BK / 2; ++i) sc[i] = 0.01f * i;"),
        "one_consumer": src.replace(nc, "  const int nc = 1;"),
    }
    for name, text in out.items():
        if name != "whole" and text == src:
            raise RuntimeError(f"ablation {name}: its text is not in the "
                               "source")
    return out


TIME_ONE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from analytics_zoo_tpu_torch.ops import _kernels as K
import chip_smoke as cs
g = torch.Generator(device="cuda").manual_seed(0)
ms = {}
for bh, dt in ((48, "bfloat16"), (96, "bfloat16"), (96, "float32")):
    q, k, v, _, _ = cs.case_inputs(torch, g, bh, 2048, 2048, 64, dt, None)
    ms[f"{dt}_{bh}"] = cs.device_ms(
        lambda: K.flash_fwd(q, k, v, None, True, 0.125), 20)
print(json.dumps(ms))
"""


def ablate(source=SOURCE, sources=None, time_one=TIME_ONE,
           root=os.path.join(REPO, "build", "flash_ablate")):
    """Build a copy of the package under ``root`` for each of
    ``sources(text of source)``'s variants (default
    :func:`ablation_sources`), all at once, then run ``time_one`` (a
    script printing one JSON line) in each, twice in turns."""
    shutil.rmtree(root, ignore_errors=True)
    src = open(os.path.join(REPO, source)).read()
    builds = {}
    for name, text in (sources or ablation_sources)(src).items():
        d = os.path.join(root, name)
        shutil.copytree(os.path.join(REPO, "analytics_zoo_tpu_torch"),
                        os.path.join(d, "analytics_zoo_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), d)
        with open(os.path.join(d, source), "w") as f:
            f.write(text)
        builds[name] = subprocess.Popen(
            [sys.executable, "-c", "from analytics_zoo_tpu_torch.ops import "
             "_kernels; _kernels.build()"], cwd=d)
    for name, proc in builds.items():
        if proc.wait(timeout=900) != 0:
            raise RuntimeError(f"ablation {name} did not build")
    for turn in range(2):
        for name in builds:
            out = subprocess.run([sys.executable, "-c", time_one],
                                 cwd=os.path.join(root, name),
                                 capture_output=True, text=True,
                                 timeout=300, check=True).stdout
            print("ablation", json.dumps(dict(
                variant=name, turn=turn, ms=json.loads(out.splitlines()[-1]))),
                flush=True)
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    ablate()
    print(cs.smi_card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
