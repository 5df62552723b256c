"""Expert + pipeline parallelism building blocks on the PyTorch/CUDA
port, end to end.

The port of ``spmd_blocks.py``: a switch-routed mixture-of-experts
trained with experts sharded over the ``expert`` axis (tokens ride an
all-to-all), and a GPipe-microbatched stack of 4 stages over the
``pipe`` axis (activations ride a ring of sends).  One process drives
one device, so the mesh is a pod of processes: run plainly the script
is a world of one (every axis of size 1); under the launcher the axes
split its ranks (up to 4 on ``expert`` and on ``pipe``, the rest on
``data``):

    python spmd_blocks_torch.py [--device cpu]
    python -m analytics_zoo_tpu_torch.launcher --num-processes 4 \\
        spmd_blocks_torch.py --steps 10 --device cpu

(``--device cpu`` joins the ranks on gloo, ``cuda`` on NCCL, one card a
rank.)
"""

import argparse
import math

N_STAGES = 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for a peer")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.parallel import (distributed,
                                                  init_moe_params,
                                                  moe_sharded,
                                                  pipeline_apply,
                                                  switch_moe)
    from analytics_zoo_tpu_torch.parallel.mesh import create_mesh

    distributed.maybe_initialize_distributed(args.device,
                                             timeout_s=args.timeout)
    ctx = init_nncontext("SPMD blocks example", device=args.device)
    dev, n = ctx.device, ctx.device_count
    split = math.gcd(n, N_STAGES)  # ranks on expert (and on pipe)
    say = print if distributed.is_coordinator() else (lambda *a: None)
    rs = np.random.RandomState(0)

    # ---- switch MoE: experts sharded over `expert`, tokens all-to-all
    mesh = create_mesh({"expert": split, "data": n // split}, device=dev,
                       timeout_s=args.timeout)
    d = 16
    x_np = rs.normal(size=(256, d)).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor((np.sign(x_np[:, 0])
                         * np.abs(x_np).sum(1)).astype(np.float32),
                        device=dev)
    params = init_moe_params(torch.Generator(dev).manual_seed(0), d, 64, 8)
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params), lr=1e-2)

    first = None
    for _ in range(args.steps):
        out, aux = moe_sharded(x, params, mesh, capacity_factor=4.0)
        loss = torch.mean((out.sum(dim=1) - y) ** 2) + 0.01 * aux
        opt.zero_grad()
        loss.backward()
        opt.step()
        first = first if first is not None else float(loss.detach())
    say(f"moe: loss {first:.3f} -> {float(loss.detach()):.3f} "
        f"(experts sharded over {{expert:{split}}})")

    # sharded forward agrees with the single-device formulation
    with torch.no_grad():
        got, _ = moe_sharded(x, params, mesh, capacity_factor=8.0)
        want, _ = switch_moe(x, params, capacity=x.shape[0])
    err = float((got - want).abs().max())
    say(f"moe sharded vs single-device: max abs diff {err:.2e}")
    assert err < 1e-4, err

    # ---- GPipe pipeline: 4 stages, 8 microbatches; each rank of `pipe`
    # runs its run of 4 / split consecutive stages
    mesh_p = create_mesh({"pipe": split, "data": n // split}, device=dev,
                         timeout_s=args.timeout)
    w = torch.as_tensor(rs.normal(0, 0.4, (N_STAGES, d, d))
                        .astype(np.float32), device=dev)
    b = torch.zeros((N_STAGES, d), device=dev)

    def stage(p, h):
        for ws, bs in zip(*p):
            h = torch.tanh(h @ ws + bs)
        return h

    per = N_STAGES // split
    with torch.no_grad():
        out = pipeline_apply(stage, (w.reshape(split, per, d, d),
                                     b.reshape(split, per, d)),
                             x, mesh_p, n_microbatches=8)
        seq = x
        for s in range(N_STAGES):
            seq = stage((w[s:s + 1], b[s:s + 1]), seq)
    err = float((out - seq).abs().max())
    say(f"pipeline ({N_STAGES} stages x 8 microbatches) vs sequential: "
        f"max abs diff {err:.2e} (over {{pipe:{split}}})")
    assert err < 1e-5, err
    say("spmd blocks OK")


if __name__ == "__main__":
    main()
