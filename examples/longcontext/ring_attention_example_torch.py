"""Long-context sequence parallelism with ring attention on the
PyTorch/CUDA port.

The port of ``ring_attention_example.py``: shard a long sequence across
the ``seq`` mesh axis and compute attention with k/v blocks rotating
around the ring of ranks, peak memory O(seq / ranks) a rank.  One
process drives one device, so the ring is a pod of processes: run
plainly the script is a world of one (the ring of one block); under the
launcher it splits the sequence over every rank:

    python ring_attention_example_torch.py --seq-len 4096 [--device cpu]
    python -m analytics_zoo_tpu_torch.launcher --num-processes 4 \\
        ring_attention_example_torch.py --seq-len 1024 --device cpu

(``--device cpu`` joins the ranks on gloo, ``cuda`` on NCCL, one card a
rank.)
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--no-causal", dest="causal", action="store_false",
                    default=True, help="run full (non-causal) attention")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for a peer")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.ops.attention import blockwise_attention
    from analytics_zoo_tpu_torch.parallel import distributed
    from analytics_zoo_tpu_torch.parallel.mesh import create_mesh
    from analytics_zoo_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)

    distributed.maybe_initialize_distributed(args.device,
                                             timeout_s=args.timeout)
    ctx = init_nncontext("Ring Attention Example", device=args.device)
    n = ctx.device_count
    mesh = create_mesh({"seq": n}, device=ctx.device,
                       timeout_s=args.timeout)
    say = print if distributed.is_coordinator() else (lambda *a: None)
    say(f"mesh: {{'seq': {n}}} over {ctx.device.type}")

    # every rank draws the same global q/k/v (a replicated value) and
    # takes its own sequence block inside the ring
    rs = np.random.RandomState(0)
    shape = (1, args.seq_len, args.heads, args.head_dim)
    q, k, v = (torch.as_tensor(rs.normal(size=shape).astype(np.float32),
                               device=ctx.device) for _ in range(3))

    out = ring_attention_sharded(q, k, v, mesh, causal=args.causal)
    say(f"ring attention out: {tuple(out.shape)}, "
        f"{args.seq_len // n} positions a rank, gathered on every rank")

    # every rank held only seq/n of k/v at a time; the single-device
    # blockwise formulation agrees numerically
    want = blockwise_attention(q, k, v, causal=args.causal)
    err = float((out - want).abs().max())
    say(f"max abs diff vs single-device blockwise: {err:.2e}")
    assert err < 2e-3, err
    say(f"ring attention OK: seq {args.seq_len} split {n} ways "
        f"({args.seq_len // n} per device)")


if __name__ == "__main__":
    main()
