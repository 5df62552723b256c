"""Reference artifact builders (see :mod:`.artifact`).

Counterpart of ``analytics_zoo_tpu/serving/fleet/builders.py``.  A
builder is ``fn(args, params, device=...) -> deploy kwargs``: it turns
the on-disk artifact back into what ``ModelRegistry.deploy`` takes, on
the device the worker names (a builder never picks one of its own).
The keywords are the port registry's (``fn=``, not ``jax_fn=``).

* :func:`mlp`: a tanh MLP ``fn(params, x)`` over the artifact's
  ``w0..w{n-1}``, placed on the device;
* :func:`lm`: a seeded :class:`TransformerLM` behind the
  continuous-batching decode engine; every worker builds the same
  weights from the spec alone;
* :func:`stub`: a device-free duck-typed handle (numpy arithmetic) for
  the fake worker mode, which drives the whole fan-out/retry machinery
  without a model or a kernel.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np


def mlp(args: Dict[str, Any], params: Optional[Dict[str, Any]],
        device: str = "cuda") -> Dict[str, Any]:
    """A layered tanh MLP whose depth comes from the weight dict
    (``w0..w{n-1}``), the weights as tensors on ``device`` (float64
    narrowed to float32, as the JAX package's device_put does)."""
    import torch
    from ...pipeline.inference.serving import place_tree
    if params is None:
        raise ValueError("mlp builder needs artifact weights")
    n_layers = int(args.get("n_layers", len(params)))
    placed = place_tree(dict(params), torch.device(device))

    def forward(p, x):
        h = x
        for i in range(n_layers):
            h = torch.tanh(h @ p[f"w{i}"])
        return h

    return {"fn": forward, "params": placed}


def lm(args: Dict[str, Any], params: Optional[Dict[str, Any]],
       device: str = "cuda") -> Dict[str, Any]:
    """A TransformerLM from ``args["seed"]`` (default 0) on ``device``,
    in eval mode, behind the decode engine: the same spec gives every
    worker the same weights.  ``args`` takes the model's widths
    (``vocab_size``, ``seq_len``, ``n_layers``, ``d_model``,
    ``n_heads``, ``d_ff``) and the engine's (``capacity``,
    ``prompt_buckets``, ``prefix_pool``)."""
    from ...models import TransformerLM
    net = TransformerLM(
        vocab_size=int(args.get("vocab_size", 32)),
        seq_len=int(args.get("seq_len", 64)),
        n_layers=int(args.get("n_layers", 1)),
        d_model=int(args.get("d_model", 16)),
        n_heads=int(args.get("n_heads", 2)),
        d_ff=(int(args["d_ff"]) if args.get("d_ff") else None),
        device=device, seed=int(args.get("seed", 0))).eval()
    out = {"net": net,
           "decode_capacity": int(args.get("capacity", 2)),
           "decode_prompt_buckets": tuple(
               args.get("prompt_buckets", (8,))),
           "replicas": 1}
    if args.get("prefix_pool"):
        out["decode_prefix_pool"] = int(args["prefix_pool"])
    return out


class StubModel:
    """A device-free serving handle for the fake worker mode, with the
    registry's duck-typed surface (predict/warmup/close/serving_stats).
    ``scale`` makes versions distinguishable bit for bit; ``delay_s``
    shapes latency; ``die_after`` kills the PROCESS on the nth predict
    (the worker-death-mid-request fixture), armed only in a worker's
    first incarnation and, with ``die_rank``, only in that rank;
    ``expand`` widens each output row N times on the trailing axis (the
    oversize-reply fixture)."""

    def __init__(self, scale: float = 1.0, delay_s: float = 0.0,
                 die_after: Optional[int] = None,
                 die_rank: Optional[int] = None,
                 expand: int = 1):
        from ...observability import flightrec
        self.scale = float(scale)
        self.delay_s = float(delay_s)
        self.expand = int(expand)
        rank = flightrec._env_rank()
        inc = flightrec._env_incarnation()
        armed = (die_after is not None and inc == 0
                 and (die_rank is None or rank == int(die_rank)))
        self.die_after = die_after if armed else None
        self._lock = threading.Lock()
        self._served = 0
        self._closed = False

    def predict(self, inputs):
        with self._lock:
            self._served += 1
            served = self._served
        if self.die_after is not None and served >= self.die_after:
            os._exit(17)  # a real mid-request death: no reply leaves
        if self.delay_s:
            time.sleep(self.delay_s)
        out = np.asarray(inputs, dtype=np.float64) * self.scale
        if self.expand > 1:
            out = np.repeat(out, self.expand, axis=-1)
        return out

    def warmup(self, shapes, dtypes=None) -> float:
        return 0.0

    def close(self):
        self._closed = True

    def serving_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"stub": True, "served": self._served,
                    "scale": self.scale}


def stub(args: Dict[str, Any], params: Optional[Dict[str, Any]],
         device: str = "cuda") -> Dict[str, Any]:
    """A :class:`StubModel` from ``args`` (no device is touched)."""
    return {"model": StubModel(
        scale=args.get("scale", 1.0),
        delay_s=args.get("delay_s", 0.0),
        die_after=args.get("die_after"),
        die_rank=args.get("die_rank"),
        expand=args.get("expand", 1))}
