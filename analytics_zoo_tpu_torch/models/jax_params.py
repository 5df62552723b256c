"""Move weights between the JAX package and the port.

The JAX package keeps a model's parameters as a dict keyed by layer name,
each a dict keyed by parameter name (``ensure_inference_ready().state.
params``).  The port's layers carry the same names and shapes, so the
transfer is the identity on every leaf: numpy arrays in, numpy arrays
out, and a round trip is bit-exact.  This module takes and returns numpy
only; it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.module import Layer


def _layers(model) -> Dict[str, Layer]:
    return {m.name: m for m in model.modules()
            if isinstance(m, Layer) and m.params()}


def from_jax_params(model, tree) -> None:
    """Load a JAX param tree (nested dicts of arrays, as from
    ``jax.device_get(trainer.state.params)``) into ``model`` in place.
    Every parameter of the model must be given, with its exact shape;
    layers without parameters may appear as empty dicts."""
    layers = _layers(model)
    given = {name for name, leaves in tree.items() if leaves}
    if given != set(layers):
        raise KeyError(
            f"param tree layers {sorted(given ^ set(layers))} do not match "
            "the model's")
    with torch.no_grad():
        for name, layer in layers.items():
            own = layer.params()
            leaves = tree[name]
            if set(leaves) != set(own):
                raise KeyError(f"{name}: params {sorted(leaves)} do not "
                               f"match the model's {sorted(own)}")
            for key, p in own.items():
                arr = np.asarray(leaves[key])
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{name}/{key}: shape {arr.shape} != "
                        f"{tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(arr, copy=True)))


def to_jax_params(model) -> Dict[str, Dict[str, np.ndarray]]:
    """The model's parameters as a JAX-keyed tree of numpy arrays."""
    return {name: {key: p.detach().cpu().numpy().copy()
                   for key, p in layer.params().items()}
            for name, layer in _layers(model).items()}
