"""Move weights between the JAX package and the port.

The JAX package keeps a model's parameters as a dict keyed by layer name,
each a dict keyed by parameter name (``get_weights()``); a nested model
(a Sequential inside a Sequential) is one more level, under its name.
The port's layers carry the same names, parameter names, shapes and
layouts (Dense ``W`` (in, out), convolution ``W`` HWIO), so the transfer
is the identity on every leaf: numpy arrays in, numpy arrays out, and a
round trip is bit-exact.  A graph model (``Sequential``/``Model``) lists
its layers in first-use order; any other model (``TransformerLM``) every
``Layer`` with parameters among its modules.  This module takes and
returns numpy only; it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.graph import GraphModule
from ..core.module import Layer


def _is_graph(m) -> bool:
    return isinstance(m, GraphModule) or getattr(m, "graph_based", False)


def _entries(model) -> List[Tuple[str, Layer]]:
    """(name, layer) pairs whose weights make the model's tree, in model
    order; a layer name used twice raises (one would hide the other)."""
    if isinstance(model, GraphModule):
        layers = list(model.layers)
    elif _is_graph(model):
        layers = list(model.to_graph().layers)
    else:
        layers = [m for m in model.modules()
                  if isinstance(m, Layer) and m.params()]
    out, seen = [], set()
    for layer in layers:
        if not any(True for _ in layer.parameters()):
            continue
        if layer.name in seen:
            raise ValueError(
                f"two layers are named {layer.name!r}: layer names must be "
                "unique within a model for its weights to be addressed")
        seen.add(layer.name)
        out.append((layer.name, layer))
    return out


def weight_tree(model) -> Dict[str, dict]:
    """The model's parameter tensors as the JAX package's tree (the
    tensors themselves, not copies)."""
    return {name: (weight_tree(layer) if _is_graph(layer)
                   else layer.params())
            for name, layer in _entries(model)}


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


def from_jax_params(model, tree) -> None:
    """Load a JAX param tree (nested dicts of arrays, as the JAX package's
    ``get_weights()`` gives) into ``model`` in place.  Every parameter of
    the model must be given, with its exact shape; layers without
    parameters may appear as empty dicts.  When the layer names differ
    but the count and every shape match (auto-named layers of another
    process), layers are matched by position, as the JAX package's
    ``set_weights`` does."""
    entries = _entries(model)
    given = [(name, leaves) for name, leaves in tree.items() if leaves]
    names = [name for name, _ in entries]
    if {n for n, _ in given} != set(names):
        if len(given) != len(entries):
            raise KeyError(
                f"param tree layers "
                f"{sorted({n for n, _ in given} ^ set(names))} do not "
                "match the model's")
        own = weight_tree(model)
        for (name, _), (gname, leaves) in zip(entries, given):
            if _shapes(own[name]) != _shapes(leaves):
                raise ValueError(
                    f"positional remap of {gname!r} onto {name!r}: shapes "
                    f"{_shapes(leaves)} != {_shapes(own[name])}")
        tree = {name: leaves for (name, _), (_, leaves) in zip(entries,
                                                                  given)}
    with torch.no_grad():
        for name, layer in entries:
            if _is_graph(layer):
                from_jax_params(layer, tree[name])
                continue
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


def to_jax_params(model) -> Dict[str, dict]:
    """The model's parameters as a JAX-keyed tree of numpy arrays."""
    def host(tree):
        return {k: (host(v) if isinstance(v, dict)
                    else v.detach().cpu().numpy().copy())
                for k, v in tree.items()}
    return host(weight_tree(model))
