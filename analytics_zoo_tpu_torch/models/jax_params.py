"""Move weights between the JAX package and the port.

The JAX package keeps a model's parameters as a dict keyed by layer name,
each a dict keyed by parameter name (``get_weights()``); a nested model
(a Sequential inside a Sequential) is one more level, under its name.
The port's layers carry the same names, parameter names, shapes and
layouts (Dense ``W`` (in, out), convolution and ConvLSTM2D ``W`` HWIO,
recurrent ``W``/``U``/``b``, SwitchMoE ``gate``/``w1``/``b1``/``w2``/
``b2``), so the transfer is the identity on every leaf: numpy arrays in,
numpy arrays out, and a round trip is bit-exact.  A wrapper layer's tree
nests one level more (Bidirectional: ``{"forward": ..., "backward":
...}``), except TimeDistributed's, which is its inner layer's, as in the
JAX package.  The layer state (BatchNormalization's moving statistics and
``count``, WordEmbedding's ``table``, SwitchMoE's ``aux_loss``) moves the
same way, keyed as the JAX package's ``trainer.state.model_state``.  A graph model (``Sequential``/``Model``)
lists its layers in first-use order; any other model (``TransformerLM``)
every ``Layer`` with parameters or state among its modules.  This module
takes and returns numpy only; it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.graph import GraphModule
from ..core.module import Layer


def _is_graph(m) -> bool:
    return isinstance(m, GraphModule) or getattr(m, "graph_based", False)


def _layers(model) -> List[Layer]:
    if isinstance(model, GraphModule):
        return list(model.layers)
    if _is_graph(model):
        return list(model.to_graph().layers)
    return [m for m in model.modules()
            if isinstance(m, Layer) and (m.params() or m.state())]


def _entries(model, kind: str = "params") -> List[Tuple[str, Layer]]:
    """(name, layer) pairs whose ``kind`` ("params" or "state") makes the
    model's tree, in model order; a layer name used twice raises (one
    would hide the other)."""
    own = (lambda l: any(True for _ in l.parameters())) if kind == "params" \
        else (lambda l: any(True for _ in l.buffers()))
    out, seen = [], set()
    for layer in _layers(model):
        if not own(layer):
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


def state_tree(model) -> Dict[str, dict]:
    """The model's state tensors (stateful layers' buffers, themselves,
    not copies) as the JAX package's ``model_state`` tree: {layer:
    {moving_mean, moving_var, count}}, one level more per nested
    model."""
    return {name: (state_tree(layer) if _is_graph(layer)
                   else layer.state())
            for name, layer in _entries(model, "state")}


def model_tree(model) -> Dict[str, dict]:
    """What ``save_model`` writes: {"params": ..., "model_state": ...}."""
    return {"params": weight_tree(model), "model_state": state_tree(model)}


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


def _load(model, tree, kind: str) -> None:
    own_tree, leaves_of = ((weight_tree, lambda l: l.params())
                           if kind == "params"
                           else (state_tree, lambda l: l.state()))
    entries = _entries(model, kind)
    given = [(name, leaves) for name, leaves in tree.items() if leaves]
    names = [name for name, _ in entries]
    if {n for n, _ in given} != set(names):
        if len(given) != len(entries):
            raise KeyError(
                f"{kind} tree layers "
                f"{sorted({n for n, _ in given} ^ set(names))} do not "
                "match the model's")
        own = own_tree(model)
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
                _load(layer, tree[name], kind)
                continue
            copy_leaves(name, kind, leaves_of(layer), tree[name])


def copy_leaves(path: str, kind: str, own, leaves) -> None:
    """Copy a layer's given leaves into its own tensors, recursing into
    nested trees (Bidirectional's ``forward``/``backward``)."""
    if set(leaves) != set(own):
        raise KeyError(f"{path}: {kind} {sorted(leaves)} do not match the "
                       f"model's {sorted(own)}")
    for key, t in own.items():
        if isinstance(t, dict):
            copy_leaves(f"{path}/{key}", kind, t, leaves[key])
            continue
        arr = np.asarray(leaves[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}/{key}: shape {arr.shape} != "
                             f"{tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr, copy=True)))


def from_jax_params(model, params, state=None) -> None:
    """Load a JAX param tree (nested dicts of arrays, as the JAX package's
    ``get_weights()`` gives) into ``model`` in place, and with ``state``
    a JAX ``model_state`` tree (``trainer.state.model_state``) into its
    stateful layers.  Every parameter (and, when ``state`` is given,
    every state tensor) of the model must be given, with its exact
    shape; layers without any may appear as empty dicts.  When the layer
    names differ but the count and every shape match (auto-named layers
    of another process), layers are matched by position, as the JAX
    package's ``set_weights`` does."""
    _load(model, params, "params")
    if state is not None:
        _load(model, state, "state")


def _host(tree):
    return {k: (_host(v) if isinstance(v, dict)
                else v.detach().cpu().numpy().copy())
            for k, v in tree.items()}


def to_jax_params(model) -> Dict[str, dict]:
    """The model's parameters as a JAX-keyed tree of numpy arrays."""
    return _host(weight_tree(model))


def to_jax_state(model) -> Dict[str, dict]:
    """The model's layer state as the JAX package's ``model_state`` tree
    of numpy arrays (``count`` a 0-d f32 array)."""
    return _host(state_tree(model))
