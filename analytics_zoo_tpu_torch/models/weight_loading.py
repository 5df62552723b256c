"""Pretrained-weight import: public checkpoint layouts into the port's
models.

Counterpart of ``analytics_zoo_tpu/models/weight_loading.py`` (the
reference's zoo serves pretrained models; its specs carry per-layer
``weightConverter`` functions for the layout traps).  Two whole-model
converters:

* :func:`load_tf_keras_weights`, from a live ``tf.keras`` model (any
  object with ``layers`` whose items have ``get_weights()``).  Keras
  convolutions are HWIO already, the port's layout; BatchNormalization's
  gamma and beta go to the parameters, its moving statistics to the
  layer state, and a scale- or center-free one loads ones or zeros.
* :func:`load_torch_state_dict`, from a PyTorch ``state_dict``: OIHW
  convolutions to HWIO, (out, in) linears to (in, out), and the first
  linear after a Flatten of a feature map (through pass-through layers
  such as Dropout) re-indexed from torch's CHW flatten order to NHWC's
  HWC order.

Both pair the model's convolution, BatchNormalization and Dense layers
with the source's, kind by kind, in creation order: the trailing
counter of the auto-names (``convolution2d_9``), which the port draws
as the JAX package does (one counter per class, restarted in each
``name_scope``), so the pairing is the JAX package's.  Imported moving
statistics land with ``count = inf``, which eval mode uses as they are.
A source whose counts per kind differ from the model's raises.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

_KINDS = ("conv", "bn", "dense")


def _name_counter(name: str) -> int:
    """The trailing auto-name counter ('conv2d_9' -> 9, 'conv2d' -> -1):
    creation order within a kind on both sides (graph order differs from
    creation order in branchy models)."""
    tail = name.rpartition("_")[2]
    return int(tail) if tail.isdigit() else -1


def _our_layers_by_kind(net) -> Dict[str, List[object]]:
    """kind -> the weight-bearing layers of ``net``'s graph in creation
    order."""
    from ..pipeline.api.keras.layers.convolutional import _ConvND
    from ..pipeline.api.keras.layers.core import Dense
    from ..pipeline.api.keras.layers.normalization import (
        BatchNormalization)
    out: Dict[str, List[object]] = {k: [] for k in _KINDS}
    for layer in net.to_graph().layers:
        if isinstance(layer, _ConvND):
            out["conv"].append(layer)
        elif isinstance(layer, BatchNormalization):
            out["bn"].append(layer)
        elif isinstance(layer, Dense):
            out["dense"].append(layer)
    for kind in out:
        out[kind].sort(key=lambda l: _name_counter(l.name))
    return out


def _pair_by_kind(ours: Dict[str, List], theirs: Dict[str, List],
                  source: str):
    """Zip the per-kind creation-order sequences; differing counts
    raise."""
    if any(len(ours[k]) != len(theirs[k]) for k in _KINDS):
        detail = {k: (len(ours[k]), len(theirs[k])) for k in _KINDS}
        raise ValueError(
            f"op-count mismatch: ours vs {source} per kind "
            f"(ours, theirs) = {detail}")
    for kind in _KINDS:
        for ol, tl in zip(ours[kind], theirs[kind]):
            yield kind, ol, tl


def _apply(net, params: Dict, state: Dict):
    """Copy the converted arrays into the layers' own tensors (shapes
    checked) and drop an int8 twin built from the old weights."""
    with torch.no_grad():
        for tree, own in ((params, lambda l: l.params()),
                          (state, lambda l: l.state())):
            for layer, entries in tree.items():
                tensors = own(layer)
                for key, arr in entries.items():
                    t = tensors[key]
                    arr = np.asarray(arr, dtype=np.float32)
                    if tuple(arr.shape) != tuple(t.shape):
                        raise ValueError(
                            f"{layer.name}/{key}: shape {arr.shape} != "
                            f"{tuple(t.shape)}")
                    t.copy_(torch.from_numpy(arr))
    if hasattr(net, "_invalidate_quantized"):
        net._invalidate_quantized()
    return net


def _bias(given, width):
    """A bias-free source zeroes a layer's bias (forward-equivalent),
    never leaves its random init."""
    return given if given is not None else np.zeros((width,), np.float32)


def load_tf_keras_weights(net, keras_model):
    """Load a tf.keras model's Conv2D, BatchNormalization and Dense
    weights into ``net`` in creation order (raises on a structural
    mismatch: count or shape)."""
    ours = _our_layers_by_kind(net)
    kind_of = {"Conv2D": "conv", "BatchNormalization": "bn",
               "Dense": "dense"}
    theirs: Dict[str, List[object]] = {k: [] for k in _KINDS}
    for kl in keras_model.layers:
        kind = kind_of.get(type(kl).__name__)
        if kind:
            theirs[kind].append(kl)
    for kind in theirs:
        theirs[kind].sort(key=lambda l: _name_counter(l.name))
    params: Dict = {}
    state: Dict = {}
    for kind, ol, tl in _pair_by_kind(ours, theirs, "keras model"):
        w = [np.asarray(a) for a in tl.get_weights()]
        if kind in ("conv", "dense"):
            entry = {"W": w[0]}  # HWIO / (in, out) on both sides
            if ol.bias:
                entry["b"] = _bias(w[1] if len(w) > 1 else None,
                                   w[0].shape[-1])
            params[ol] = entry
            continue
        # keras' order: [gamma] [beta] moving_mean moving_var
        n, i = w[-1].shape[0], 0
        gamma = beta = None
        if getattr(tl, "scale", True):
            gamma, i = w[i], i + 1
        if getattr(tl, "center", True):
            beta, i = w[i], i + 1
        params[ol] = {
            "gamma": gamma if gamma is not None else np.ones((n,)),
            "beta": beta if beta is not None else np.zeros((n,))}
        state[ol] = {"moving_mean": w[i], "moving_var": w[i + 1],
                     "count": np.float32(np.inf)}
    return _apply(net, params, state)


def _dense_flatten_reorders(net) -> Dict[str, tuple]:
    """Dense layer name -> (H, W, C) where the Dense's input is a Flatten
    of a 4-D NHWC map, directly or through shape-preserving layers
    (Dropout, Activation: torch heads are often Flatten, Dropout,
    Linear).  Torch flattens CHW, the port HWC, so that Dense's rows are
    permuted."""
    from ..pipeline.api.keras.layers.core import Dense, Flatten
    out: Dict[str, tuple] = {}
    for v in net.to_graph().nodes:
        if not isinstance(v.layer, Dense) or not v.inputs:
            continue
        src, hops = v.inputs[0], 0
        while (not isinstance(src.layer, Flatten)
               and len(src.inputs) == 1
               and src.shape == src.inputs[0].shape and hops < 8):
            src, hops = src.inputs[0], hops + 1
        if isinstance(src.layer, Flatten) and src.inputs \
                and len(src.inputs[0].shape) == 4:
            _, h, w, c = src.inputs[0].shape
            out[v.layer.name] = (h, w, c)
    return out


def load_torch_state_dict(net, state_dict):
    """Load a PyTorch ``state_dict`` (its insertion order is torch's
    creation order) into ``net`` in creation order: conv OIHW -> HWIO,
    linear (out, in) -> (in, out) with the CHW -> HWC row reorder after
    a Flatten, BatchNorm weight/bias -> gamma/beta and running statistics
    -> moving statistics."""
    ours = _our_layers_by_kind(net)
    reorders = _dense_flatten_reorders(net)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        prefix, _, leaf = key.rpartition(".")
        groups.setdefault(prefix, {})[leaf] = np.asarray(
            val.detach().cpu().numpy() if hasattr(val, "detach") else val)
    theirs: Dict[str, List] = {k: [] for k in _KINDS}
    for g in groups.values():
        if "running_mean" in g:
            theirs["bn"].append(g)
        elif "weight" in g and g["weight"].ndim == 4:
            theirs["conv"].append(g)
        elif "weight" in g and g["weight"].ndim == 2:
            theirs["dense"].append(g)
    params: Dict = {}
    state: Dict = {}
    for kind, ol, g in _pair_by_kind(ours, theirs, "state_dict"):
        if kind == "bn":
            n = g["running_mean"].shape[0]
            params[ol] = {"gamma": g.get("weight", np.ones((n,))),
                          "beta": g.get("bias", np.zeros((n,)))}
            state[ol] = {"moving_mean": g["running_mean"],
                         "moving_var": g["running_var"],
                         "count": np.float32(np.inf)}
            continue
        if kind == "conv":
            w = g["weight"].transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            w = g["weight"].T  # (out, in) -> (in, out)
            hwc = reorders.get(ol.name)
            if hwc is not None and w.shape[0] == int(np.prod(hwc)):
                h, ww, c = hwc
                w = (w.reshape(c, h, ww, -1).transpose(1, 2, 0, 3)
                     .reshape(h * ww * c, -1))
        entry = {"W": w}
        if ol.bias:
            entry["b"] = _bias(g.get("bias"), w.shape[-1])
        params[ol] = entry
    return _apply(net, params, state)
