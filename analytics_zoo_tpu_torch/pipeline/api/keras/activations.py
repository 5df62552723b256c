"""Activation functions resolvable by Keras-1 name strings.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/activations.py``.
Only the two the first slice uses; ``gelu`` is the tanh approximation,
because ``jax.nn.gelu`` defaults to ``approximate=True``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def gelu(x):
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "log_softmax": log_softmax,
    "gelu": gelu,
}


def get(name):
    if name is None:
        return None
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None
