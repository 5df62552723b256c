"""Activation functions resolvable by Keras-1 name strings.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/activations.py``:
the same 14 names with the same functions.  ``gelu`` is the tanh
approximation, because ``jax.nn.gelu`` defaults to ``approximate=True``;
``softmax`` and ``log_softmax`` act on the last axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(torch.relu(x), max=6.0)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def softmax(x):
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def elu(x):
    return F.elu(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


_ACTIVATIONS = {
    "linear": linear,
    "relu": relu,
    "relu6": relu6,
    "tanh": tanh,
    "sigmoid": sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "softmax": softmax,
    "log_softmax": log_softmax,
    "softplus": softplus,
    "softsign": softsign,
    "elu": elu,
    "gelu": gelu,
    "silu": silu,
    "swish": silu,
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
