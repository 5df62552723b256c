"""Activation functions resolvable by Keras-1 name strings.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/activations.py``:
the same 14 names with the same functions.  ``gelu`` is the tanh
approximation, because ``jax.nn.gelu`` defaults to ``approximate=True``;
``softmax`` and ``log_softmax`` act on the last axis.  The clipping
activations (``relu6``, ``hard_sigmoid``) go through ``torch.maximum``
and ``torch.minimum``, so that a tie at a bound takes half the gradient,
as ``jnp.minimum``/``jnp.clip`` give it (``torch.clamp`` passes all of
it)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x):
    return x


def relu(x):
    return torch.relu(x)


def _bound(value: float) -> torch.Tensor:
    """``value`` as a 0-d CPU f32 tensor: as the other operand of
    ``torch.maximum``/``minimum`` it promotes as a Python float does (a
    bf16 input stays bf16, an integer one becomes f32) and rides into a
    CUDA kernel as an argument, with no copy to the device."""
    return torch.tensor(float(value))


def clip(x, low=None, high=None):
    """``jnp.clip``: ``minimum(maximum(x, low), high)``, so that a tie at
    a bound takes half the gradient."""
    if low is not None:
        x = torch.maximum(x, _bound(low))
    if high is not None:
        x = torch.minimum(x, _bound(high))
    return x


def relu6(x):
    return clip(torch.relu(x), high=6.0)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hard_sigmoid(x):
    return clip(0.2 * x + 0.5, 0.0, 1.0)


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
