"""Weight initializers (the Keras-1 ``init=`` names), drawn from an
explicit ``torch.Generator`` on the generator's device.

Counterpart of ``analytics_zoo_tpu/core/initializers.py``.  The two
frameworks' random streams differ, so inits match the JAX package in
distribution only; parity tests load the JAX package's weights."""

from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) in (3, 4, 5):
        receptive = math.prod(shape[:-2])
        fan_in = shape[-2] * receptive
        fan_out = shape[-1] * receptive
    else:
        fan_in = fan_out = int(math.sqrt(math.prod(shape)))
    return fan_in, fan_out


def _uniform(shape, generator, low, high, dtype):
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (high - low) + low


def glorot_uniform(shape, generator, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(shape, generator, -limit, limit, dtype)


def uniform(shape, generator, dtype=torch.float32, scale=0.05):
    return _uniform(shape, generator, -scale, scale, dtype)


def zeros(shape, generator, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=generator.device)


def ones(shape, generator, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=generator.device)


_INITS = {
    "glorot_uniform": glorot_uniform,
    "uniform": uniform,
    "zeros": zeros,
    "ones": ones,
}


def get(name):
    """Resolve an initializer by name."""
    try:
        return _INITS[name]
    except KeyError:
        raise ValueError(
            f"Unknown initializer {name!r}; known: {sorted(_INITS)}") from None
