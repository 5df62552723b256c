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


def _normal(shape, generator, dtype):
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device)


def glorot_normal(shape, generator, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(shape, generator,
                                                          dtype)


def he_normal(shape, generator, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return math.sqrt(2.0 / fan_in) * _normal(shape, generator, dtype)


def he_uniform(shape, generator, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    limit = math.sqrt(6.0 / fan_in)
    return _uniform(shape, generator, -limit, limit, dtype)


def lecun_uniform(shape, generator, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    limit = math.sqrt(3.0 / fan_in)
    return _uniform(shape, generator, -limit, limit, dtype)


def uniform(shape, generator, dtype=torch.float32, scale=0.05):
    return _uniform(shape, generator, -scale, scale, dtype)


def normal(shape, generator, dtype=torch.float32, scale=0.05):
    return scale * _normal(shape, generator, dtype)


def zeros(shape, generator, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=generator.device)


def ones(shape, generator, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=generator.device)


#: the JAX package's public ``zero`` and ``one``
zero = zeros
one = ones


def constant(value: float):
    """An initializer filling its shape with ``value``."""
    def init(shape, generator, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=generator.device)
    return init


def identity(shape, generator, dtype=torch.float32):
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError("identity init requires a square 2D shape")
    return torch.eye(shape[0], dtype=dtype, device=generator.device)


def orthogonal(shape, generator, dtype=torch.float32):
    """Q of the QR of a normal draw, signs fixed by R's diagonal (the
    reference's recipe; its stream differs)."""
    flat = (shape[0], math.prod(shape[1:]))
    a = _normal(flat, generator, torch.float32)
    q, r = torch.linalg.qr(a.T if flat[0] < flat[1] else a)
    q = q * torch.sign(torch.diagonal(r))
    q = q.T if flat[0] < flat[1] else q
    return q.reshape(tuple(shape)).to(dtype)


_INITS = {
    "glorot_uniform": glorot_uniform,
    "glorot_normal": glorot_normal,
    "xavier": glorot_uniform,
    "he_normal": he_normal,
    "he_uniform": he_uniform,
    "lecun_uniform": lecun_uniform,
    "uniform": uniform,
    "normal": normal,
    "gaussian": normal,
    "zero": zero,
    "zeros": zeros,
    "one": one,
    "ones": ones,
    "identity": identity,
    "orthogonal": orthogonal,
}


def get(name):
    """Resolve an initializer by name (or pass a callable through)."""
    if callable(name):
        return name
    try:
        return _INITS[name]
    except KeyError:
        raise ValueError(
            f"Unknown initializer {name!r}; known: {sorted(_INITS)}") from None
