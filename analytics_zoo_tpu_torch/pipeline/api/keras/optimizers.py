"""Optimizer resolution: Keras-1 names and dicts -> a chain of gradient
transforms with optax's update math.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/optimizers.py``,
which resolves to optax transforms.  The port reproduces optax's
arithmetic, not ``torch.optim``'s: ``sgd`` is ``optax.sgd`` (optional
momentum trace, nesterov), ``adam`` is ``optax.adam`` (bias-corrected
moments, ``eps`` outside the square root), and clipping chains in front
as ``optax.clip`` / ``optax.clip_by_global_norm``.  The other names the
JAX package knows raise ``NotImplementedError`` until they are ported.

A :class:`ZooOptimizer` holds no parameters: ``init(params)`` makes the
state for a list of tensors, and ``apply(params, grads, state)`` updates
the parameters in place.  The step count lives on the host, so neither
the schedule nor the bias correction reads anything from the device.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

#: default learning rates of every name the JAX package resolves
DEFAULTS = {"sgd": 0.01, "adam": 1e-3, "adamax": 2e-3, "adagrad": 1e-2,
            "adadelta": 1.0, "rmsprop": 1e-3, "adamw": 1e-3, "lamb": 1e-3,
            "lars": 1e-3}


class Clip:
    """``optax.clip``: each element into [-max_delta, max_delta]."""

    def __init__(self, max_delta: float):
        self.max_delta = float(max_delta)

    def init(self, params):
        return None

    def update(self, grads, state, count):
        return [g.clamp(-self.max_delta, self.max_delta) for g in grads]


class ClipByGlobalNorm:
    """``optax.clip_by_global_norm``: scale every gradient by
    max_norm / norm when the global norm reaches max_norm."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def init(self, params):
        return None

    def update(self, grads, state, count):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        return [torch.where(keep, g, (g / norm) * self.max_norm)
                for g in grads]


class Trace:
    """``optax.trace``: t = g + decay * t; the update is t, or
    g + decay * t under nesterov."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay = float(decay)
        self.nesterov = bool(nesterov)

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, grads, state, count):
        out = []
        for g, t in zip(grads, state):
            t.copy_(g + self.decay * t)
            out.append(g + self.decay * t if self.nesterov else t)
        return out


class ScaleByAdam:
    """``optax.scale_by_adam``: mu and nu moving averages, bias-corrected
    with 1 - b**(count + 1) taken in f32, then mu_hat / (sqrt(nu_hat +
    eps_root) + eps)."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @staticmethod
    def _correction(decay, count):
        # optax's 1 - decay**count in f32: numpy's f32 power is the one
        # that rounds as XLA's does (torch's f32 pow multiplies out small
        # integer powers and differs in the last bit)
        return float(1 - np.float32(decay) ** np.float32(count + 1))

    def update(self, grads, state, count):
        c1 = self._correction(self.b1, count)
        c2 = self._correction(self.b2, count)
        out = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            out.append((mu / c1) / (torch.sqrt(nu / c2 + self.eps_root)
                                    + self.eps))
        return out


class ScaleByLearningRate:
    """``optax.scale_by_learning_rate``: the update times -lr(count)."""

    def __init__(self, lr_fn: Callable[[int], float]):
        self.lr_fn = lr_fn

    def init(self, params):
        return None

    def update(self, grads, state, count):
        step = -self.lr_fn(count)
        return [g * step for g in grads]


class OptState:
    """The chain's per-transform states and the number of updates made."""

    def __init__(self, states: list, count: int = 0):
        self.states = states
        self.count = count


class ZooOptimizer:
    """A chain of gradient transforms plus the learning-rate schedule
    ``lr_fn(step)`` (the rate the step numbered ``step``, from 0, used).
    A transform never writes to the update tensors it is given; only its
    own state changes in place."""

    def __init__(self, transforms: List, lr_fn: Callable[[int], float]):
        self.transforms = list(transforms)
        self.lr_fn = lr_fn

    def init(self, params) -> OptState:
        return OptState([t.init(params) for t in self.transforms])

    @torch.no_grad()
    def apply(self, params, grads, state: OptState) -> None:
        """One update: params <- params + chain(grads), in place."""
        updates = list(grads)
        for t, s in zip(self.transforms, state.states):
            updates = t.update(updates, s, state.count)
        for p, u in zip(params, updates):
            p.add_(u)
        state.count += 1


def _schedule(lr, spec) -> Optional[Callable[[int], float]]:
    """lr, or the BigDL hyperbolic decay lr / (1 + decay * step)."""
    if lr is None:
        return None
    decay = spec.pop("decay", spec.pop("learning_rate_decay", 0.0))
    if decay:
        return lambda step: lr / (1.0 + decay * step)
    return lambda step: lr


def get(optimizer, clip_norm: Optional[float] = None,
        clip_value: Optional[tuple] = None) -> ZooOptimizer:
    """Resolve an optimizer spec (a name, a dict {"name", "lr" or
    "learning_rate", "decay", extra options} or a ZooOptimizer) and chain
    the clipping transforms in front: clip by value, then by global
    norm."""
    if isinstance(optimizer, ZooOptimizer):
        opt = optimizer
    else:
        if isinstance(optimizer, str):
            spec = {"name": optimizer}
        elif isinstance(optimizer, dict):
            spec = dict(optimizer)
        else:
            raise TypeError(f"Cannot resolve optimizer {optimizer!r}")
        name = spec.pop("name").lower()
        if name not in DEFAULTS:
            raise ValueError(f"Unknown optimizer {name!r}")
        lr = spec.pop("lr", spec.pop("learning_rate", None))
        lr_fn = _schedule(lr, spec) or (
            lambda step, _lr=DEFAULTS[name]: _lr)
        if name == "sgd":
            momentum = spec.pop("momentum", 0.0) or None
            nesterov = spec.pop("nesterov", False)
            base = [] if momentum is None else [Trace(momentum, nesterov)]
        elif name == "adam":
            base = [ScaleByAdam(**{k: spec.pop(k) for k in
                                   ("b1", "b2", "eps", "eps_root")
                                   if k in spec})]
        else:
            raise NotImplementedError(
                f"optimizer {name!r} is not ported yet (see ROADMAP.md); "
                "ported: adam, sgd")
        if spec:
            raise TypeError(f"{name}: unknown options {sorted(spec)}")
        opt = ZooOptimizer(base + [ScaleByLearningRate(lr_fn)], lr_fn)
    chain = []
    if clip_value is not None:
        chain.append(Clip(max(abs(clip_value[0]), abs(clip_value[1]))))
    if clip_norm is not None:
        chain.append(ClipByGlobalNorm(clip_norm))
    if not chain:
        return opt
    return ZooOptimizer(chain + opt.transforms, opt.lr_fn)
