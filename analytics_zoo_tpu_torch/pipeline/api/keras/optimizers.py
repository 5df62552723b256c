"""Optimizer resolution: Keras-1 names and dicts -> a chain of gradient
transforms with optax's update math.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/optimizers.py``,
which resolves every name to its optax alias.  The port reproduces optax
0.2.6's arithmetic, defaults and transform order, not ``torch.optim``'s:
``sgd``, ``adam``, ``adamax``, ``adagrad`` (accumulator from 0.1),
``adadelta``, ``rmsprop`` (eps inside the square root), ``adamw``
(decay after the adam scaling, before the rate), ``lamb`` and ``lars``
(trust ratios); clipping chains in front as ``optax.clip`` /
``optax.clip_by_global_norm``.

A :class:`ZooOptimizer` holds no parameters: ``init(params)`` makes the
state for a list of tensors, and ``apply(params, grads, state)`` updates
the parameters in place.  The step count lives on the host, so neither
the schedule nor a bias correction reads anything from the device.
Every transform's ``update(updates, state, count, params)`` returns new
update tensors and changes only its own state.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

#: default learning rates of every name the JAX package resolves
DEFAULTS = {"sgd": 0.01, "adam": 1e-3, "adamax": 2e-3, "adagrad": 1e-2,
            "adadelta": 1.0, "rmsprop": 1e-3, "adamw": 1e-3, "lamb": 1e-3,
            "lars": 1e-3}


def _correction(decay, count):
    """optax's bias correction 1 - decay**(count + 1) in f32: numpy's f32
    power is the one that rounds as XLA's does (torch's f32 pow
    multiplies out small integer powers and differs in the last bit)."""
    return float(1 - np.float32(decay) ** np.float32(count + 1))


class Clip:
    """``optax.clip``: each element into [-max_delta, max_delta]."""

    def __init__(self, max_delta: float):
        self.max_delta = float(max_delta)

    def init(self, params):
        return None

    def update(self, grads, state, count, params):
        return [g.clamp(-self.max_delta, self.max_delta) for g in grads]


class ClipByGlobalNorm:
    """``optax.clip_by_global_norm``: scale every gradient by
    max_norm / norm when the global norm reaches max_norm."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def init(self, params):
        return None

    def update(self, grads, state, count, params):
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

    def fields(self, state, count):
        return {"trace": state}

    def update(self, grads, state, count, params):
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

    def fields(self, state, count):
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}

    def update(self, grads, state, count, params):
        c1 = _correction(self.b1, count)
        c2 = _correction(self.b2, count)
        out = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            out.append((mu / c1) / (torch.sqrt(nu / c2 + self.eps_root)
                                    + self.eps))
        return out


class ScaleByAdamax:
    """``optax.scale_by_adamax``: mu as in adam, nu = max(|g| + eps, b2 *
    nu) (the infinity norm), the update mu_hat / nu."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def fields(self, state, count):
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}

    def update(self, grads, state, count, params):
        c1 = _correction(self.b1, count)
        out = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_(torch.maximum(torch.abs(g) + self.eps, self.b2 * nu))
            out.append((mu / c1) / nu)
        return out


class ScaleByRss:
    """``optax.scale_by_rss`` (adagrad): the sum of squares starts at
    ``initial_accumulator_value``; the update is g * rsqrt(sum + eps),
    0 where the sum is 0."""

    def __init__(self, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.initial = float(initial_accumulator_value)
        self.eps = float(eps)

    def init(self, params):
        return [torch.full_like(p, self.initial) for p in params]

    def fields(self, state, count):
        return {"sum_of_squares": state}

    def update(self, grads, state, count, params):
        out = []
        for g, t in zip(grads, state):
            t.copy_(g * g + t)
            scale = torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0)
            out.append(scale * g)
        return out


class ScaleByRms:
    """``optax.scale_by_rms`` (rmsprop): nu = (1 - decay) g^2 + decay nu
    from ``initial_scale``; the update g * rsqrt(nu + eps), eps inside
    the root (``torch.optim.RMSprop`` adds it outside)."""

    def __init__(self, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0):
        self.decay, self.eps = float(decay), float(eps)
        self.initial = float(initial_scale)

    def init(self, params):
        return [torch.full_like(p, self.initial) for p in params]

    def fields(self, state, count):
        return {"nu": state}

    def update(self, grads, state, count, params):
        out = []
        for g, nu in zip(grads, state):
            nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
            out.append(torch.rsqrt(nu + self.eps) * g)
        return out


class ScaleByAdadelta:
    """``optax.scale_by_adadelta``: e_g, the moving mean of g^2; the
    update sqrt(e_x + eps) / sqrt(e_g + eps) * g; then e_x, the moving
    mean of the update's square."""

    def __init__(self, rho: float = 0.9, eps: float = 1e-6):
        self.rho, self.eps = float(rho), float(eps)

    def init(self, params):
        return {"e_g": [torch.zeros_like(p) for p in params],
                "e_x": [torch.zeros_like(p) for p in params]}

    def fields(self, state, count):
        return {"e_g": state["e_g"], "e_x": state["e_x"]}

    def update(self, grads, state, count, params):
        out = []
        for g, e_g, e_x in zip(grads, state["e_g"], state["e_x"]):
            e_g.copy_((1 - self.rho) * (g * g) + self.rho * e_g)
            u = (torch.sqrt(e_x + self.eps) / torch.sqrt(e_g + self.eps)) * g
            e_x.copy_((1 - self.rho) * (u * u) + self.rho * e_x)
            out.append(u)
        return out


class AddDecayedWeights:
    """``optax.add_decayed_weights``: the update plus weight_decay *
    param."""

    def __init__(self, weight_decay: float):
        self.weight_decay = float(weight_decay)

    def init(self, params):
        return None

    def update(self, grads, state, count, params):
        return [g + self.weight_decay * p for g, p in zip(grads, params)]


class ScaleByTrustRatio:
    """``optax.scale_by_trust_ratio``: each update times trust_coefficient
    * |param| / (|update| + eps) (Frobenius norms), or 1 where either
    norm is 0."""

    def __init__(self, trust_coefficient: float = 1.0, eps: float = 0.0):
        self.trust_coefficient = float(trust_coefficient)
        self.eps = float(eps)

    def init(self, params):
        return None

    def update(self, grads, state, count, params):
        out = []
        for u, p in zip(grads, params):
            p_norm = torch.linalg.vector_norm(p)
            u_norm = torch.linalg.vector_norm(u)
            ratio = self.trust_coefficient * p_norm / (u_norm + self.eps)
            ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0), 1.0,
                                ratio)
            out.append(u * ratio)
        return out


class ScaleByLearningRate:
    """``optax.scale_by_learning_rate``: the update times -lr(count).
    ``scheduled`` (a rate with a decay) is optax's ``scale_by_schedule``,
    whose state keeps the update count."""

    def __init__(self, lr_fn: Callable[[int], float],
                 scheduled: bool = False):
        self.lr_fn = lr_fn
        self.scheduled = bool(scheduled)

    def init(self, params):
        return None

    def fields(self, state, count):
        return {"count": count} if self.scheduled else {}

    def update(self, grads, state, count, params):
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
    own state changes in place.

    ``slots`` places each transform where optax keeps its state: the
    key path of its state in the JAX package's ``opt_state`` tree (the
    transform's index in optax's chain, under the clipping chain's index
    when clipping is composed in front), so :meth:`state_tree` names
    every leaf as optax does."""

    def __init__(self, transforms: List, lr_fn: Callable[[int], float],
                 slots: Optional[Sequence[tuple]] = None):
        self.transforms = list(transforms)
        self.lr_fn = lr_fn
        self.slots = ([tuple(s) for s in slots] if slots is not None
                      else [(str(i),) for i in range(len(self.transforms))])

    def init(self, params) -> OptState:
        return OptState([t.init(params) for t in self.transforms])

    @torch.no_grad()
    def apply(self, params, grads, state: OptState,
              frozen: Optional[Sequence[bool]] = None) -> None:
        """One update: params <- params + chain(grads), in place.  A
        parameter flagged in ``frozen`` is not moved (its update is
        dropped), whatever the chain computed for it; its statistics
        still advance on the gradient given, which the trainer zeroes."""
        updates = list(grads)
        for t, s in zip(self.transforms, state.states):
            updates = t.update(updates, s, state.count, params)
        for i, (p, u) in enumerate(zip(params, updates)):
            if not (frozen and frozen[i]):
                p.add_(u)
        state.count += 1

    def state_tree(self, state: OptState, paths: Sequence[tuple]) -> dict:
        """The state as optax's tree in the JAX package's checkpoints:
        ``{slot: {".<field>": {layer: {param: tensor}}}}``, where a
        per-parameter field nests by ``paths`` (each parameter's key path
        in the params tree) and ``.count`` is an int32 scalar.  The
        tensors are the state's own."""
        tree: dict = {}
        for t, s, slot in zip(self.transforms, state.states, self.slots):
            fields = t.fields(s, state.count) if hasattr(t, "fields") \
                else {}
            if not fields:
                continue
            node = tree
            for key in slot:
                node = node.setdefault(key, {})
            for name, value in fields.items():
                if name == "count":
                    node[".count"] = np.int32(value)
                    continue
                sub = node.setdefault("." + name, {})
                for path, tensor in zip(paths, value):
                    leaf = sub
                    for key in path[:-1]:
                        leaf = leaf.setdefault(key, {})
                    leaf[path[-1]] = tensor
        return tree


def _schedule(lr, spec) -> Optional[Callable[[int], float]]:
    """lr, or the BigDL hyperbolic decay lr / (1 + decay * step)."""
    if lr is None:
        return None
    decay = spec.pop("decay", spec.pop("learning_rate_decay", 0.0))
    if decay:
        return lambda step: lr / (1.0 + decay * step)
    return lambda step: lr


def _take(spec: dict, *keys) -> dict:
    return {k: spec.pop(k) for k in keys if k in spec}


def _decay(spec: dict, slot: int) -> list:
    """optax's add_decayed_weights at its chain index ``slot``, left out
    at weight_decay 0 (it adds 0 * param)."""
    wd = spec.pop("weight_decay", 0.0)
    return [(slot, AddDecayedWeights(wd))] if wd else []


def _base_chain(name: str, spec: dict, rate: ScaleByLearningRate) -> list:
    """The transforms of the optax alias ``name``, in its order, with
    its defaults, each with its index in optax's chain (where optax
    keeps a stateless ``identity`` or a zero decay that the port leaves
    out, the indices skip it); its options are taken out of ``spec``.
    (With a rate given, ``decay`` was taken as the rate's decay, as in
    the JAX package; without one it reaches rmsprop as its own
    decay.)"""
    if name == "sgd":
        momentum = spec.pop("momentum", 0.0) or None
        nesterov = spec.pop("nesterov", False)
        return ([] if momentum is None
                else [(0, Trace(momentum, nesterov))]) + [(1, rate)]
    if name in ("adam", "adamw", "lamb"):
        opts = {"eps": 1e-6} if name == "lamb" else {}
        adam = ScaleByAdam(**{**opts, **_take(spec, "b1", "b2", "eps",
                                              "eps_root")})
        if name == "adam":
            return [(0, adam), (1, rate)]
        if name == "adamw":
            spec.setdefault("weight_decay", 1e-4)
            return [(0, adam), *_decay(spec, 1), (2, rate)]
        return [(0, adam), *_decay(spec, 1), (2, ScaleByTrustRatio()),
                (3, rate)]
    if name == "adamax":
        return [(0, ScaleByAdamax(**_take(spec, "b1", "b2", "eps"))),
                (1, rate)]
    if name == "adagrad":
        return [(0, ScaleByRss(**_take(spec, "initial_accumulator_value",
                                       "eps"))), (1, rate)]
    if name == "adadelta":
        return [*_decay(spec, 0),
                (1, ScaleByAdadelta(**_take(spec, "rho", "eps"))),
                (2, rate)]
    if name == "rmsprop":
        rms = ScaleByRms(**_take(spec, "decay", "eps", "initial_scale"))
        momentum = spec.pop("momentum", None)
        nesterov = spec.pop("nesterov", False)
        return [(0, rms), (1, rate)] + (
            [] if momentum is None else [(2, Trace(momentum, nesterov))])
    # lars: trust ratio at coefficient 1e-3, the rate, then momentum 0.9
    trust = ScaleByTrustRatio(**{"trust_coefficient": 1e-3,
                                 **_take(spec, "trust_coefficient", "eps")})
    return [*_decay(spec, 0), (1, trust), (2, rate),
            (3, Trace(spec.pop("momentum", 0.9),
                      spec.pop("nesterov", False)))]


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
        scheduled = lr is not None and bool(
            spec.get("decay") or spec.get("learning_rate_decay"))
        lr_fn = _schedule(lr, spec) or (
            lambda step, _lr=DEFAULTS[name]: _lr)
        base = _base_chain(name, spec,
                           ScaleByLearningRate(lr_fn, scheduled))
        if spec:
            raise TypeError(f"{name}: unknown options {sorted(spec)}")
        opt = ZooOptimizer([t for _, t in base], lr_fn,
                           slots=[(str(i),) for i, _ in base])
    chain = []
    if clip_value is not None:
        chain.append(Clip(max(abs(clip_value[0]), abs(clip_value[1]))))
    if clip_norm is not None:
        chain.append(ClipByGlobalNorm(clip_norm))
    if not chain:
        return opt
    # optax.chain(clips..., opt): opt's states nest under its index
    return ZooOptimizer(chain + opt.transforms, opt.lr_fn,
                        slots=[(str(i),) for i in range(len(chain))]
                        + [(str(len(chain)),) + s for s in opt.slots])
