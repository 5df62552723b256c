"""Weight regularizers: ``W_regularizer``/``b_regularizer`` of the
Keras-1 layers (reference BigDL L1/L2/L1L2Regularizer).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/regularizers.py``.
A regularizer maps a weight tensor to a scalar penalty.  There a
regularized layer surfaces its penalty in its state under ``aux_loss``;
here the forward of a regularized layer appends its penalty to the
collector that :func:`collect_penalties` opens, and nowhere else
(SwitchMoE adds its load-balancing loss the same way,
:func:`add_penalty`).  The
trainer opens one around the differentiated forward (so the penalty
reaches the weights) and around each evaluation batch (so validation
losses include it, per sample, as the JAX package's do).  A layer called
at two graph nodes adds its penalty twice, and nested models add theirs,
because every forward call adds.  The penalty is taken in f32 from the
parameters the forward sees: under mixed precision those are the
compute-dtype copies, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional

import torch

_ACTIVE: "contextvars.ContextVar[Optional[PenaltyCollector]]" = \
    contextvars.ContextVar("zoo_penalty_collector", default=None)


class Regularizer:
    def __call__(self, w):
        raise NotImplementedError

    def get_config(self) -> dict:
        return {"type": type(self).__name__, **self._rates()}

    def _rates(self) -> dict:
        return {}

    def __repr__(self):
        rates = ", ".join(f"{k}={v}" for k, v in self._rates().items())
        return f"{type(self).__name__}({rates})"


def _abs(w):
    """|w| with ``jnp.abs``'s gradient, +1 at 0 (``torch.abs`` gives 0
    there, and biases start at 0)."""
    return torch.where(w >= 0, w, -w)


class L1(Regularizer):
    """rate * sum(|w|)."""

    def __init__(self, l1: float = 0.01):
        self.l1 = float(l1)

    def __call__(self, w):
        return self.l1 * torch.sum(_abs(w))

    def _rates(self):
        return {"l1": self.l1}


class L2(Regularizer):
    """rate * sum(w^2)."""

    def __init__(self, l2: float = 0.01):
        self.l2 = float(l2)

    def __call__(self, w):
        return self.l2 * torch.sum(torch.square(w))

    def _rates(self):
        return {"l2": self.l2}


class L1L2(Regularizer):
    """l1 * sum(|w|) + l2 * sum(w^2)."""

    def __init__(self, l1: float = 0.01, l2: float = 0.01):
        self.l1, self.l2 = float(l1), float(l2)

    def __call__(self, w):
        return (self.l1 * torch.sum(_abs(w))
                + self.l2 * torch.sum(torch.square(w)))

    def _rates(self):
        return {"l1": self.l1, "l2": self.l2}


# the reference's BigDL class names
L1Regularizer = L1
L2Regularizer = L2
L1L2Regularizer = L1L2


def get(spec):
    """Resolve None | Regularizer | a callable | "l1"/"l2"/"l1l2" | a
    config dict.  A plain callable (``lambda w: ...``) is applied but not
    serialized."""
    if spec is None or isinstance(spec, Regularizer) or (
            callable(spec) and not isinstance(spec, type)):
        return spec
    if isinstance(spec, str):
        key = spec.lower()
        if key == "l1":
            return L1()
        if key == "l2":
            return L2()
        if key in ("l1l2", "l1_l2"):
            return L1L2()
        raise ValueError(f"Unknown regularizer {spec!r}")
    if isinstance(spec, dict):
        cfg = dict(spec)
        kind = cfg.pop("type")
        return {"L1": L1, "L2": L2, "L1L2": L1L2}[kind](**cfg)
    raise TypeError(f"Cannot interpret regularizer {spec!r}")


def to_config(reg) -> Optional[dict]:
    """A regularizer's config; None for none or for a plain callable,
    which a saved model drops."""
    if not isinstance(reg, Regularizer):
        return None
    return reg.get_config()


class PenaltyCollector:
    """The penalties that regularized layers added during one forward."""

    def __init__(self):
        self.terms: List[torch.Tensor] = []

    def total(self):
        """Their sum in call order, or None when no layer added one."""
        if not self.terms:
            return None
        out = self.terms[0]
        for t in self.terms[1:]:
            out = out + t
        return out


def add_penalty(term) -> None:
    """Add a differentiable scalar ``term`` (a SwitchMoE layer's aux
    loss) to the collector the enclosing :func:`collect_penalties`
    opened; outside one (``predict``) nothing is added."""
    collector = _ACTIVE.get()
    if collector is not None:
        collector.terms.append(term)


@contextlib.contextmanager
def collect_penalties():
    """Collect the penalties of every regularized layer's forward inside
    the block."""
    collector = PenaltyCollector()
    token = _ACTIVE.set(collector)
    try:
        yield collector
    finally:
        _ACTIVE.reset(token)


class RegularizedLayerMixin:
    """``W_regularizer``/``b_regularizer`` for a layer whose weight is
    the parameter named ``_reg_w_key`` and whose bias is ``b``.  Call
    ``_setup_regularizers`` in ``__init__`` and ``_add_penalty`` in
    ``forward``."""

    #: the parameter the W regularizer applies to (Embedding: embeddings)
    _reg_w_key = "W"

    def _setup_regularizers(self, W_regularizer, b_regularizer=None):
        self.W_regularizer = get(W_regularizer)
        self.b_regularizer = get(b_regularizer)

    def _add_penalty(self):
        collector = _ACTIVE.get()
        if collector is None or (self.W_regularizer is None
                                 and self.b_regularizer is None):
            return
        # f32 whatever the compute dtype: a bf16 sum over a large weight
        # drifts
        pen = torch.zeros((), device=getattr(self, self._reg_w_key).device)
        if self.W_regularizer is not None:
            pen = pen + self.W_regularizer(
                getattr(self, self._reg_w_key).float())
        if self.b_regularizer is not None and getattr(self, "bias", False):
            pen = pen + self.b_regularizer(self.b.float())
        add_penalty(pen)

    def _regularizer_config(self) -> dict:
        return {"W_regularizer": to_config(self.W_regularizer),
                "b_regularizer": to_config(self.b_regularizer)}
