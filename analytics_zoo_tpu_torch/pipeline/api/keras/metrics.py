"""Validation metrics.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/metrics.py``,
reduced to what the ported slices evaluate: ``Accuracy`` (zero-based
label aware), ``Top5Accuracy`` and ``Loss``.  Metrics stream: ``init() -> acc``,
``update(acc, y_true, y_pred, mask=None) -> acc``, ``result(acc) ->
float``.  The accumulator holds device scalars, so an evaluation reads
nothing back until ``result``.  ``mask`` is an optional per-sample 0/1
weight vector: the padded tail of an evaluation is masked out.  The JAX
package's other metric names raise ``NotImplementedError`` until they
are ported.
"""

from __future__ import annotations

import torch

from .objectives import _batch_mean


def _sample_mask(mask, n, device):
    """A float (n,) weight vector (all ones when ``mask`` is None); a
    per-sample mask repeats over a sample's positions when predictions
    flatten to batch * T elements."""
    if mask is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    w = torch.as_tensor(mask, device=device).reshape(-1).float()
    if w.shape[0] != n and n % w.shape[0] == 0:
        w = w.repeat_interleave(n // w.shape[0])
    return w


class Metric:
    name = "metric"

    def init(self):
        raise NotImplementedError

    def update(self, acc, y_true, y_pred, mask=None):
        raise NotImplementedError

    def result(self, acc) -> float:
        raise NotImplementedError


class Accuracy(Metric):
    """Classification accuracy over int or one-hot labels, multiclass
    (argmax) or binary (> 0.5) outputs; ``zero_based_label=False`` takes
    1-based integer labels."""

    name = "accuracy"

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def init(self):
        return {"correct": 0.0, "total": 0.0}

    def update(self, acc, y_true, y_pred, mask=None):
        y_true = torch.as_tensor(y_true, device=y_pred.device)
        if y_pred.dim() >= 2 and y_pred.shape[-1] > 1:
            pred = y_pred.argmax(dim=-1)
            if (y_true.dim() == y_pred.dim()
                    and y_true.shape[-1] == y_pred.shape[-1]):
                true = y_true.argmax(dim=-1)
            else:
                true = y_true.squeeze().long()
                if not self.zero_based_label:
                    true = true - 1
                true = true.reshape(pred.shape)
        else:
            pred = (y_pred.squeeze(-1) if y_pred.dim() > 1 else y_pred) > 0.5
            true = y_true.squeeze(-1) if y_true.dim() > 1 else y_true
            if not self.zero_based_label:
                true = true - 1
            true = true > 0.5
        w = _sample_mask(mask, pred.shape[0] if pred.dim() else 1,
                         y_pred.device)
        w = w.reshape((-1,) + (1,) * (pred.dim() - 1))
        per_elem = w * torch.ones(pred.shape, device=y_pred.device)
        correct = torch.sum((pred == true) * per_elem)
        return {"correct": acc["correct"] + correct,
                "total": acc["total"] + torch.sum(per_elem)}

    def result(self, acc) -> float:
        total = torch.as_tensor(acc["total"]).clamp_min(1)
        return float(acc["correct"] / total)


class Top5Accuracy(Metric):
    """Share of samples whose label is among the five highest scores,
    ranked as ``jnp.argsort``'s last five: a stable ascending sort, so of
    tied scores the higher class indices rank first."""

    name = "top5accuracy"

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def init(self):
        return {"correct": 0.0, "total": 0.0}

    def update(self, acc, y_true, y_pred, mask=None):
        true = torch.as_tensor(y_true, device=y_pred.device).squeeze()
        true = true.long().reshape(-1)
        if not self.zero_based_label:
            true = true - 1
        w = _sample_mask(mask, true.shape[0], y_pred.device)
        top5 = torch.argsort(y_pred, dim=-1, stable=True)[..., -5:]
        top5 = top5.reshape(len(true), 5)
        hit = (top5 == true[:, None]).any(dim=-1)
        return {"correct": acc["correct"] + torch.sum(hit * w),
                "total": acc["total"] + torch.sum(w)}

    def result(self, acc) -> float:
        total = torch.as_tensor(acc["total"]).clamp_min(1)
        return float(acc["correct"] / total)


class Loss(Metric):
    """Mean per-sample loss over the validation set."""

    name = "loss"

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def init(self):
        return {"sum": 0.0, "total": 0.0}

    def update(self, acc, y_true, y_pred, mask=None):
        per_sample = _batch_mean(self.loss_fn(y_true, y_pred))
        w = _sample_mask(mask, per_sample.shape[0], y_pred.device)
        # a padded sample may be NaN (the label guard); NaN * 0 is NaN
        per_sample = torch.where(w > 0, per_sample, 0.0)
        return {"sum": acc["sum"] + torch.sum(per_sample * w),
                "total": acc["total"] + torch.sum(w)}

    def result(self, acc) -> float:
        total = torch.as_tensor(acc["total"]).clamp_min(1)
        return float(acc["sum"] / total)


_NOT_PORTED = {"auc", "mae", "hitratio", "hit_ratio", "hitrate", "ndcg"}


def get(name, zero_based_label=True):
    """Resolve a metric name or instance; a string-built ``Accuracy``
    takes ``zero_based_label`` (the loss's label base, from compile)."""
    if isinstance(name, Metric):
        return name
    key = str(name).lower()
    if key in ("accuracy", "acc"):
        return Accuracy(zero_based_label=zero_based_label)
    if key in ("top5accuracy", "top5", "top5acc"):
        return Top5Accuracy(zero_based_label=zero_based_label)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet (see ROADMAP.md); ported: "
            "accuracy, top5accuracy")
    raise ValueError(f"Unknown metric {name!r}")
