"""Validation metrics.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/metrics.py``:
``Accuracy`` and ``Top5Accuracy`` (zero-based label aware), ``AUC`` (the
reference's threshold sweep), ``MAE``, ``Loss``, and the grouped ranking
metrics ``HitRatio`` and ``NDCG``.  Metrics stream: ``init() -> acc``,
``update(acc, y_true, y_pred, mask=None) -> acc``, ``result(acc) ->
float``.  The accumulator holds device tensors, so an evaluation reads
nothing back until ``result``.  ``mask`` is an optional per-sample 0/1
weight vector: the padded tail of an evaluation is masked out.
"""

from __future__ import annotations

import math
import warnings

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


class AUC(Metric):
    """Area under the ROC curve by a sweep of ``threshold_num``
    thresholds over [0, 1] (reference AUC.scala)."""

    name = "auc"

    def __init__(self, threshold_num: int = 200):
        self.threshold_num = int(threshold_num)

    def init(self):
        n = self.threshold_num
        return {"tp": torch.zeros((n,)), "fp": torch.zeros((n,)),
                "pos": 0.0, "neg": 0.0}

    def update(self, acc, y_true, y_pred, mask=None):
        dev = y_pred.device
        scores = y_pred
        if scores.dim() > 1 and scores.shape[-1] == 2:
            scores = scores[..., 1]  # binary softmax: P(positive class)
        scores = scores.reshape(-1).float()
        labels = torch.as_tensor(y_true, device=dev)
        if labels.dim() > 1 and labels.shape[-1] == 2:
            labels = labels.argmax(dim=-1)
        labels = labels.reshape(-1) > 0.5
        if scores.shape[0] != labels.shape[0]:
            raise ValueError(
                f"AUC is a binary metric: y_pred {tuple(y_pred.shape)} does "
                "not reduce to one score per sample of y_true "
                f"{tuple(labels.shape)}")
        w = _sample_mask(mask, scores.shape[0], dev)
        thresholds = torch.linspace(0.0, 1.0, self.threshold_num,
                                    device=dev)
        above = (scores[None, :] >= thresholds[:, None]).float()
        pos_w = labels * w
        neg_w = (~labels) * w
        return {"tp": acc["tp"].to(dev) + (above * pos_w[None, :]).sum(1),
                "fp": acc["fp"].to(dev) + (above * neg_w[None, :]).sum(1),
                "pos": acc["pos"] + torch.sum(pos_w),
                "neg": acc["neg"] + torch.sum(neg_w)}

    def result(self, acc) -> float:
        tpr = acc["tp"] / torch.as_tensor(acc["pos"]).clamp_min(1)
        fpr = acc["fp"] / torch.as_tensor(acc["neg"]).clamp_min(1)
        # thresholds ascend, so the rates descend: integrate backwards
        return float(-torch.trapezoid(tpr, fpr))


class MAE(Metric):
    """Mean absolute error.  Against a multi-class head (trailing dim >
    1), integer targets one rank lower compare the argmax class with the
    label (``zero_based_label`` sets the label base); float targets take
    the elementwise path, one target against each output, with a
    warning."""

    name = "mae"

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def init(self):
        return {"sum": 0.0, "total": 0.0}

    def update(self, acc, y_true, y_pred, mask=None):
        y_true = torch.as_tensor(y_true, device=y_pred.device)
        if y_pred.dim() == y_true.dim() + 1:
            if y_pred.shape[-1] > 1 and not y_true.is_floating_point():
                y_pred = y_pred.argmax(dim=-1).float()
                if not self.zero_based_label:
                    y_true = y_true - 1
                y_true = y_true.float()
            elif y_pred.shape[-1] == 1:
                y_pred = y_pred.squeeze(-1)
            else:
                warnings.warn(
                    "MAE against a multi-output head with FLOAT targets "
                    "uses elementwise error; if the targets are class "
                    "labels (e.g. ratings), cast them to an integer "
                    "dtype for class-index MAE.", stacklevel=2)
                y_true = y_true[..., None]
        err = torch.abs(y_true - y_pred)
        w = _sample_mask(mask, err.shape[0] if err.dim() else 1,
                         y_pred.device)
        w = w.reshape((-1,) + (1,) * (err.dim() - 1))
        per_elem = w * torch.ones(err.shape, device=y_pred.device)
        return {"sum": acc["sum"] + torch.sum(err * per_elem),
                "total": acc["total"] + torch.sum(per_elem)}

    def result(self, acc) -> float:
        total = torch.as_tensor(acc["total"]).clamp_min(1)
        return float(acc["sum"] / total)


class _RankingMetric(Metric):
    """Grouped ranking metrics (BigDL HitRatio / NDCG): the batch is
    consecutive groups of ``1 + neg_num`` pairs, one positive (label 1)
    and ``neg_num`` negatives.  The positive's rank among its group's
    scores decides the credit.  A batch must be a whole number of groups,
    and a masked (padded) sample voids its whole group.  The result key
    carries k (``hit_ratio@10``)."""

    _base_name = "ranking"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = int(k)
        self.neg_num = int(neg_num)
        self.name = f"{self._base_name}@{self.k}"

    def init(self):
        return {"sum": 0.0, "total": 0.0}

    def _rank_and_weight(self, y_true, y_pred, mask):
        group = self.neg_num + 1
        if y_pred.dim() >= 2 and y_pred.shape[-1] > 1:
            y_pred = y_pred[..., -1]  # class output: the last column
        scores = y_pred.reshape(-1)
        labels = torch.as_tensor(y_true, device=y_pred.device).reshape(-1)
        n = scores.shape[0]
        if n % group:
            raise ValueError(
                f"{self.name}: batch of {n} pairs is not a multiple of "
                f"group size 1+neg_num={group}")
        w = _sample_mask(mask, n, y_pred.device).reshape(-1, group)
        g_scores = scores.reshape(-1, group)
        g_labels = labels.reshape(-1, group).float()
        pos = torch.sum(g_scores * g_labels, dim=1)
        rank = 1 + torch.sum((g_scores > pos[:, None]) & (g_labels < 0.5),
                             dim=1)
        return rank, w.amin(dim=1)

    def result(self, acc) -> float:
        total = torch.as_tensor(acc["total"]).clamp_min(1)
        return float(acc["sum"] / total)


class HitRatio(_RankingMetric):
    """hit@k: the share of groups whose positive ranks within k."""

    _base_name = "hit_ratio"

    def update(self, acc, y_true, y_pred, mask=None):
        rank, w = self._rank_and_weight(y_true, y_pred, mask)
        hits = (rank <= self.k).float()
        return {"sum": acc["sum"] + torch.sum(hits * w),
                "total": acc["total"] + torch.sum(w)}


class NDCG(_RankingMetric):
    """NDCG@k of one positive a group: log(2) / log(1 + rank) where rank
    <= k, else 0."""

    _base_name = "ndcg"

    def update(self, acc, y_true, y_pred, mask=None):
        rank, w = self._rank_and_weight(y_true, y_pred, mask)
        gain = torch.where(rank <= self.k,
                           math.log(2.0) / torch.log(1.0 + rank.float()),
                           0.0)
        return {"sum": acc["sum"] + torch.sum(gain * w),
                "total": acc["total"] + torch.sum(w)}


def get(name, zero_based_label=True):
    """Resolve a metric name or instance; a string-built ``Accuracy``,
    ``Top5Accuracy`` or ``MAE`` takes ``zero_based_label`` (the loss's
    label base, from compile)."""
    if isinstance(name, Metric):
        return name
    key = str(name).lower()
    if key in ("accuracy", "acc"):
        return Accuracy(zero_based_label=zero_based_label)
    if key in ("top5accuracy", "top5", "top5acc"):
        return Top5Accuracy(zero_based_label=zero_based_label)
    if key == "auc":
        return AUC()
    if key == "mae":
        return MAE(zero_based_label=zero_based_label)
    if key in ("hitratio", "hit_ratio", "hitrate"):
        return HitRatio()
    if key == "ndcg":
        return NDCG()
    raise ValueError(f"Unknown metric {name!r}")
