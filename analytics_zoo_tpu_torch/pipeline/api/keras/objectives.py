"""Loss functions: each is ``fn(y_true, y_pred) -> per-sample loss``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/objectives.py``:
the reference's thirteen Keras objectives and ``rank_hinge``, with the
JAX package's clamps and epsilons, their names and aliases, and the
class forms (``MeanSquaredError()`` is interchangeable with ``"mse"``).
The trainer takes the mean over everything a loss returns, so sequence
targets (batch, seq) give per-position losses.  Every clamp of a
differentiated operand goes through ``activations.clip`` (``jnp.clip``'s
``maximum``/``minimum`` form), so that a tie at a bound takes half the
gradient, as in the JAX package; clamps of labels and counts stay
``torch.clamp``.
"""

from __future__ import annotations

import torch

from .activations import clip

EPS = 1e-7


def _batch_mean(x):
    """Mean over all non-batch axes -> per-sample scalar."""
    return x.mean(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x


def _like(y_true, y_pred):
    """Targets as a tensor on the predictions' device."""
    return torch.as_tensor(y_true, device=y_pred.device)


def mean_squared_error(y_true, y_pred):
    return _batch_mean(torch.square(y_pred - _like(y_true, y_pred)))


def mean_absolute_error(y_true, y_pred):
    return _batch_mean(torch.abs(y_pred - _like(y_true, y_pred)))


def mean_absolute_percentage_error(y_true, y_pred):
    y_true = _like(y_true, y_pred)
    diff = torch.abs((y_true - y_pred) / torch.abs(y_true).clamp_min(EPS))
    return 100.0 * _batch_mean(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    a = torch.log(clip(y_pred, EPS) + 1.0)
    b = torch.log(clip(_like(y_true, y_pred), EPS) + 1.0)
    return _batch_mean(torch.square(a - b))


def binary_crossentropy(y_true, y_pred):
    y_true = _like(y_true, y_pred)
    p = clip(y_pred, EPS, 1.0 - EPS)
    return _batch_mean(-(y_true * torch.log(p)
                         + (1.0 - y_true) * torch.log(1.0 - p)))


def categorical_crossentropy(y_true, y_pred):
    """y_true one-hot, y_pred probabilities (post-softmax)."""
    p = clip(y_pred, EPS, 1.0)
    return -torch.sum(_like(y_true, y_pred) * torch.log(p), dim=-1)


def _align_labels(y_true, y_pred):
    """Labels shaped ``y_pred.shape[:-1]``: squeeze only a trailing
    singleton class axis, so that (1, S) sequence targets keep their
    batch axis."""
    labels = _like(y_true, y_pred).long()
    if labels.dim() == y_pred.dim() and labels.shape[-1] == 1:
        labels = labels.squeeze(-1)
    if labels.dim() == 0:
        labels = labels[None]
    return labels


def _guarded_label_pick(logp, labels):
    """-logp[label], NaN where the label lies outside [0, n_classes): a
    label-base mistake poisons the loss instead of training quietly on
    clamped labels."""
    n_classes = logp.shape[-1]
    valid = (labels >= 0) & (labels < n_classes)
    safe = labels.clamp(0, n_classes - 1)
    picked = -torch.gather(logp, -1, safe[..., None]).squeeze(-1)
    return torch.where(valid, picked, torch.nan)


def sparse_categorical_crossentropy(y_true, y_pred):
    """y_true int labels (zero-based), y_pred probabilities."""
    labels = _align_labels(y_true, y_pred)
    logp = torch.log(clip(y_pred, EPS, 1.0))
    return _guarded_label_pick(logp, labels)


def class_nll(y_true, y_pred, zero_based_label=True):
    """y_true int labels, y_pred log-probabilities (a log-softmax head).
    ``zero_based_label=False`` takes the reference's 1-based labels."""
    labels = _align_labels(y_true, y_pred)
    if not zero_based_label:
        labels = labels - 1
    return _guarded_label_pick(y_pred, labels)


def hinge(y_true, y_pred):
    return _batch_mean(clip(1.0 - _like(y_true, y_pred) * y_pred, 0.0))


def squared_hinge(y_true, y_pred):
    return _batch_mean(torch.square(
        clip(1.0 - _like(y_true, y_pred) * y_pred, 0.0)))


def poisson(y_true, y_pred):
    return _batch_mean(
        y_pred - _like(y_true, y_pred) * torch.log(y_pred + EPS))


def kullback_leibler_divergence(y_true, y_pred):
    """Keras-1's sum over the distribution axis, not a mean."""
    p = clip(_like(y_true, y_pred), EPS, 1.0)
    q = clip(y_pred, EPS, 1.0)
    return torch.sum(p * torch.log(p / q), dim=-1)


def cosine_proximity(y_true, y_pred):
    y_true = _like(y_true, y_pred)
    a = y_true / torch.linalg.vector_norm(
        y_true, dim=-1, keepdim=True).clamp_min(EPS)
    b = y_pred / clip(torch.linalg.vector_norm(
        y_pred, dim=-1, keepdim=True), EPS)
    return -torch.sum(a * b, dim=-1)


def rank_hinge(y_true, y_pred, margin=1.0):
    """Pairwise rank hinge of the ranking examples: (positive, negative)
    pairs interleaved along the batch axis."""
    loss = clip(margin - y_pred[0::2] + y_pred[1::2], 0.0)
    return torch.repeat_interleave(loss, 2, dim=0)


_LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "class_nll": class_nll,
    "classnll": class_nll,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "poisson": poisson,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "cosine_proximity": cosine_proximity,
    "rank_hinge": rank_hinge,
}


def get(name):
    if name is None or callable(name):
        return name
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; known: "
                         f"{sorted(_LOSSES)}") from None


class LossFunction:
    """Base of the class forms: an instance is the loss callable."""

    _fn = None

    def __call__(self, y_true, y_pred):
        return type(self)._fn(y_true, y_pred)

    def __repr__(self):
        return f"{type(self).__name__}()"


def _loss_class(fn, class_name):
    return type(class_name, (LossFunction,), {"_fn": staticmethod(fn)})


SparseCategoricalCrossEntropy = _loss_class(
    sparse_categorical_crossentropy, "SparseCategoricalCrossEntropy")
CategoricalCrossEntropy = _loss_class(categorical_crossentropy,
                                      "CategoricalCrossEntropy")
BinaryCrossEntropy = _loss_class(binary_crossentropy, "BinaryCrossEntropy")
MeanSquaredError = _loss_class(mean_squared_error, "MeanSquaredError")
MeanAbsoluteError = _loss_class(mean_absolute_error, "MeanAbsoluteError")
MeanAbsolutePercentageError = _loss_class(
    mean_absolute_percentage_error, "MeanAbsolutePercentageError")
MeanSquaredLogarithmicError = _loss_class(
    mean_squared_logarithmic_error, "MeanSquaredLogarithmicError")
Hinge = _loss_class(hinge, "Hinge")
SquaredHinge = _loss_class(squared_hinge, "SquaredHinge")
Poisson = _loss_class(poisson, "Poisson")
KullbackLeiblerDivergence = _loss_class(kullback_leibler_divergence,
                                        "KullbackLeiblerDivergence")
CosineProximity = _loss_class(cosine_proximity, "CosineProximity")
RankHinge = _loss_class(rank_hinge, "RankHinge")


class ClassNLLCriterion(LossFunction):
    """Class form of ``class_nll``, carrying its label base."""

    _fn = staticmethod(class_nll)

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def __call__(self, y_true, y_pred):
        return class_nll(y_true, y_pred,
                         zero_based_label=self.zero_based_label)

    def __repr__(self):
        return f"ClassNLLCriterion(zero_based_label={self.zero_based_label})"
