"""Loss functions: each is ``fn(y_true, y_pred) -> per-sample loss``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/objectives.py``,
reduced to the losses the training slice runs: ``class_nll`` (with its
class form ``ClassNLLCriterion``) and ``sparse_categorical_crossentropy``.
The trainer takes the mean over everything a loss returns, so sequence
targets (batch, seq) give per-position losses.  The JAX package's other
objectives are known names here that raise ``NotImplementedError`` until
they are ported (see ROADMAP.md).
"""

from __future__ import annotations

import torch

EPS = 1e-7


def _batch_mean(x):
    """Mean over all non-batch axes -> per-sample scalar."""
    return x.mean(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x


def _align_labels(y_true, y_pred):
    """Labels shaped ``y_pred.shape[:-1]``: squeeze only a trailing
    singleton class axis, so that (1, S) sequence targets keep their
    batch axis."""
    labels = torch.as_tensor(y_true, device=y_pred.device).long()
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
    logp = torch.log(y_pred.clamp(EPS, 1.0))
    return _guarded_label_pick(logp, labels)


def class_nll(y_true, y_pred, zero_based_label=True):
    """y_true int labels, y_pred log-probabilities (a log-softmax head).
    ``zero_based_label=False`` takes the reference's 1-based labels."""
    labels = _align_labels(y_true, y_pred)
    if not zero_based_label:
        labels = labels - 1
    return _guarded_label_pick(y_pred, labels)


class ClassNLLCriterion:
    """Class form of ``class_nll``, carrying its label base."""

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def __call__(self, y_true, y_pred):
        return class_nll(y_true, y_pred,
                         zero_based_label=self.zero_based_label)

    def __repr__(self):
        return f"ClassNLLCriterion(zero_based_label={self.zero_based_label})"


_LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "class_nll": class_nll,
    "classnll": class_nll,
}

#: the JAX package's other loss names, not ported yet
_NOT_PORTED = {
    "mse", "mean_squared_error", "mae", "mean_absolute_error", "mape",
    "mean_absolute_percentage_error", "msle",
    "mean_squared_logarithmic_error", "binary_crossentropy",
    "categorical_crossentropy", "hinge", "squared_hinge", "poisson", "kld",
    "kullback_leibler_divergence", "cosine_proximity", "rank_hinge",
}


def get(name):
    if name is None or callable(name):
        return name
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (see ROADMAP.md); ported: "
            f"{sorted(_LOSSES)}")
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; known: "
                         f"{sorted(_LOSSES)}") from None
