"""KerasNet: the compile/fit/evaluate/predict lifecycle on an nn.Module.

Counterpart of ``KerasNet`` in
``analytics_zoo_tpu/pipeline/api/keras/engine.py``.  There a KerasNet is
a graph of layers whose weights live in its Trainer's state; here it is
an ``nn.Module`` that owns its parameters, and its Trainer updates them in
place.  So ``compile`` never re-initializes weights: they come from the
model's constructor (or ``set_weights``), and a new compile only starts a
fresh optimizer state and step count.  The graph engine
(``Sequential``/``Model``), freezing, checkpoints and summaries are not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

from ....data.dataset import Dataset
from ....train import triggers as trigger_lib
from ....train.trainer import Trainer, predict_batches
from . import metrics as metrics_lib
from . import objectives as objectives_lib
from . import optimizers as optimizers_lib


class KerasNet(nn.Module):
    """Compiled-model lifecycle: subclasses define ``forward``."""

    def __init__(self):
        super().__init__()
        self.trainer: Optional[Trainer] = None
        self._compile_args: Optional[dict] = None
        self._clip_norm = None
        self._clip_value = None

    def compile(self, optimizer, loss, metrics: Sequence = (),
                seed: int = 0, compute_dtype=None):
        """Resolve the loss, the optimizer (with the clipping set before
        compile) and the metrics; string metrics inherit the loss's
        ``zero_based_label``.  ``seed`` orders the shuffled batches.
        ``compute_dtype`` is not ported yet and raises at ``fit``."""
        loss_fn = objectives_lib.get(loss)
        opt = optimizers_lib.get(optimizer, clip_norm=self._clip_norm,
                                 clip_value=self._clip_value)
        zero_based = getattr(loss_fn, "zero_based_label", True)
        metric_objs = [metrics_lib.get(m, zero_based_label=zero_based)
                       for m in metrics]
        self.trainer = Trainer(self, loss_fn, opt, metrics=metric_objs,
                               seed=seed, compute_dtype=compute_dtype)
        self._compile_args = {"optimizer": optimizer, "loss": loss,
                              "metrics": list(metrics)}
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Clip gradients by their global L2 norm; call before compile."""
        self._clip_norm = float(clip_norm)

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clip each gradient element to +-max(|min|, |max|); call before
        compile."""
        self._clip_value = (float(min_value), float(max_value))

    def clear_gradient_clipping(self):
        """Drop both clippings; call before compile."""
        self._clip_norm = None
        self._clip_value = None

    def _require_compiled(self):
        if self.trainer is None:
            raise RuntimeError(
                "Model must be compiled before fit/evaluate "
                "(reference requires compile before fit too)")

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, shuffle: bool = True,
            verbose: bool = False):
        """Train for ``nb_epoch`` more epochs on ``x``/``y`` (arrays or a
        Dataset); batches go to the model's device.  Returns the history
        ``{"loss": [...], "val": [...]}``."""
        self._require_compiled()
        ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x, y)
        val_ds = None
        if validation_data is not None:
            val_ds = (validation_data if isinstance(validation_data, Dataset)
                      else Dataset.from_ndarray(*validation_data))
        self.trainer.ensure_initialized()
        start_epoch = self.trainer.state.epoch
        return self.trainer.fit(
            ds, batch_size,
            end_trigger=trigger_lib.MaxEpoch(start_epoch + nb_epoch),
            validation_data=val_ds, shuffle=shuffle, verbose=verbose)

    def evaluate(self, x, y=None, batch_size: int = 32,
                 metrics=None) -> Dict[str, float]:
        """Compiled metrics (or ``metrics``) and the mean loss over all of
        ``x``/``y``."""
        self._require_compiled()
        ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x, y)
        return self.trainer.evaluate(ds, batch_size, metrics=metrics)

    def predict(self, x, batch_size: int = 32):
        """Forward ``x`` in batches without dropout; numpy out.  Needs no
        compile."""
        return predict_batches(self, x, batch_size)

    def get_weights(self):
        """The parameters as the JAX package's tree: {layer: {name:
        numpy array}}."""
        # models/ imports this module, so its helpers load at call time
        from ....models.jax_params import to_jax_params
        return to_jax_params(self)

    def set_weights(self, params):
        """Load a {layer: {name: array}} tree (this package's or the JAX
        package's ``get_weights()``) in place."""
        # models/ imports this module, so its helpers load at call time
        from ....models.jax_params import from_jax_params
        from_jax_params(self, params)
