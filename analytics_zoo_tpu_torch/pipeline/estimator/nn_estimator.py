"""nnframes: ML-pipeline Estimator/Transformer over dataframes.

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/nn_estimator.py``
(reference NNEstimator.scala, NNClassifier.scala, NNImageReader.scala):
``fit(df)`` drives the port's ``Trainer`` on the model's device and
returns an ``NNModel`` whose ``transform`` appends a prediction column.
The fluent setters are the reference's in snake_case.

A frame is duck-typed as in the JAX package: ``df[col].tolist()``,
``df.columns``, ``df.copy()`` and ``out[col] = values`` -- a pandas
DataFrame, or any frame of numpy columns; only ``read_images`` builds a
pandas frame (and needs pandas).  ``NNModel.save`` writes the JAX
package's files (``nnmodel.json`` and a ``weights`` checkpoint of
``{"params", "model_state"}`` keyed by layer), so each package loads the
other's saved model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

from ...data.dataset import Dataset
from ...feature.common import (Preprocessing, preprocessing_from_spec,
                               preprocessing_to_spec)
from ...train import triggers as trigger_lib
from ...train.trainer import Trainer
from ..api._convert_util import require_module
from ..api.keras import metrics as metrics_lib
from ..api.keras import objectives as objectives_lib
from ..api.keras import optimizers as optimizers_lib


class _Params:
    """The shared fluent parameters (reference NNEstimator.scala:44-143)."""

    def __init__(self):
        self.batch_size = 32
        self.max_epoch = 10
        self.end_when: Optional[trigger_lib.Trigger] = None
        self.learning_rate = 1e-3
        self.learning_rate_decay = 0.0
        self.optim_method: Any = "sgd"
        self.features_col = "features"
        self.label_col = "label"
        self.prediction_col = "prediction"
        self.caching_sample = True
        self.clip_norm: Optional[float] = None
        self.clip_value: Optional[tuple] = None
        self.validation: Optional[tuple] = None
        self.checkpoint: Optional[tuple] = None
        self.tensorboard: Optional[tuple] = None

    def set_batch_size(self, v):
        self.batch_size = int(v)
        return self

    def set_max_epoch(self, v):
        self.max_epoch = int(v)
        return self

    def set_end_when(self, trigger):
        self.end_when = trigger
        return self

    def set_learning_rate(self, v):
        self.learning_rate = float(v)
        return self

    def set_learning_rate_decay(self, v):
        self.learning_rate_decay = float(v)
        return self

    def set_optim_method(self, v):
        self.optim_method = v
        return self

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_label_col(self, v):
        self.label_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    def set_caching_sample(self, v):
        self.caching_sample = bool(v)
        return self

    def set_gradient_clipping_by_l2_norm(self, v):
        self.clip_norm = float(v)
        return self

    def set_constant_gradient_clipping(self, lo, hi):
        self.clip_value = (float(lo), float(hi))
        return self

    def set_validation(self, trigger, df, metrics, batch_size):
        """Reference ``setValidation(trigger, validationDF, vMethods,
        batchSize)``."""
        self.validation = (trigger, df, list(metrics), int(batch_size))
        return self

    def set_checkpoint(self, path, trigger=None, over_write=True):
        self.checkpoint = (path, trigger or trigger_lib.EveryEpoch(),
                           over_write)
        return self

    def set_tensorboard(self, log_dir, app_name):
        self.tensorboard = (log_dir, app_name)
        return self


def _column_to_array(df, col) -> np.ndarray:
    vals = df[col].tolist()
    arrs = [np.atleast_1d(np.asarray(v, dtype=np.float32)) for v in vals]
    return np.asarray(arrs)


class NNEstimator(_Params):
    """``fit(df) -> NNModel`` (reference NNEstimator.scala:163,359)."""

    def __init__(self, model, criterion,
                 sample_preprocessing: Optional[Preprocessing] = None,
                 feature_preprocessing: Optional[Preprocessing] = None,
                 label_preprocessing: Optional[Preprocessing] = None):
        super().__init__()
        self.model = model
        self.criterion = criterion
        self.sample_preprocessing = sample_preprocessing
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing
        self.mesh = None
        self.last_trainer: Optional[Trainer] = None

    def _to_dataset(self, df) -> Dataset:
        """The frame's features (and labels, when the label column is
        there) through the preprocessings (reference getDataSet)."""
        feats = _column_to_array(df, self.features_col)
        labels = (_column_to_array(df, self.label_col)
                  if self.label_col in df.columns else None)
        if self.feature_preprocessing is not None:
            feats = np.stack([
                np.asarray(self.feature_preprocessing.apply(f),
                           dtype=np.float32) for f in feats])
        if labels is not None and self.label_preprocessing is not None:
            labels = np.stack([
                np.asarray(self.label_preprocessing.apply(l),
                           dtype=np.float32) for l in labels])
        if self.sample_preprocessing is not None:
            pairs = [self.sample_preprocessing.apply(
                (f, None if labels is None else labels[i]))
                for i, f in enumerate(feats)]
            feats = np.stack([p[0] for p in pairs])
            if labels is not None:
                labels = np.stack([p[1] for p in pairs])
        return Dataset.from_ndarray(feats, labels)

    def _build_trainer(self) -> Trainer:
        spec = self.optim_method
        if isinstance(spec, str):
            spec = {"name": spec, "lr": self.learning_rate,
                    "decay": self.learning_rate_decay}
        opt = optimizers_lib.get(spec, clip_norm=self.clip_norm,
                                 clip_value=self.clip_value)
        loss_fn = objectives_lib.get(self.criterion)
        metric_objs = []
        if self.validation:
            # metrics named by string inherit the criterion's label base
            # (as compile and Trainer.evaluate build them)
            zero_based = getattr(loss_fn, "zero_based_label", True)
            metric_objs = [
                metrics_lib.get(m, zero_based_label=zero_based)
                for m in self.validation[2]]
        trainer = Trainer(self.model, loss_fn, opt, metrics=metric_objs,
                          mesh=self.mesh)
        if self.tensorboard:
            trainer.set_tensorboard(*self.tensorboard)
        if self.checkpoint:
            path, trig, over_write = self.checkpoint
            trainer.set_checkpoint(path, over_write, trigger=trig)
        return trainer

    def fit(self, df) -> "NNModel":
        """Train on ``df`` (reference internalFit) and return the fitted
        transformer."""
        ds = self._to_dataset(df)
        trainer = self._build_trainer()
        end = self.end_when or trigger_lib.MaxEpoch(self.max_epoch)
        val_ds, val_trigger, val_bs = None, None, None
        if self.validation:
            val_trigger, val_df, _, val_bs = self.validation
            val_ds = self._to_dataset(val_df)
        trainer.fit(ds, self.batch_size, end_trigger=end,
                    validation_data=val_ds, validation_trigger=val_trigger,
                    validation_batch_size=val_bs)
        self.last_trainer = trainer
        model = self._model_class()(
            self.model, trainer=trainer,
            feature_preprocessing=self.feature_preprocessing,
            sample_preprocessing=self.sample_preprocessing)
        model.set_features_col(self.features_col)
        model.set_prediction_col(self.prediction_col)
        model.set_batch_size(self.batch_size)
        return model

    def _model_class(self) -> type:
        """The transformer class ``fit`` makes; NNClassifier overrides."""
        return NNModel


class NNModel(_Params):
    """``transform(df)`` appends predictions (reference NNModel)."""

    def __init__(self, model, trainer: Optional[Trainer] = None,
                 feature_preprocessing: Optional[Preprocessing] = None,
                 sample_preprocessing: Optional[Preprocessing] = None):
        super().__init__()
        self.model = model
        self.feature_preprocessing = feature_preprocessing
        self.sample_preprocessing = sample_preprocessing
        if trainer is None:
            trainer = Trainer(model, None, optimizers_lib.get("sgd"))
        self.trainer = trainer

    def _features(self, df) -> np.ndarray:
        feats = _column_to_array(df, self.features_col)
        if self.feature_preprocessing is not None:
            feats = np.stack([
                np.asarray(self.feature_preprocessing.apply(f),
                           dtype=np.float32) for f in feats])
        if self.sample_preprocessing is not None:
            feats = np.stack([
                np.asarray(self.sample_preprocessing.apply((f, None))[0],
                           dtype=np.float32) for f in feats])
        return feats

    def transform(self, df):
        feats = self._features(df)
        preds = np.asarray(self.trainer.predict(feats, self.batch_size))
        out = df.copy()
        out[self.prediction_col] = [self._format_prediction(p)
                                    for p in preds]
        return out

    def _format_prediction(self, p):
        return p.tolist()

    # ---- ML persistence (the JAX package's files) ----
    def save(self, path: str, over_write: bool = True):
        from ...models.jax_params import state_tree, weight_tree
        from ...train.checkpoint import save_checkpoint
        os.makedirs(path, exist_ok=True)
        meta = {
            "class_name": type(self).__name__,
            "model": {"class_name": type(self.model).__name__,
                      "config": self.model.get_config()},
            "feature_preprocessing":
                None if self.feature_preprocessing is None else
                preprocessing_to_spec(self.feature_preprocessing),
            "sample_preprocessing":
                None if self.sample_preprocessing is None else
                preprocessing_to_spec(self.sample_preprocessing),
            "features_col": self.features_col,
            "prediction_col": self.prediction_col,
            "batch_size": self.batch_size,
        }
        mpath = os.path.join(path, "nnmodel.json")
        if os.path.exists(mpath) and not over_write:
            raise FileExistsError(path)
        with open(mpath, "w") as f:
            json.dump(meta, f)
        # inference state only (weights and layer state): the optimizer's
        # state would tie load() to the optimizer's type
        save_checkpoint(os.path.join(path, "weights"), "final",
                        {"params": weight_tree(self.model),
                         "model_state": state_tree(self.model)})

    @classmethod
    def load(cls, path: str, device=None) -> "NNModel":
        """Load a saved NNModel (of either package) onto ``device``
        (``"cuda"`` unless asked otherwise)."""
        from ...core.module import get_layer_class
        from ...models.jax_params import (from_jax_params, state_tree,
                                          weight_tree)
        from ...train.checkpoint import restore_checkpoint
        from ..api.keras.engine import resolve_model_class
        with open(os.path.join(path, "nnmodel.json")) as f:
            meta = json.load(f)
        mcls_name = meta["model"]["class_name"]
        try:
            mcls = resolve_model_class(mcls_name)
            model = mcls.from_config(meta["model"]["config"], device=device)
        except KeyError:
            model = get_layer_class(mcls_name).from_config(
                meta["model"]["config"])
        klass = NNClassifierModel if meta["class_name"] == \
            "NNClassifierModel" else cls
        obj = klass(
            model,
            feature_preprocessing=None
            if meta["feature_preprocessing"] is None else
            preprocessing_from_spec(meta["feature_preprocessing"]),
            sample_preprocessing=None
            if meta["sample_preprocessing"] is None else
            preprocessing_from_spec(meta["sample_preprocessing"]))
        obj.set_features_col(meta["features_col"])
        obj.set_prediction_col(meta["prediction_col"])
        obj.set_batch_size(meta["batch_size"])
        tree = restore_checkpoint(
            os.path.join(path, "weights"),
            {"params": weight_tree(model), "model_state": state_tree(model)})
        from_jax_params(model, tree["params"], tree["model_state"])
        return obj


class NNClassifier(NNEstimator):
    """Classification sugar: scalar zero-based labels, argmax transform
    (reference NNClassifier.scala:42)."""

    def _model_class(self) -> type:
        return NNClassifierModel


class NNClassifierModel(NNModel):
    """Argmax over the network output (reference NNClassifier.scala:140)."""

    def _format_prediction(self, p):
        return float(np.argmax(p))


def read_images(path: str, with_label: bool = False,
                resize_h: Optional[int] = None,
                resize_w: Optional[int] = None):
    """Reference ``NNImageReader``: the images under ``path`` as a pandas
    DataFrame with columns image, uri (and label).  Needs pandas."""
    pd = require_module("pandas", "read_images")
    from ...feature.image import ImageResize, ImageSet
    iset = ImageSet.read(path, with_label=with_label)
    if resize_h and resize_w:
        iset = iset.transform(ImageResize(resize_h, resize_w))
    rows = {
        "image": [f["image"] for f in iset.features],
        "uri": [f.get("uri") for f in iset.features],
    }
    if with_label:
        rows["label"] = [float(np.asarray(f["label"]).ravel()[0])
                         for f in iset.features]
    return pd.DataFrame(rows)


NNImageReader = read_images
