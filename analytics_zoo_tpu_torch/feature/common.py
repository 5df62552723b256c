"""Preprocessing: composable transformers of single samples.

Counterpart of ``analytics_zoo_tpu/feature/common.py`` (the reference's
``Preprocessing[A,B]`` with ``->`` chaining and its adapter set).  The
feature layer is numpy on the host in both packages, so this module is a
copy of the JAX package's: ``>>`` chains (``ChainedPreprocessing``), the
spec registry (``register_preprocessing``, ``preprocessing_to_spec`` and
``preprocessing_from_spec``), the ``*ToTensor``/``*ToSample`` adapters
and ``Lambda``.  Tensors reach the card at the batch boundary, in the
model's ``predict``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


class Preprocessing:
    """A serializable transformer of single samples."""

    def apply(self, sample):
        raise NotImplementedError

    def __call__(self, sample):
        return self.apply(sample)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        """``a >> b``: feed a's output to b (reference ``->``)."""
        return ChainedPreprocessing([self, other])

    def map(self, iterable):
        return (self.apply(s) for s in iterable)

    # config round-trip for ML-pipeline persistence (NNEstimator.scala
    # serializes its Preprocessing with the model)
    def get_config(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, config):
        return cls(**config)


_PREPROCESSING_REGISTRY = {}


def register_preprocessing(klass):
    _PREPROCESSING_REGISTRY[klass.__name__] = klass
    return klass


def preprocessing_to_spec(p: Preprocessing) -> dict:
    if isinstance(p, ChainedPreprocessing):
        return {"class_name": "ChainedPreprocessing",
                "stages": [preprocessing_to_spec(s) for s in p.stages]}
    return {"class_name": type(p).__name__, "config": p.get_config()}


def preprocessing_from_spec(spec: dict) -> Preprocessing:
    if spec["class_name"] == "ChainedPreprocessing":
        return ChainedPreprocessing(
            [preprocessing_from_spec(s) for s in spec["stages"]])
    klass = _PREPROCESSING_REGISTRY[spec["class_name"]]
    return klass.from_config(spec.get("config", {}))


@register_preprocessing
class ChainedPreprocessing(Preprocessing):
    def __init__(self, stages: Sequence[Preprocessing]):
        self.stages: List[Preprocessing] = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                self.stages.extend(s.stages)
            else:
                self.stages.append(s)

    def apply(self, sample):
        for s in self.stages:
            sample = s.apply(sample)
        return sample


@register_preprocessing
class SeqToTensor(Preprocessing):
    """Sequence of numbers -> ndarray with optional shape
    (reference SeqToTensor.scala)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = tuple(size) if size else None

    def apply(self, sample):
        arr = np.asarray(sample, dtype=np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr

    def get_config(self):
        return {"size": list(self.size) if self.size else None}


@register_preprocessing
class ArrayToTensor(SeqToTensor):
    """reference ArrayToTensor.scala (same semantics on numpy)."""


@register_preprocessing
class ScalarToTensor(Preprocessing):
    """reference ScalarToTensor.scala."""

    def apply(self, sample):
        return np.asarray([sample], dtype=np.float32)


@register_preprocessing
class MLlibVectorToTensor(Preprocessing):
    """Accepts anything with toArray()/values or array-like
    (reference MLlibVectorToTensor.scala)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = tuple(size) if size else None

    def apply(self, sample):
        if hasattr(sample, "toArray"):
            arr = np.asarray(sample.toArray(), dtype=np.float32)
        elif hasattr(sample, "values"):
            arr = np.asarray(sample.values, dtype=np.float32)
        else:
            arr = np.asarray(sample, dtype=np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr

    def get_config(self):
        return {"size": list(self.size) if self.size else None}


@register_preprocessing
class TensorToSample(Preprocessing):
    """Feature tensor -> (feature, None) sample (reference
    TensorToSample.scala; a Sample here is just an (x, y) tuple)."""

    def apply(self, sample):
        return (sample, None)


@register_preprocessing
class FeatureLabelPreprocessing(Preprocessing):
    """Zip a feature chain and a label chain over (feature, label) pairs
    (reference FeatureLabelPreprocessing.scala)."""

    def __init__(self, feature_preprocessing: Preprocessing,
                 label_preprocessing: Optional[Preprocessing] = None):
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing

    def apply(self, sample):
        feature, label = sample
        f = self.feature_preprocessing.apply(feature)
        l = (self.label_preprocessing.apply(label)
             if self.label_preprocessing is not None and label is not None
             else label)
        return (f, l)

    def get_config(self):
        return {
            "feature_preprocessing":
                preprocessing_to_spec(self.feature_preprocessing),
            "label_preprocessing":
                None if self.label_preprocessing is None
                else preprocessing_to_spec(self.label_preprocessing),
        }

    @classmethod
    def from_config(cls, config):
        return cls(
            preprocessing_from_spec(config["feature_preprocessing"]),
            None if config.get("label_preprocessing") is None
            else preprocessing_from_spec(config["label_preprocessing"]))


@register_preprocessing
class FeatureToTupleAdapter(Preprocessing):
    """Apply a feature preprocessing, pass label through
    (reference FeatureToTupleAdapter.scala)."""

    def __init__(self, preprocessing: Preprocessing):
        self.preprocessing = preprocessing

    def apply(self, sample):
        feature, label = sample
        return (self.preprocessing.apply(feature), label)

    def get_config(self):
        return {"preprocessing": preprocessing_to_spec(self.preprocessing)}

    @classmethod
    def from_config(cls, config):
        return cls(preprocessing_from_spec(config["preprocessing"]))


@register_preprocessing
class ToTuple(Preprocessing):
    """Wrap a bare feature into a (feature, None-label) tuple
    (reference common.py:125 ToTuple)."""

    def apply(self, sample):
        if isinstance(sample, tuple):
            return sample
        return (sample, None)


@register_preprocessing
class BigDLAdapter(Preprocessing):
    """Identity adapter kept for API parity (reference BigDLAdapter.scala
    wraps a BigDL Transformer; here any callable slots in directly)."""

    def __init__(self, fn: Optional[Callable] = None):
        self.fn = fn

    def apply(self, sample):
        return self.fn(sample) if self.fn is not None else sample


@register_preprocessing
class Lambda(Preprocessing):
    """Arbitrary callable as a stage (not serializable)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def apply(self, sample):
        return self.fn(sample)
