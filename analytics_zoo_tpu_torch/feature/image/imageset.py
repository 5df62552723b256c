"""ImageSet: a collection of images flowing through transform chains.

Counterpart of ``analytics_zoo_tpu/feature/image/imageset.py`` (the
reference's ``ImageSet.scala``), and a copy of it: ``read`` from a file,
a directory or a glob (labels from the class folders), ``from_arrays``,
``transform``/``>>``, ``copy``, ``to_array``, ``labels``, the bridge to
the port's :class:`~analytics_zoo_tpu_torch.data.dataset.Dataset`, and
the predictions a model attaches.  One host's collection plays both of
the reference's roles, local and distributed.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np

from ..common import Preprocessing
from .transforms import ImageBytesToMat, ImageFeature


class ImageSet:
    """A set of ImageFeatures + the transform API."""

    def __init__(self, features: Sequence[ImageFeature]):
        self.features: List[ImageFeature] = list(features)
        self.predictions: Optional[np.ndarray] = None

    # ---- constructors (ImageSet.read parity, ImageSet.scala:80-117) ----
    @classmethod
    def read(cls, path: str, with_label: bool = False,
             one_based_label: bool = True) -> "ImageSet":
        """Read images from a file/dir/glob.  With ``with_label``, each
        immediate subdirectory name becomes a class label (the layout the
        reference's finetune examples use)."""
        if os.path.isfile(path):
            paths = [path]
        elif os.path.isdir(path):
            paths = sorted(
                p for p in glob.glob(os.path.join(path, "**", "*"),
                                     recursive=True) if os.path.isfile(p))
        else:
            paths = sorted(glob.glob(path))
        label_map = {}
        feats = []
        for p in paths:
            f = ImageFeature()
            with open(p, "rb") as fh:
                f["image"] = fh.read()
            f["uri"] = p
            if with_label:
                cls_name = os.path.basename(os.path.dirname(p))
                if cls_name not in label_map:
                    label_map[cls_name] = len(label_map) + (
                        1 if one_based_label else 0)
                f["label"] = np.asarray([label_map[cls_name]],
                                        dtype=np.float32)
            feats.append(f)
        out = cls(feats)
        out.label_map = label_map
        # decode eagerly so downstream transforms see arrays
        return out.transform(ImageBytesToMat())

    @classmethod
    def from_arrays(cls, images: np.ndarray,
                    labels: Optional[np.ndarray] = None) -> "ImageSet":
        feats = []
        for i, img in enumerate(images):
            f = ImageFeature()
            f["image"] = np.asarray(img, dtype=np.float32)
            if labels is not None:
                f["label"] = np.asarray(labels[i])
            feats.append(f)
        return cls(feats)

    # ---- transform (ImageSet.scala:99) ----
    def transform(self, transformer: Preprocessing) -> "ImageSet":
        self.features = [transformer.apply(f) for f in self.features]
        return self

    def copy(self) -> "ImageSet":
        """Shallow-copy the set with COPIED feature dicts: transforms on
        the copy reassign keys on the new dicts, so the original set's
        images survive (arrays are shared until a transform replaces
        them, never mutated in place).  Preserves the concrete class and
        set-level attributes (predictions, label_map, ...)."""
        new = type(self)([type(f)(f) for f in self.features])
        for k, v in self.__dict__.items():
            if k != "features":
                setattr(new, k, v)
        return new

    # sugar matching the reference's ``imageset -> transformer``
    def __rshift__(self, transformer: Preprocessing) -> "ImageSet":
        return self.transform(transformer)

    # ---- bridges ----
    def to_array(self, key: str = None) -> np.ndarray:
        """Stack into one batch array (tensor key if materialized)."""
        key = key or ("tensor" if self.features
                      and "tensor" in self.features[0] else "image")
        return np.stack([np.asarray(f[key], dtype=np.float32)
                         for f in self.features])

    def labels(self) -> Optional[np.ndarray]:
        if not self.features or "label" not in self.features[0]:
            return None
        return np.stack([np.asarray(f["label"]) for f in self.features])

    def to_dataset(self):
        """Bridge to the training Dataset (the reference's
        ImageSet→DataSet conversion, ImageSet.scala:130-170)."""
        from ...data.dataset import Dataset
        return Dataset.from_ndarray(self.to_array(), self.labels())

    def set_predictions(self, preds):
        if (isinstance(preds, list) and preds
                and isinstance(preds[0], (list, tuple)) and preds[0]
                and isinstance(preds[0][0], tuple)):
            # structured per-image results — label_output's
            # [(label, confidence), ...] lists: keep python objects,
            # np.asarray would stringify the mixed types.  Plain numeric
            # list-of-lists still becomes an ndarray below.
            self.predictions = list(preds)
        else:
            self.predictions = np.asarray(preds)
        for f, p in zip(self.features, self.predictions):
            f["predict"] = p

    def get_predicts(self):
        """Parity: ImageSet.getPredicts — list of (uri, prediction)."""
        return [(f.get("uri"), f.get("predict")) for f in self.features]

    def __len__(self):
        return len(self.features)


class LocalImageSet(ImageSet):
    """Alias matching the reference's Local/Distributed split; one host's
    collection serves both."""


DistributedImageSet = LocalImageSet
