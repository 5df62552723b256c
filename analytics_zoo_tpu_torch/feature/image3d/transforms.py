"""3-D (medical) image transforms.

Counterpart of ``analytics_zoo_tpu/feature/image3d/transforms.py`` (the
reference's Rotation, Affine, Cropper and ImageFeature3D), and a copy
of it: volumes are DHW(xC) float32 numpy arrays, resampled on the host
with ``scipy.ndimage.affine_transform`` (trilinear).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage

from ..common import Preprocessing, register_preprocessing
from ..image.transforms import ImageFeature


class ImageFeature3D(ImageFeature):
    """Per-volume record (reference ImageFeature3D.scala)."""


def _as_feature3d(sample) -> ImageFeature3D:
    if isinstance(sample, ImageFeature3D):
        return sample
    if isinstance(sample, ImageFeature):
        f = ImageFeature3D(sample)
        return f
    f = ImageFeature3D()
    if isinstance(sample, dict):
        # a plain {'image': volume, ...} record is a feature, not pixels
        if "image" not in sample:
            raise ValueError(
                "dict sample for a 3D transform needs an 'image' key")
        f.update(sample)
    else:
        f["image"] = sample
    return f


class ImageProcessing3D(Preprocessing):
    def apply(self, sample):
        f = _as_feature3d(sample)
        f["image"] = self.transform(np.asarray(f["image"],
                                               dtype=np.float32))
        return f

    def transform(self, vol: np.ndarray) -> np.ndarray:
        raise NotImplementedError


def rotation_matrix(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Euler-angle rotation matrix (reference Rotation.scala:36-61)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


@register_preprocessing
class AffineTransform3D(ImageProcessing3D):
    """Affine warp: v' = A(v - c) + c + t, trilinear interpolation
    (reference Affine.scala)."""

    def __init__(self, mat: Sequence[Sequence[float]] = None,
                 translation: Sequence[float] = (0, 0, 0),
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.mat = np.asarray(mat, dtype=np.float64)
        self.translation = np.asarray(translation, dtype=np.float64)
        self.clamp_mode = clamp_mode
        self.pad_val = float(pad_val)

    def transform(self, vol):
        squeeze = False
        if vol.ndim == 4 and vol.shape[-1] == 1:
            vol, squeeze = vol[..., 0], True
        center = (np.asarray(vol.shape) - 1) / 2.0
        # inverse map: output voxel -> input voxel
        inv = np.linalg.inv(self.mat)
        offset = center - inv @ (center + self.translation)
        mode = "nearest" if self.clamp_mode == "clamp" else "constant"
        out = ndimage.affine_transform(
            vol, inv, offset=offset, order=1, mode=mode,
            cval=self.pad_val).astype(np.float32)
        return out[..., None] if squeeze else out

    def get_config(self):
        return {"mat": self.mat.tolist(),
                "translation": self.translation.tolist(),
                "clamp_mode": self.clamp_mode, "pad_val": self.pad_val}


@register_preprocessing
class Rotate3D(AffineTransform3D):
    """Rotation by Euler angles (reference Rotation.scala:32)."""

    def __init__(self, rotation_angles: Sequence[float] = (0, 0, 0)):
        self.rotation_angles = tuple(float(a) for a in rotation_angles)
        super().__init__(mat=rotation_matrix(*self.rotation_angles))

    def get_config(self):
        return {"rotation_angles": list(self.rotation_angles)}


@register_preprocessing
class Crop3D(ImageProcessing3D):
    """Crop a patch at ``start`` (DHW) of size ``patch_size``
    (reference Cropper.scala:34)."""

    def __init__(self, start: Sequence[int] = None,
                 patch_size: Sequence[int] = None):
        self.start = tuple(int(s) for s in start)
        self.patch_size = tuple(int(s) for s in patch_size)

    def transform(self, vol):
        z, y, x = self.start
        d, h, w = self.patch_size
        return vol[z:z + d, y:y + h, x:x + w]

    def get_config(self):
        return {"start": list(self.start),
                "patch_size": list(self.patch_size)}


@register_preprocessing
class CenterCrop3D(ImageProcessing3D):
    def __init__(self, patch_size: Sequence[int] = None):
        self.patch_size = tuple(int(s) for s in patch_size)

    def transform(self, vol):
        starts = [(dim - p) // 2
                  for dim, p in zip(vol.shape[:3], self.patch_size)]
        return Crop3D(starts, self.patch_size).transform(vol)

    def get_config(self):
        return {"patch_size": list(self.patch_size)}


@register_preprocessing
class RandomCrop3D(ImageProcessing3D):
    def __init__(self, patch_size: Sequence[int] = None, seed: int = 0):
        self.patch_size = tuple(int(s) for s in patch_size)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, vol):
        starts = [int(self.rng.integers(0, dim - p + 1))
                  for dim, p in zip(vol.shape[:3], self.patch_size)]
        return Crop3D(starts, self.patch_size).transform(vol)

    def get_config(self):
        return {"patch_size": list(self.patch_size), "seed": self.seed}


# reference-name alias (transformation.py ImagePreprocessing3D)
ImagePreprocessing3D = ImageProcessing3D
