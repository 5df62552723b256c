"""Image transformers (the reference's OpenCV-backed 2-D set).

Counterpart of ``analytics_zoo_tpu/feature/image/transforms.py``, and a
copy of it: images are HWC float32 numpy arrays, BGR as OpenCV keeps
them, transformed on the host.  The random transforms draw from
``np.random.default_rng(seed)`` per transform, so the two packages give
the same crops, flips and jitters from the same seeds.

``ImageBytesToMat`` decodes through the port's own native library
(``analytics_zoo_tpu_torch/native``), else PIL, and records
``original_size``.  ``ImageResize`` has two branches: PIL's bilinear
filter for a 3-channel image in the uint8 range when PIL is importable,
``scipy.ndimage.zoom(order=1)`` otherwise (float images, and hosts
without PIL).  :func:`resize_branch` names the branch an image takes.
"""

from __future__ import annotations

import io

import numpy as np

from ..common import Preprocessing, register_preprocessing

try:  # PIL for decode/resize; the native library is the fast path
    from PIL import Image as _PILImage
    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


class ImageFeature(dict):
    """Mutable per-image record (reference ImageFeature): holds the pixel
    array under 'image' plus metadata (uri, label, original size...)."""

    @property
    def image(self) -> np.ndarray:
        return self["image"]

    @image.setter
    def image(self, v):
        self["image"] = v


def _as_feature(sample) -> ImageFeature:
    if isinstance(sample, ImageFeature):
        return sample
    f = ImageFeature()
    if isinstance(sample, dict):
        # a plain {'image': pixels, ...} record is a feature, not pixels
        if "image" not in sample:
            raise ValueError(
                "dict sample for an image transform needs an 'image' key")
        f.update(sample)
    else:
        f["image"] = sample
    return f


class ImageProcessing(Preprocessing):
    """Base for image transforms: normalizes input to ImageFeature."""

    def apply(self, sample):
        f = _as_feature(sample)
        f["image"] = self.transform(np.asarray(f["image"]))
        return f

    def transform(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError


@register_preprocessing
class ImageBytesToMat(ImageProcessing):
    """Decode compressed bytes -> HWC float32 BGR array
    (reference ImageBytesToMat.scala / OpenCVMethod.imdecode)."""

    def apply(self, sample):
        f = _as_feature(sample)
        raw = f["image"]
        if isinstance(raw, (bytes, bytearray)):
            arr = None
            from ... import native
            if native.available():
                try:  # C++ decode (libjpeg/libpng) — the fast path
                    rgb = native.decode_image(bytes(raw))
                    arr = rgb[:, :, ::-1].astype(np.float32)  # RGB->BGR
                except ValueError:
                    arr = None  # exotic format: PIL fallback below
            if arr is None:
                if not _HAS_PIL:
                    raise RuntimeError(
                        "no decoder available (native build failed and "
                        "PIL missing)")
                img = _PILImage.open(io.BytesIO(raw)).convert("RGB")
                arr = np.asarray(img, dtype=np.float32)[:, :, ::-1]
            f["original_size"] = arr.shape
            f["image"] = arr
        return f


def resize_branch(img: np.ndarray) -> str:
    """``"pil"`` when :class:`ImageResize` takes PIL's bilinear filter for
    ``img`` (PIL importable, 3 channels, values in [0, 255]), else
    ``"scipy"`` (``ndimage.zoom(order=1)``, which keeps floats)."""
    in_uint8_range = img.min() >= 0 and img.max() <= 255
    if _HAS_PIL and in_uint8_range and img.ndim == 3 and img.shape[2] == 3:
        return "pil"
    return "scipy"


@register_preprocessing
class ImageResize(ImageProcessing):
    """reference ImageResize.scala."""

    def __init__(self, resize_h: int, resize_w: int):
        self.resize_h, self.resize_w = int(resize_h), int(resize_w)

    def transform(self, img):
        if resize_branch(img) == "pil":
            pil = _PILImage.fromarray(img.astype(np.uint8))
            out = pil.resize((self.resize_w, self.resize_h),
                             _PILImage.BILINEAR)
            return np.asarray(out, dtype=np.float32)
        # float-preserving path (normalized / medical images): bilinear
        # zoom per channel, no quantization
        from scipy import ndimage
        zoom = (self.resize_h / img.shape[0], self.resize_w / img.shape[1])
        if img.ndim == 3:
            zoom = zoom + (1,)
        return ndimage.zoom(img, zoom, order=1).astype(np.float32)

    def get_config(self):
        return {"resize_h": self.resize_h, "resize_w": self.resize_w}


@register_preprocessing
class BufferedImageResize(ImageResize):
    """reference BufferedImageResize.scala (same host-side resize)."""


@register_preprocessing
class ImageAspectScale(ImageProcessing):
    """Scale the short side to ``scale`` capped by ``max_size``
    (reference ImageAspectScale.scala, used by object detection)."""

    def __init__(self, scale: int, max_size: int = 1000,
                 scale_multiple_of: int = 1):
        self.scale, self.max_size = int(scale), int(max_size)
        self.scale_multiple_of = int(scale_multiple_of)

    def transform(self, img):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        ratio = min(self.scale / short, self.max_size / long)
        nh, nw = int(h * ratio), int(w * ratio)
        if self.scale_multiple_of > 1:
            nh = (nh // self.scale_multiple_of) * self.scale_multiple_of
            nw = (nw // self.scale_multiple_of) * self.scale_multiple_of
        return ImageResize(nh, nw).transform(img)

    def get_config(self):
        return {"scale": self.scale, "max_size": self.max_size,
                "scale_multiple_of": self.scale_multiple_of}


class _CropBase(ImageProcessing):
    def _crop(self, img, y0, x0, h, w):
        return img[y0:y0 + h, x0:x0 + w]


@register_preprocessing
class ImageCenterCrop(_CropBase):
    """reference ImageCenterCrop.scala."""

    def __init__(self, crop_height: int, crop_width: int):
        self.crop_height, self.crop_width = int(crop_height), int(crop_width)

    def transform(self, img):
        y0 = max((img.shape[0] - self.crop_height) // 2, 0)
        x0 = max((img.shape[1] - self.crop_width) // 2, 0)
        return self._crop(img, y0, x0, self.crop_height, self.crop_width)

    def get_config(self):
        return {"crop_height": self.crop_height,
                "crop_width": self.crop_width}


@register_preprocessing
class ImageRandomCrop(_CropBase):
    """reference ImageRandomCrop.scala."""

    def __init__(self, crop_height: int, crop_width: int, seed: int = 0):
        self.crop_height, self.crop_width = int(crop_height), int(crop_width)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, img):
        max_y = max(img.shape[0] - self.crop_height, 0)
        max_x = max(img.shape[1] - self.crop_width, 0)
        y0 = int(self.rng.integers(0, max_y + 1))
        x0 = int(self.rng.integers(0, max_x + 1))
        return self._crop(img, y0, x0, self.crop_height, self.crop_width)

    def get_config(self):
        return {"crop_height": self.crop_height,
                "crop_width": self.crop_width, "seed": self.seed}


@register_preprocessing
class ImageFixedCrop(_CropBase):
    """Crop by explicit bounds, normalized or pixel coords
    (reference ImageFixedCrop.scala)."""

    def __init__(self, x1, y1, x2, y2, normalized: bool = True):
        self.x1, self.y1, self.x2, self.y2 = x1, y1, x2, y2
        self.normalized = normalized

    def transform(self, img):
        h, w = img.shape[:2]
        if self.normalized:
            x1, y1 = int(self.x1 * w), int(self.y1 * h)
            x2, y2 = int(self.x2 * w), int(self.y2 * h)
        else:
            x1, y1, x2, y2 = map(int, (self.x1, self.y1, self.x2, self.y2))
        return img[y1:y2, x1:x2]

    def get_config(self):
        return {"x1": self.x1, "y1": self.y1, "x2": self.x2, "y2": self.y2,
                "normalized": self.normalized}


@register_preprocessing
class ImageChannelNormalize(ImageProcessing):
    """Subtract per-channel means, divide per-channel stds
    (reference ImageChannelNormalize.scala)."""

    def __init__(self, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0):
        # note: stored RGB-wise for API parity, applied to BGR arrays
        self.means = (mean_b, mean_g, mean_r)
        self.stds = (std_b, std_g, std_r)
        self._cfg = dict(mean_r=mean_r, mean_g=mean_g, mean_b=mean_b,
                         std_r=std_r, std_g=std_g, std_b=std_b)

    def transform(self, img):
        return ((img - np.asarray(self.means, dtype=np.float32))
                / np.asarray(self.stds, dtype=np.float32))

    def get_config(self):
        return dict(self._cfg)


@register_preprocessing
class ImagePixelNormalizer(ImageProcessing):
    """Subtract a full per-pixel mean image
    (reference ImagePixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray = None):
        self.means = np.asarray(means, dtype=np.float32)

    def transform(self, img):
        return img - self.means.reshape(img.shape)

    def get_config(self):
        return {"means": self.means.tolist()}


@register_preprocessing
class ImageChannelOrder(ImageProcessing):
    """Swap BGR <-> RGB (reference ImageChannelOrder.scala)."""

    def transform(self, img):
        return img[:, :, ::-1].copy()


@register_preprocessing
class ImageBrightness(ImageProcessing):
    """Add a random brightness delta (reference ImageBrightness.scala)."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 0):
        self.delta_low, self.delta_high = float(delta_low), float(delta_high)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, img):
        delta = self.rng.uniform(self.delta_low, self.delta_high)
        return img + delta

    def get_config(self):
        return {"delta_low": self.delta_low, "delta_high": self.delta_high,
                "seed": self.seed}


def _bgr_to_hsv(img):
    b, g, r = img[..., 0] / 255.0, img[..., 1] / 255.0, img[..., 2] / 255.0
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
    gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
    bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    return h, s, v


def _hsv_to_bgr(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([b, g, r], axis=-1) * 255.0


@register_preprocessing
class ImageHue(ImageProcessing):
    """Random hue rotation in degrees (reference ImageHue.scala)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: int = 0):
        self.delta_low, self.delta_high = float(delta_low), float(delta_high)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, img):
        delta = self.rng.uniform(self.delta_low, self.delta_high)
        h, s, v = _bgr_to_hsv(img)
        h = (h + delta / 360.0) % 1.0
        return _hsv_to_bgr(h, s, v).astype(np.float32)

    def get_config(self):
        return {"delta_low": self.delta_low, "delta_high": self.delta_high,
                "seed": self.seed}


@register_preprocessing
class ImageSaturation(ImageProcessing):
    """Random saturation scale (reference ImageSaturation.scala)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: int = 0):
        self.delta_low, self.delta_high = float(delta_low), float(delta_high)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, img):
        scale = self.rng.uniform(self.delta_low, self.delta_high)
        h, s, v = _bgr_to_hsv(img)
        s = np.clip(s * scale, 0.0, 1.0)
        return _hsv_to_bgr(h, s, v).astype(np.float32)

    def get_config(self):
        return {"delta_low": self.delta_low, "delta_high": self.delta_high,
                "seed": self.seed}


@register_preprocessing
class ImageContrast(ImageProcessing):
    """Random contrast scale (reference ImageContrast.scala)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: int = 0):
        self.delta_low, self.delta_high = float(delta_low), float(delta_high)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, img):
        scale = self.rng.uniform(self.delta_low, self.delta_high)
        return img * scale

    def get_config(self):
        return {"delta_low": self.delta_low, "delta_high": self.delta_high,
                "seed": self.seed}


@register_preprocessing
class ImageColorJitter(ImageProcessing):
    """Randomly-ordered brightness/contrast/saturation/hue jitter
    (reference ImageColorJitter.scala)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.stages = [ImageBrightness(-32, 32, seed),
                       ImageContrast(0.5, 1.5, seed),
                       ImageSaturation(0.5, 1.5, seed),
                       ImageHue(-18, 18, seed)]

    def transform(self, img):
        order = self.rng.permutation(len(self.stages))
        for i in order:
            img = self.stages[i].transform(img)
        return np.clip(img, 0, 255)

    def get_config(self):
        return {"seed": self.seed}


@register_preprocessing
class ImageExpand(ImageProcessing):
    """Randomly place the image on a larger mean-filled canvas
    (reference ImageExpand.scala)."""

    def __init__(self, means_r=123, means_g=117, means_b=104,
                 max_expand_ratio: float = 4.0, seed: int = 0):
        self.means = (means_b, means_g, means_r)
        self.max_expand_ratio = float(max_expand_ratio)
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self._cfg = dict(means_r=means_r, means_g=means_g, means_b=means_b,
                         max_expand_ratio=max_expand_ratio, seed=seed)

    def transform(self, img):
        ratio = self.rng.uniform(1.0, self.max_expand_ratio)
        h, w = img.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.tile(np.asarray(self.means, dtype=np.float32),
                         (nh, nw, 1))
        y0 = int(self.rng.integers(0, nh - h + 1))
        x0 = int(self.rng.integers(0, nw - w + 1))
        canvas[y0:y0 + h, x0:x0 + w] = img
        return canvas

    def get_config(self):
        return dict(self._cfg)


@register_preprocessing
class ImageFiller(ImageProcessing):
    """Fill a normalized-coord rectangle with a value
    (reference ImageFiller.scala)."""

    def __init__(self, start_x=0.0, start_y=0.0, end_x=1.0, end_y=1.0,
                 value: int = 255):
        self.box = (start_x, start_y, end_x, end_y)
        self.value = value

    def transform(self, img):
        h, w = img.shape[:2]
        x1, y1 = int(self.box[0] * w), int(self.box[1] * h)
        x2, y2 = int(self.box[2] * w), int(self.box[3] * h)
        out = img.copy()
        out[y1:y2, x1:x2] = self.value
        return out

    def get_config(self):
        return {"start_x": self.box[0], "start_y": self.box[1],
                "end_x": self.box[2], "end_y": self.box[3],
                "value": self.value}


@register_preprocessing
class ImageHFlip(ImageProcessing):
    """Horizontal flip, optionally random (reference ImageHFlip.scala)."""

    def __init__(self, probability: float = 1.0, seed: int = 0):
        self.probability = float(probability)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def transform(self, img):
        if self.rng.uniform() <= self.probability:
            return img[:, ::-1].copy()
        return img

    def get_config(self):
        return {"probability": self.probability, "seed": self.seed}


@register_preprocessing
class ImageRandomPreprocessing(Preprocessing):
    """Apply an inner transform with probability p
    (reference ImageRandomPreprocessing.scala)."""

    def __init__(self, preprocessing: Preprocessing, prob: float,
                 seed: int = 0):
        self.preprocessing = preprocessing
        self.prob = float(prob)
        self.rng = np.random.default_rng(seed)

    def apply(self, sample):
        if self.rng.uniform() <= self.prob:
            return self.preprocessing.apply(sample)
        return _as_feature(sample)


@register_preprocessing
class ImageMatToFloats(ImageProcessing):
    """Mat -> float array (identity here: arrays are already floats;
    reference ImageMatToFloats.scala)."""

    def transform(self, img):
        return np.asarray(img, dtype=np.float32)


@register_preprocessing
class ImageMatToTensor(Preprocessing):
    """ImageFeature -> tensor under 'tensor', NHWC or NCHW
    (reference ImageMatToTensor.scala; the reference emits CHW for BigDL,
    the default here is HWC)."""

    def __init__(self, format: str = "NHWC"):  # noqa: A002
        self.format = format

    def apply(self, sample):
        f = _as_feature(sample)
        img = np.asarray(f["image"], dtype=np.float32)
        if self.format.upper() == "NCHW":
            img = np.transpose(img, (2, 0, 1))
        f["tensor"] = img
        return f

    def get_config(self):
        return {"format": self.format}


@register_preprocessing
class ImageSetToSample(Preprocessing):
    """ImageFeature -> (x, y) sample from selected keys
    (reference ImageSetToSample.scala)."""

    def __init__(self, input_keys=("tensor",), target_keys=("label",)):
        self.input_keys = tuple(input_keys)
        self.target_keys = tuple(target_keys)

    def apply(self, sample):
        f = _as_feature(sample)
        xs = [np.asarray(f[k]) for k in self.input_keys if k in f]
        ys = [np.asarray(f[k]) for k in self.target_keys
              if k in f and f[k] is not None]
        x = xs[0] if len(xs) == 1 else tuple(xs)
        y = (ys[0] if len(ys) == 1 else tuple(ys)) if ys else None
        return (x, y)

    def get_config(self):
        return {"input_keys": list(self.input_keys),
                "target_keys": list(self.target_keys)}


@register_preprocessing
class ImageRandomAspectScale(ImageProcessing):
    """Aspect-preserving resize with the target short side chosen
    randomly from ``scales`` per image (reference
    imagePreprocessing.py:199 — detection train-time multi-scale)."""

    def __init__(self, scales, scale_multiple_of: int = 1,
                 max_size: int = 1000, seed: int = None):
        self.scales = [int(s) for s in scales]
        self.scale_multiple_of = int(scale_multiple_of)
        self.max_size = int(max_size)
        self.seed = seed
        self._rng = np.random.RandomState(seed)

    def transform(self, img):
        scale = self.scales[self._rng.randint(len(self.scales))]
        return ImageAspectScale(
            scale, max_size=self.max_size,
            scale_multiple_of=self.scale_multiple_of).transform(img)

    def get_config(self):
        return {"scales": list(self.scales),
                "scale_multiple_of": self.scale_multiple_of,
                "max_size": self.max_size, "seed": self.seed}


# reference-name aliases (imagePreprocessing.py vocabulary)
ImagePreprocessing = ImageProcessing
ImagePixelNormalize = ImagePixelNormalizer
ImageFeatureToTensor = ImageMatToTensor
RowToImageFeature = ImageBytesToMat
