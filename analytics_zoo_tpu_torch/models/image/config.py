"""Preprocessing configuration of the image zoo.

Counterpart of ``analytics_zoo_tpu/models/image/config.py`` (the
reference's ``ImageConfigure``, ``PaddingParam`` and the per-model
registry of ``ImageClassificationConfig.scala`` and
``ObjectDetectionConfig.scala``), and a copy of it:
``ImageConfigure.parse`` for every registry name, a '-quantize' suffix
sharing its base's configure, and the PASCAL, COCO and file label maps.
"""

import dataclasses
from typing import Callable, Dict, Optional

from ...feature.common import Preprocessing
from ...feature.image.transforms import (ImageCenterCrop,
                                         ImageChannelNormalize, ImageResize)


@dataclasses.dataclass
class PaddingParam:
    """Feature padding for variant-sized inputs (reference
    PaddingParam): pad every image of a batch up to the batch max."""

    pad_value: float = 0.0


@dataclasses.dataclass
class ImageConfigure:
    """Bundle of pre/post-processing around a zoo image model
    (reference image_config.py:28-60)."""

    pre_processor: Optional[Preprocessing] = None
    post_processor: Optional[Callable] = None
    batch_per_partition: int = 4
    label_map: Optional[Dict[int, str]] = None
    feature_padding_param: Optional[PaddingParam] = None
    input_size: Optional[int] = None  # spatial size pre_processor emits

    @classmethod
    def parse(cls, model_name: str) -> "ImageConfigure":
        """Default configure for a registry model name
        (ImageConfigure.parse / ImageClassificationConfig.scala:52-77)."""
        from ..common import parse_quantize_name
        base, _ = parse_quantize_name(model_name)
        if base not in _CONFIGURES:
            raise ValueError(
                f"No default configure for {model_name!r}; known: "
                f"{sorted(_CONFIGURES)}")
        return _CONFIGURES[base]()


# imagenet preprocessing constants (the reference's per-model configs)
_IMAGENET_MEAN = (123.68, 116.779, 103.939)
_IMAGENET_STD = (1.0, 1.0, 1.0)


def _imagenet_configure(size: int):
    def build():
        pre = (ImageResize(size + 32, size + 32)
               >> ImageCenterCrop(size, size)
               >> ImageChannelNormalize(*_IMAGENET_MEAN, *_IMAGENET_STD))
        return ImageConfigure(pre_processor=pre, batch_per_partition=4,
                              input_size=size)
    return build


def _inception_v3_configure():
    # inception-v3: 299x299, inputs scaled to [-1, 1]
    pre = (ImageResize(320, 320) >> ImageCenterCrop(299, 299)
           >> ImageChannelNormalize(127.5, 127.5, 127.5,
                                    127.5, 127.5, 127.5))
    return ImageConfigure(pre_processor=pre, batch_per_partition=4,
                          input_size=299)


def _ssd_configure(size: int):
    def build():
        pre = (ImageResize(size, size)
               >> ImageChannelNormalize(*_IMAGENET_MEAN, *_IMAGENET_STD))
        return ImageConfigure(pre_processor=pre, batch_per_partition=2,
                              input_size=size)
    return build


_CONFIGURES = {
    "resnet-50": _imagenet_configure(224),
    "vgg-16": _imagenet_configure(224),
    "vgg-19": _imagenet_configure(224),
    "mobilenet": _imagenet_configure(224),
    "mobilenet-v2": _imagenet_configure(224),
    "squeezenet": _imagenet_configure(224),
    "densenet-161": _imagenet_configure(224),
    "inception-v1": _imagenet_configure(224),
    "inception-v3": _inception_v3_configure,
    "ssd-vgg16-300": _ssd_configure(300),
    "ssd-vgg16-512": _ssd_configure(512),
    "ssd-mobilenet-300": _ssd_configure(300),
}


# ------------------------------------------------------------- label maps

PASCAL_CLASSES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor")

COCO_CLASSES = (
    "__background__", "person", "bicycle", "car", "motorcycle",
    "airplane", "bus", "train", "truck", "boat", "traffic light",
    "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat",
    "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase",
    "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")


def read_pascal_label_map() -> Dict[int, str]:
    """PASCAL VOC label map (reference read_pascal_label_map)."""
    return dict(enumerate(PASCAL_CLASSES))


def read_coco_label_map() -> Dict[int, str]:
    """COCO label map (reference read_coco_label_map)."""
    return dict(enumerate(COCO_CLASSES))


def read_label_map(path: str, start: int = 0) -> Dict[int, str]:
    """Read a label map from a text file: either one label per line
    (index = line number + start) or ``<index><sep><label>`` lines."""
    out: Dict[int, str] = {}
    with open(path) as f:
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            head, _, tail = line.partition("\t") if "\t" in line \
                else line.partition(" ")
            if tail and head.lstrip("-").isdigit():
                out[int(head)] = tail.strip()
            else:
                out[lineno + start] = line
    return out


def read_imagenet_label_map(path: str) -> Dict[int, str]:
    """ImageNet-1k label map from a user-supplied synset/words file (the
    reference bundles this data in its jar; redistribute-free here)."""
    return read_label_map(path)
