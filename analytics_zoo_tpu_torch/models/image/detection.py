"""ObjectDetector: the SSD detection models and their postprocessing.

Counterpart of ``analytics_zoo_tpu/models/image/detection.py``: SSD on
VGG-16 (300 and 512) and on MobileNet (300), built block for block as
the JAX package builds them (the same layer types, names and creation
order, so weights move by name), the prior boxes, and the fixed-shape
postprocessing: softmax, box decoding, per-class top-k, padded NMS and a
(batch, max_detections, 6) output of [label, score, x1, y1, x2, y2]
(normalised corners, padding rows all -1).  Class 0 is background.
``predict_image_set`` runs an ``ImageSet`` through an optional
``ImageConfigure``, the head and the decode on the model's device, and
gives boxes in each image's original pixels.

``decode_output`` gives the JAX package's results, which come from a
loop over classes of ``max_detections`` NMS iterations each, under
``vmap`` over images; here images and classes go together through one
loop of ``max_detections`` iterations over (batch, classes - 1, top_k)
tensors, three launches an iteration and no host sync inside it.  Ties
break as ``lax.top_k``, ``jnp.argmax`` and ``jnp.argsort`` break them:
the lower index first (a stable descending sort stands for top-k).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.graph import Input
from ...pipeline.api.keras.engine import Model
from ...pipeline.api.keras.layers import (
    Activation, BatchNormalization, Convolution2D, MaxPooling2D, Merge,
    Reshape, SeparableConvolution2D, ZeroPadding2D)
from ..common import (QuantizedVariantMixin, ZooModel, parse_quantize_name,
                      register_zoo_model)
from .classification import _conv_bn


# ------------------------------------------------------------ prior boxes

def ssd_priors(image_size: int = 300,
               feature_sizes: Sequence[int] = (38, 19, 10, 5, 3, 1),
               min_ratio: float = 0.2, max_ratio: float = 0.9,
               aspect_ratios: Sequence[Sequence[float]] = (
                   (2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
               ) -> np.ndarray:
    """SSD prior (anchor) boxes (cx, cy, w, h), normalised: per-scale
    sizes interpolated between the ratios, priors {1, 1', ar, 1/ar} per
    cell (the standard SSD-300 recipe)."""
    n_maps = len(feature_sizes)
    scales = np.linspace(min_ratio, max_ratio, n_maps)
    scales = np.concatenate([[0.1], scales])  # conv4_3 uses a small scale
    priors = []
    for m, fsize in enumerate(feature_sizes):
        s_k = scales[m]
        s_k1 = scales[m + 1] if m + 1 < len(scales) else 1.0
        for i, j in itertools.product(range(fsize), repeat=2):
            cx = (j + 0.5) / fsize
            cy = (i + 0.5) / fsize
            priors.append([cx, cy, s_k, s_k])
            s_prime = math.sqrt(s_k * s_k1)
            priors.append([cx, cy, s_prime, s_prime])
            for ar in aspect_ratios[m]:
                r = math.sqrt(ar)
                priors.append([cx, cy, s_k * r, s_k / r])
                priors.append([cx, cy, s_k / r, s_k * r])
    return np.clip(np.asarray(priors, dtype=np.float32), 0.0, 1.0)


def priors_per_cell(aspect_ratios: Sequence[float]) -> int:
    return 2 + 2 * len(aspect_ratios)


# ------------------------------------------------------------ networks

def _vgg_base(x):
    """VGG-16 through conv5_3, the SSD variant's pools, and fc6/fc7 as
    convolutions (fc6 dilated by 6)."""
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    feats = {}
    for bi, (reps, ch) in enumerate(cfg):
        for r in range(reps):
            x = Convolution2D(ch, 3, 3, activation="relu",
                              border_mode="same",
                              name=f"ssd_b{bi + 1}c{r + 1}")(x)
        if bi == 3:
            feats["conv4_3"] = x
        if bi < 4:
            x = MaxPooling2D(pool_size=(2, 2), strides=(2, 2),
                             border_mode="same")(x)
        else:
            x = MaxPooling2D(pool_size=(3, 3), strides=(1, 1),
                             border_mode="same")(x)
    x = Convolution2D(1024, 3, 3, activation="relu", border_mode="same",
                      dilation=(6, 6), name="ssd_fc6")(x)
    x = Convolution2D(1024, 1, 1, activation="relu", name="ssd_fc7")(x)
    feats["fc7"] = x
    return feats


def _extra_layers(x, n_extras: int = 4):
    """SSD's extra feature maps: 19 -> 10 -> 5 -> 3 -> 1 for input 300."""
    outs = []
    specs = [(256, 512, 2), (128, 256, 2), (128, 256, 2),
             (128, 256, 2)][:n_extras]
    for i, (mid, out, stride) in enumerate(specs):
        x = Convolution2D(mid, 1, 1, activation="relu",
                          name=f"ssd_extra{i}_1")(x)
        if stride == 2 and i < 2:
            x = ZeroPadding2D(padding=(1, 1))(x)
            x = Convolution2D(out, 3, 3, subsample=(2, 2),
                              activation="relu",
                              name=f"ssd_extra{i}_2")(x)
        else:
            x = Convolution2D(out, 3, 3,
                              subsample=(stride, stride) if i < 2 else (1, 1),
                              activation="relu", border_mode="valid",
                              name=f"ssd_extra{i}_2")(x)
        outs.append(x)
    return outs


def _multibox(inp, sources, aspect_ratios, num_classes, prefix, name,
              device, seed) -> Model:
    """The per-scale loc and conf heads over ``sources``, each reshaped
    to (h·w·k, 4) and (h·w·k, classes) and joined, then every scale
    concatenated: (batch, n_priors, 4 + num_classes).  The model records
    its feature sizes and aspect ratios for ``model_priors``."""
    head_outs, feature_sizes = [], []
    for i, (src, ars) in enumerate(zip(sources, aspect_ratios)):
        k = priors_per_cell(ars)
        loc = Convolution2D(k * 4, 3, 3, border_mode="same",
                            name=f"{prefix}_loc{i}")(src)
        conf = Convolution2D(k * num_classes, 3, 3, border_mode="same",
                             name=f"{prefix}_conf{i}")(src)
        h, w = src.shape[1], src.shape[2]
        feature_sizes.append(h)
        loc = Reshape((h * w * k, 4))(loc)
        conf = Reshape((h * w * k, num_classes))(conf)
        head_outs.append(Merge(mode="concat", concat_axis=-1)([loc, conf]))
    out = Merge(mode="concat", concat_axis=1)(head_outs)
    model = Model(input=inp, output=out, name=name, device=device, seed=seed)
    model._ssd_feature_sizes = feature_sizes
    model._ssd_aspect_ratios = aspect_ratios
    return model


def ssd_vgg16(num_classes: int = 21, image_size: int = 300, device=None,
              seed: int = 0) -> Model:
    """SSD-VGG16 (the registry's 'ssd-vgg16-300' and 'ssd-vgg16-512'):
    (batch, n_priors, 4 + num_classes), loc deltas then class logits."""
    aspect_ratios = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    inp = Input((image_size, image_size, 3), name="image")
    feats = _vgg_base(inp)
    sources = [feats["conv4_3"], feats["fc7"]] + _extra_layers(feats["fc7"])
    return _multibox(inp, sources, aspect_ratios, num_classes, "ssd",
                     "ssd_vgg16", device, seed)


def ssd_mobilenet(num_classes: int = 21, image_size: int = 300, device=None,
                  seed: int = 0) -> Model:
    """SSD-MobileNet-300 (the registry's 'ssd-mobilenet-300'): a lighter
    base with the same multibox heads over 5 scales (19, 10, 5, 3, 1 at
    input 300)."""
    aspect_ratios = ((2,), (2, 3), (2, 3), (2, 3), (2,))
    inp = Input((image_size, image_size, 3), name="image")
    x = _conv_bn(inp, 32, 3, stride=2)
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)]
    for filters, stride in cfg:
        x = SeparableConvolution2D(filters, 3, 3, border_mode="same",
                                   subsample=(stride, stride))(x)
        x = BatchNormalization()(x)
        x = Activation("relu6")(x)
    src_a = x  # 19x19 for input 300
    for filters, stride in [(512, 1)] * 3:
        x = SeparableConvolution2D(filters, 3, 3, border_mode="same")(x)
        x = BatchNormalization()(x)
        x = Activation("relu6")(x)
    x = SeparableConvolution2D(1024, 3, 3, border_mode="same",
                               subsample=(2, 2))(x)
    x = BatchNormalization()(x)
    x = Activation("relu6")(x)
    src_b = x  # 10x10
    extras = _extra_layers(src_b, n_extras=3)  # 5, 3, 1
    return _multibox(inp, [src_a, src_b] + extras, aspect_ratios,
                     num_classes, "ssdm", "ssd_mobilenet", device, seed)


def model_priors(model: Model, num_classes: int,
                 image_size: int = 300) -> np.ndarray:
    """The priors of a built model's own per-scale head shapes."""
    sizes = model._ssd_feature_sizes
    ars = model._ssd_aspect_ratios
    return ssd_priors(image_size, feature_sizes=sizes,
                      aspect_ratios=ars[:len(sizes)])


# ------------------------------------------------------------ decoding

def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """SSD box decoding: loc deltas on priors (cx, cy, w, h) ->
    normalised corners (x1, y1, x2, y2), clipped to [0, 1]."""
    cxcy = priors[:, :2] + loc[..., :2] * variances[0] * priors[:, 2:]
    wh = priors[:, 2:] * torch.exp(loc[..., 2:] * variances[2])
    x1y1 = cxcy - wh / 2.0
    x2y2 = cxcy + wh / 2.0
    return torch.clamp(torch.cat([x1y1, x2y2], dim=-1), 0.0, 1.0)


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every box of ``a`` (..., N, 4) with every box of ``b``
    (..., M, 4): (..., N, M), each entry by ``_iou``'s arithmetic."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    inter_wh = torch.clamp_min(torch.minimum(a[..., 2:], b[..., 2:])
                               - torch.maximum(a[..., :2], b[..., :2]), 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area1 = (torch.clamp_min(a[..., 2] - a[..., 0], 0)
             * torch.clamp_min(a[..., 3] - a[..., 1], 0))
    area2 = (torch.clamp_min(b[..., 2] - b[..., 0], 0)
             * torch.clamp_min(b[..., 3] - b[..., 1], 0))
    return inter / torch.clamp_min(area1 + area2 - inter, 1e-9)


def _iou(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one box (4,) with each of ``boxes`` (N, 4)."""
    return _pairwise_iou(box[None], boxes)[0]


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape iterative NMS of one set of boxes: ``max_out`` picks
    of the best live score (the lower index on ties), each suppressing
    itself and the boxes overlapping it by more than ``iou_threshold``
    (suppressed scores become -1).  Returns the picks' indices and
    scores; a pick of score -1 is padding."""
    live = scores.clone()
    idx = torch.arange(len(scores), device=scores.device)
    keep_idx, keep_score = [], []
    for _ in range(max_out):
        best = torch.argmax(live)
        keep_idx.append(best)
        keep_score.append(live[best])
        suppress = (_iou(boxes[best], boxes) > iou_threshold) | (idx == best)
        live = torch.where(suppress, -1.0, live)
    return torch.stack(keep_idx), torch.stack(keep_score)


def decode_output(output, priors, num_classes: int,
                  conf_threshold: float = 0.01, nms_threshold: float = 0.45,
                  top_k: int = 200, max_detections: int = 100
                  ) -> torch.Tensor:
    """SSD postprocessing of a raw head output (batch, n_priors,
    4 + num_classes) with ``priors`` (n_priors, 4): for each image and
    foreground class, the ``top_k`` best-scoring boxes (scores below
    ``conf_threshold`` count as -1), ``max_detections`` rounds of NMS,
    then the best ``max_detections`` rows over all classes by score.
    Returns (batch, max_detections, 6) [label, score, x1, y1, x2, y2] on
    the output's device; rows of score <= 0 are all -1.  An output that
    is not a tensor (``ObjectDetector.predict``'s numpy) goes to the
    priors' device first, so the decode runs where the model lives."""
    if not torch.is_tensor(output):
        output = torch.as_tensor(output, device=priors.device
                                 if torch.is_tensor(priors) else None)
    priors = torch.as_tensor(priors, device=output.device)
    b, n_fg, m = output.shape[0], num_classes - 1, max_detections
    probs = torch.softmax(output[..., 4:].float(), dim=-1)
    boxes = decode_boxes(output[..., :4].float(), priors)     # (b, P, 4)
    scores = probs[..., 1:].transpose(1, 2)                   # (b, K, P)
    scores = torch.where(scores >= conf_threshold, scores, -1.0)
    # top-k as lax.top_k orders it: descending, lower index first on ties
    cand_scores, cand_idx = torch.sort(scores, dim=-1, descending=True,
                                       stable=True)
    cand_scores, cand_idx = cand_scores[..., :top_k], cand_idx[..., :top_k]
    t = cand_idx.shape[-1]
    cand_boxes = torch.gather(
        boxes[:, None].expand(b, n_fg, -1, 4), 2,
        cand_idx[..., None].expand(b, n_fg, t, 4))            # (b, K, T, 4)
    # row i: what picking candidate i suppresses (itself included)
    suppress = _pairwise_iou(cand_boxes, cand_boxes) > nms_threshold
    suppress |= torch.eye(t, dtype=torch.bool, device=output.device)
    live = cand_scores.clone()
    keep_idx, keep_score = [], []
    for _ in range(m):
        best_score, best = torch.max(live, dim=-1)  # first index on ties
        keep_idx.append(best)
        keep_score.append(best_score)
        row = torch.gather(suppress, 2,
                           best[..., None, None].expand(b, n_fg, 1, t))
        live.masked_fill_(row[:, :, 0], -1.0)
    keep_idx = torch.stack(keep_idx, dim=-1)                 # (b, K, M)
    keep_score = torch.stack(keep_score, dim=-1)
    keep_boxes = torch.gather(cand_boxes, 2,
                              keep_idx[..., None].expand(b, n_fg, m, 4))
    labels = torch.arange(1, num_classes, dtype=torch.float32,
                          device=output.device)[None, :, None, None]
    rows = torch.cat([labels.expand(b, n_fg, m, 1), keep_score[..., None],
                      keep_boxes], dim=-1)
    rows = torch.where(keep_score[..., None] > 0, rows, -1.0)
    dets = rows.reshape(b, n_fg * m, 6)
    # the best max_detections by score; jnp.argsort is stable
    order = torch.argsort(-dets[..., 1], dim=-1, stable=True)[:, :m]
    return torch.gather(dets, 1, order[..., None].expand(b, m, 6))


class ScaleDetection:
    """Scale normalised detections to each image's pixels (the
    reference's ScaleDetection)."""

    def __call__(self, detections, heights: Sequence[int],
                 widths: Sequence[int]) -> np.ndarray:
        dets = np.array(detections, copy=True)
        for i, (h, w) in enumerate(zip(heights, widths)):
            valid = dets[i, :, 0] >= 0
            dets[i, valid, 2] *= w
            dets[i, valid, 4] *= w
            dets[i, valid, 3] *= h
            dets[i, valid, 5] *= h
        return dets


# ------------------------------------------------------------ ObjectDetector

_DETECTORS = {
    "ssd-vgg16-300": (ssd_vgg16, 300),
    "ssd-vgg16-300x300": (ssd_vgg16, 300),
    "ssd-mobilenet-300": (ssd_mobilenet, 300),
    "ssd-vgg16-512": (ssd_vgg16, 512),
}


@register_zoo_model
class ObjectDetector(QuantizedVariantMixin, ZooModel):
    """A named SSD detector of the registry ('ssd-vgg16-300',
    'ssd-vgg16-300x300', 'ssd-mobilenet-300', 'ssd-vgg16-512'; a
    '-quantize' suffix names the int8 variant), built on ``device``
    (``"cuda"`` unless asked otherwise) from ``seed``.  ``predict``
    gives the raw head; ``decode_output`` with ``priors`` (on the
    model's device) and the thresholds in ``hyper`` gives the
    detections."""

    def __init__(self, model_name="ssd-vgg16-300", num_classes=21,
                 conf_threshold=0.01, nms_threshold=0.45,
                 max_detections=100, name=None, device=None, seed: int = 0,
                 **kw):
        base, _ = parse_quantize_name(model_name)
        if base not in _DETECTORS:
            raise ValueError(
                f"Unknown detector {model_name!r}; known: "
                f"{sorted(_DETECTORS)} (+ '-quantize' suffixes; frcnn "
                "variants are out of scope)")
        super().__init__(name=name, model_name=model_name,
                         num_classes=num_classes,
                         conf_threshold=conf_threshold,
                         nms_threshold=nms_threshold,
                         max_detections=max_detections, **kw)
        self.build_graph(device, seed)
        self.priors = torch.from_numpy(model_priors(
            self.model, num_classes, self.image_size)).to(self.device)

    @property
    def image_size(self) -> int:
        return _DETECTORS[parse_quantize_name(self.hyper["model_name"])[0]][1]

    def build_model(self, device, seed: int) -> Model:
        arch, size = _DETECTORS[parse_quantize_name(
            self.hyper["model_name"])[0]]
        return arch(self.hyper["num_classes"], size, device=device,
                    seed=seed)

    def predict_image_set(self, image_set, batch_size: int = 8,
                          configure=None):
        """Preprocess (with ``configure``'s pre_processor, e.g.
        ``ImageConfigure.parse("ssd-vgg16-300")``, on a copy of the
        images), predict, decode on the model's device and attach the
        detections scaled back to each image's original size (the
        reference's ``predictImageSet`` and ``ScaleDetection``)."""
        h = self.hyper
        heights = [f["image"].shape[0] for f in image_set.features]
        widths = [f["image"].shape[1] for f in image_set.features]
        work = image_set
        if configure is not None and configure.pre_processor is not None:
            # a copy: the original pixels survive for Visualizer to draw on
            work = image_set.copy().transform(configure.pre_processor)
        raw = self.predict(work.to_array(), batch_size=batch_size)
        dets = decode_output(raw, self.priors, h["num_classes"],
                             h["conf_threshold"], h["nms_threshold"],
                             max_detections=h["max_detections"])
        image_set.set_predictions(
            ScaleDetection()(dets.cpu().numpy(), heights, widths))
        return image_set


def visualize(image: np.ndarray, detections: np.ndarray,
              label_map: Optional[Dict[int, str]] = None,
              threshold: float = 0.3) -> np.ndarray:
    """Draw the detection boxes of at least ``threshold`` on a copy of
    ``image`` with PIL (imported here: only this function needs it)."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for det in detections:
        label, score = int(det[0]), float(det[1])
        if label < 0 or score < threshold:
            continue
        x1, y1, x2, y2 = det[2], det[3], det[4], det[5]
        draw.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=2)
        text = (label_map.get(label, str(label)) if label_map
                else str(label))
        draw.text((x1 + 2, y1 + 2), f"{text}:{score:.2f}",
                  fill=(255, 0, 0))
    return np.asarray(img)


class Visualizer:
    """A box drawer with its label map and threshold: ``visualize`` on
    every (image, detections) pair."""

    def __init__(self, label_map: Optional[Dict[int, str]] = None,
                 threshold: float = 0.3):
        self.label_map = label_map
        self.threshold = threshold

    def __call__(self, image: np.ndarray,
                 detections: np.ndarray) -> np.ndarray:
        return visualize(image, detections, label_map=self.label_map,
                         threshold=self.threshold)

    def visualize_image_set(self, image_set):
        """Annotated copies of every image of a predicted set."""
        return [self(f["image"], f["predict"]) for f in image_set.features]
