"""ImageClassifier: the registry of image architectures.

Counterpart of ``analytics_zoo_tpu/models/image/classification.py``:
ResNet-50 (with the space-to-depth stem as an option), VGG-16/19,
MobileNet v1/v2, SqueezeNet, Inception-v1/v3 and DenseNet-161, each a
graph ``Model`` of the port's layers built block for block as the JAX
package builds it (the same layer types, names, creation order and
parameter shapes), so weights and BatchNormalization state move between
the packages by name (``models/jax_params.py``).  Inputs are NHWC.  The
architecture functions take the model's ``device`` (``"cuda"`` unless
asked otherwise) and ``seed``.  ``predict_image_set`` takes an
``ImageSet`` of raw images through the registry's ``ImageConfigure``;
a '-quantize' name predicts through the int8 net
(``models/common.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core.graph import Input
from ...pipeline.api.keras.engine import Model
from ...pipeline.api.keras.layers import (
    Activation, AveragePooling2D, BatchNormalization, Convolution2D, Dense,
    Dropout, Flatten, GlobalAveragePooling2D, MaxPooling2D, Merge,
    SeparableConvolution2D, SpaceToDepth2D, ZeroPadding2D)
from ..common import (QuantizedVariantMixin, ZooModel, parse_quantize_name,
                      register_zoo_model)


def _conv_bn(x, filters, kernel, stride=1, padding="same", activation="relu",
             name=None, bias=False):
    x = Convolution2D(filters, kernel, kernel, subsample=(stride, stride),
                      border_mode=padding, bias=bias, name=name)(x)
    x = BatchNormalization(name=None if name is None else name + "_bn")(x)
    if activation:
        x = Activation(activation)(x)
    return x


# ---------------------------------------------------------------- ResNet-50

def _bottleneck(x, filters, stride=1, downsample=False, prefix=""):
    shortcut = x
    if downsample:
        shortcut = _conv_bn(x, filters * 4, 1, stride=stride,
                            activation=None, name=f"{prefix}_proj")
    y = _conv_bn(x, filters, 1, stride=stride, name=f"{prefix}_1")
    y = _conv_bn(y, filters, 3, name=f"{prefix}_2")
    y = _conv_bn(y, filters * 4, 1, activation=None, name=f"{prefix}_3")
    out = Merge(mode="sum")([y, shortcut])
    return Activation("relu")(out)


def resnet50(input_shape=(224, 224, 3), num_classes=1000,
             space_to_depth=False, device=None, seed: int = 0) -> Model:
    """ResNet-50 v1 (the registry's 'resnet-50').

    ``space_to_depth=True`` replaces the 7x7/s2 stem on 3 channels by
    SpaceToDepth2D(2) and a 4x4/s1 convolution on 12 channels (padded
    (2, 1) on each axis); with the stem kernel that
    :func:`space_to_depth_stem_kernel` makes from the standard one, the
    two compute the same function.  Everything after the stem is the
    same."""
    inp = Input(input_shape, name="image")
    if space_to_depth:
        x = SpaceToDepth2D(block_size=2)(inp)
        x = ZeroPadding2D(padding=(2, 1, 2, 1))(x)
        x = _conv_bn(x, 64, 4, padding="valid", name="conv1")
    else:
        x = ZeroPadding2D(padding=(3, 3))(inp)
        x = _conv_bn(x, 64, 7, stride=2, padding="valid", name="conv1")
    x = ZeroPadding2D(padding=(1, 1))(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    for s, (filters, blocks, stride) in enumerate(stages):
        x = _bottleneck(x, filters, stride=stride, downsample=True,
                        prefix=f"res{s}b0")
        for b in range(1, blocks):
            x = _bottleneck(x, filters, prefix=f"res{s}b{b}")
    x = GlobalAveragePooling2D()(x)
    x = Dense(num_classes, activation="softmax", name="fc1000")(x)
    return Model(input=inp, output=x, name="resnet50", device=device,
                 seed=seed)


def space_to_depth_stem_kernel(w, block_size=2):
    """The packed stem kernel for ``resnet50(space_to_depth=True)`` from a
    standard stem kernel ``w`` (kh, kw, C, O, HWIO; a numpy array or a
    tensor, returned as the same kind): zero-padded at the top left to a
    multiple of the block, each block's taps folded into the packed
    channels in SpaceToDepth2D's (r*b + s)*C + c order."""
    t = w if isinstance(w, torch.Tensor) else torch.as_tensor(np.asarray(w))
    kh, kw, c, o = t.shape
    b = block_size
    ph, pw = (-kh) % b, (-kw) % b
    t = F.pad(t, [0, 0, 0, 0, pw, 0, ph, 0])
    t = t.reshape((kh + ph) // b, b, (kw + pw) // b, b, c, o)
    t = t.permute(0, 2, 1, 3, 4, 5).reshape(
        (kh + ph) // b, (kw + pw) // b, b * b * c, o)
    return t if isinstance(w, torch.Tensor) else t.numpy()


# ---------------------------------------------------------------- VGG

def _vgg(cfg: List, input_shape, num_classes, device, seed) -> Model:
    inp = Input(input_shape, name="image")
    x = inp
    for i, block in enumerate(cfg):
        for j in range(block[0]):
            x = Convolution2D(block[1], 3, 3, activation="relu",
                              border_mode="same",
                              name=f"block{i + 1}_conv{j + 1}")(x)
        x = MaxPooling2D()(x)
    x = Flatten()(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    x = Dense(num_classes, activation="softmax")(x)
    return Model(input=inp, output=x, name="vgg", device=device, seed=seed)


def vgg16(input_shape=(224, 224, 3), num_classes=1000, device=None,
          seed: int = 0):
    return _vgg([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)],
                input_shape, num_classes, device, seed)


def vgg19(input_shape=(224, 224, 3), num_classes=1000, device=None,
          seed: int = 0):
    return _vgg([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)],
                input_shape, num_classes, device, seed)


# ---------------------------------------------------------------- MobileNet

def mobilenet(input_shape=(224, 224, 3), num_classes=1000, alpha=1.0,
              device=None, seed: int = 0):
    inp = Input(input_shape, name="image")
    x = _conv_bn(inp, int(32 * alpha), 3, stride=2)
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for filters, stride in cfg:
        x = SeparableConvolution2D(int(filters * alpha), 3, 3,
                                   border_mode="same",
                                   subsample=(stride, stride))(x)
        x = BatchNormalization()(x)
        x = Activation("relu6")(x)
    x = GlobalAveragePooling2D()(x)
    x = Dense(num_classes, activation="softmax")(x)
    return Model(input=inp, output=x, name="mobilenet", device=device,
                 seed=seed)


def _inverted_residual(x, in_ch, filters, stride, expansion, prefix):
    hidden = in_ch * expansion
    y = _conv_bn(x, hidden, 1, activation="relu6",
                 name=f"{prefix}_expand") if expansion != 1 else x
    y = SeparableConvolution2D(filters, 3, 3, border_mode="same",
                               subsample=(stride, stride),
                               depth_multiplier=1,
                               name=f"{prefix}_dw")(y)
    y = BatchNormalization()(y)
    # no activation after the linear bottleneck projection (v2 design)
    if stride == 1 and in_ch == filters:
        return Merge(mode="sum")([x, y])
    return y


def mobilenet_v2(input_shape=(224, 224, 3), num_classes=1000, device=None,
                 seed: int = 0):
    inp = Input(input_shape, name="image")
    x = _conv_bn(inp, 32, 3, stride=2, activation="relu6")
    in_ch = 32
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for bi, (t, c, n, s) in enumerate(cfg):
        for i in range(n):
            x = _inverted_residual(x, in_ch, c, s if i == 0 else 1, t,
                                   prefix=f"ir{bi}_{i}")
            in_ch = c
    x = _conv_bn(x, 1280, 1, activation="relu6")
    x = GlobalAveragePooling2D()(x)
    x = Dense(num_classes, activation="softmax")(x)
    return Model(input=inp, output=x, name="mobilenet_v2", device=device,
                 seed=seed)


# ---------------------------------------------------------------- SqueezeNet

def _fire(x, squeeze, expand, prefix):
    s = Convolution2D(squeeze, 1, 1, activation="relu",
                      name=f"{prefix}_s1")(x)
    e1 = Convolution2D(expand, 1, 1, activation="relu",
                       name=f"{prefix}_e1")(s)
    e3 = Convolution2D(expand, 3, 3, activation="relu", border_mode="same",
                       name=f"{prefix}_e3")(s)
    return Merge(mode="concat", concat_axis=-1)([e1, e3])


def squeezenet(input_shape=(224, 224, 3), num_classes=1000, device=None,
               seed: int = 0):
    inp = Input(input_shape, name="image")
    x = Convolution2D(64, 3, 3, subsample=(2, 2), activation="relu")(inp)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = _fire(x, 16, 64, "fire2")
    x = _fire(x, 16, 64, "fire3")
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = _fire(x, 32, 128, "fire4")
    x = _fire(x, 32, 128, "fire5")
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = _fire(x, 48, 192, "fire6")
    x = _fire(x, 48, 192, "fire7")
    x = _fire(x, 64, 256, "fire8")
    x = _fire(x, 64, 256, "fire9")
    x = Dropout(0.5)(x)
    x = Convolution2D(num_classes, 1, 1, activation="relu")(x)
    x = GlobalAveragePooling2D()(x)
    x = Activation("softmax")(x)
    return Model(input=inp, output=x, name="squeezenet", device=device,
                 seed=seed)


# ---------------------------------------------------------------- Inception

def _inception_block(x, b1, b3r, b3, b5r, b5, pp, prefix):
    branch1 = Convolution2D(b1, 1, 1, activation="relu",
                            name=f"{prefix}_1x1")(x)
    branch3 = Convolution2D(b3r, 1, 1, activation="relu",
                            name=f"{prefix}_3x3r")(x)
    branch3 = Convolution2D(b3, 3, 3, activation="relu", border_mode="same",
                            name=f"{prefix}_3x3")(branch3)
    branch5 = Convolution2D(b5r, 1, 1, activation="relu",
                            name=f"{prefix}_5x5r")(x)
    branch5 = Convolution2D(b5, 5, 5, activation="relu", border_mode="same",
                            name=f"{prefix}_5x5")(branch5)
    pool = MaxPooling2D(pool_size=(3, 3), strides=(1, 1),
                        border_mode="same")(x)
    pool = Convolution2D(pp, 1, 1, activation="relu",
                         name=f"{prefix}_pool")(pool)
    return Merge(mode="concat", concat_axis=-1)(
        [branch1, branch3, branch5, pool])


def inception_v1(input_shape=(224, 224, 3), num_classes=1000, device=None,
                 seed: int = 0):
    """GoogLeNet (the registry's 'inception-v1')."""
    inp = Input(input_shape, name="image")
    x = Convolution2D(64, 7, 7, subsample=(2, 2), activation="relu",
                      border_mode="same")(inp)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = Convolution2D(64, 1, 1, activation="relu")(x)
    x = Convolution2D(192, 3, 3, activation="relu", border_mode="same")(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = _inception_block(x, 64, 96, 128, 16, 32, 32, "i3a")
    x = _inception_block(x, 128, 128, 192, 32, 96, 64, "i3b")
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = _inception_block(x, 192, 96, 208, 16, 48, 64, "i4a")
    x = _inception_block(x, 160, 112, 224, 24, 64, 64, "i4b")
    x = _inception_block(x, 128, 128, 256, 24, 64, 64, "i4c")
    x = _inception_block(x, 112, 144, 288, 32, 64, 64, "i4d")
    x = _inception_block(x, 256, 160, 320, 32, 128, 128, "i4e")
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = _inception_block(x, 256, 160, 320, 32, 128, 128, "i5a")
    x = _inception_block(x, 384, 192, 384, 48, 128, 128, "i5b")
    x = GlobalAveragePooling2D()(x)
    x = Dropout(0.4)(x)
    x = Dense(num_classes, activation="softmax")(x)
    return Model(input=inp, output=x, name="inception_v1", device=device,
                 seed=seed)


def _conv_bn_v3(x, filters, nr, nc, strides=(1, 1), padding="same",
                name=None):
    """The conv2d_bn unit of keras.applications' inception_v3: a
    convolution without bias, BatchNormalization, relu."""
    x = Convolution2D(filters, nr, nc, subsample=strides,
                      border_mode=padding, bias=False, name=name)(x)
    x = BatchNormalization()(x)
    return Activation("relu")(x)


def inception_v3(input_shape=(299, 299, 3), num_classes=1000,
                 include_top=True, device=None, seed: int = 0):
    """Inception-v3 (the registry's 'inception-v3').  With
    ``include_top=False`` the output is the 2048-d global-average-pooled
    feature."""
    cb = _conv_bn_v3
    inp = Input(input_shape, name="image")
    x = cb(inp, 32, 3, 3, strides=(2, 2), padding="valid")
    x = cb(x, 32, 3, 3, padding="valid")
    x = cb(x, 64, 3, 3)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = cb(x, 80, 1, 1, padding="valid")
    x = cb(x, 192, 3, 3, padding="valid")
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)

    def cat(parts):
        return Merge(mode="concat", concat_axis=-1)(parts)

    # mixed 0-2
    for pool_ch in (32, 64, 64):
        b1 = cb(x, 64, 1, 1)
        b5 = cb(cb(x, 48, 1, 1), 64, 5, 5)
        b3 = cb(cb(cb(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        bp = AveragePooling2D(pool_size=(3, 3), strides=(1, 1),
                              border_mode="same")(x)
        bp = cb(bp, pool_ch, 1, 1)
        x = cat([b1, b5, b3, bp])
    # mixed 3
    b3 = cb(x, 384, 3, 3, strides=(2, 2), padding="valid")
    bd = cb(cb(x, 64, 1, 1), 96, 3, 3)
    bd = cb(bd, 96, 3, 3, strides=(2, 2), padding="valid")
    bp = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = cat([b3, bd, bp])
    # mixed 4-7
    for mid in (128, 160, 160, 192):
        b1 = cb(x, 192, 1, 1)
        b7 = cb(cb(cb(x, mid, 1, 1), mid, 1, 7), 192, 7, 1)
        bd = cb(x, mid, 1, 1)
        bd = cb(cb(bd, mid, 7, 1), mid, 1, 7)
        bd = cb(cb(bd, mid, 7, 1), 192, 1, 7)
        bp = AveragePooling2D(pool_size=(3, 3), strides=(1, 1),
                              border_mode="same")(x)
        bp = cb(bp, 192, 1, 1)
        x = cat([b1, b7, bd, bp])
    # mixed 8
    b3 = cb(cb(x, 192, 1, 1), 320, 3, 3, strides=(2, 2), padding="valid")
    b7 = cb(cb(cb(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
    b7 = cb(b7, 192, 3, 3, strides=(2, 2), padding="valid")
    bp = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = cat([b3, b7, bp])
    # mixed 9-10
    for _ in range(2):
        b1 = cb(x, 320, 1, 1)
        b3 = cb(x, 384, 1, 1)
        b3 = cat([cb(b3, 384, 1, 3), cb(b3, 384, 3, 1)])
        bd = cb(cb(x, 448, 1, 1), 384, 3, 3)
        bd = cat([cb(bd, 384, 1, 3), cb(bd, 384, 3, 1)])
        bp = AveragePooling2D(pool_size=(3, 3), strides=(1, 1),
                              border_mode="same")(x)
        bp = cb(bp, 192, 1, 1)
        x = cat([b1, b3, bd, bp])
    x = GlobalAveragePooling2D()(x)
    if include_top:
        x = Dense(num_classes, activation="softmax",
                  name="predictions")(x)
    return Model(input=inp, output=x, name="inception_v3", device=device,
                 seed=seed)


# ---------------------------------------------------------------- DenseNet

def _dense_block(x, layers, growth, prefix):
    for i in range(layers):
        y = BatchNormalization()(x)
        y = Activation("relu")(y)
        y = Convolution2D(4 * growth, 1, 1, bias=False)(y)
        y = BatchNormalization()(y)
        y = Activation("relu")(y)
        y = Convolution2D(growth, 3, 3, border_mode="same", bias=False,
                          name=f"{prefix}_l{i}")(y)
        x = Merge(mode="concat", concat_axis=-1)([x, y])
    return x


def _transition(x, out_ch):
    x = BatchNormalization()(x)
    x = Activation("relu")(x)
    x = Convolution2D(out_ch, 1, 1, bias=False)(x)
    return AveragePooling2D(pool_size=(2, 2))(x)


def densenet161(input_shape=(224, 224, 3), num_classes=1000, device=None,
                seed: int = 0):
    growth, init_ch = 48, 96
    inp = Input(input_shape, name="image")
    x = ZeroPadding2D(padding=(3, 3))(inp)
    x = Convolution2D(init_ch, 7, 7, subsample=(2, 2), bias=False)(x)
    x = BatchNormalization()(x)
    x = Activation("relu")(x)
    x = ZeroPadding2D(padding=(1, 1))(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    ch = init_ch
    for bi, layers in enumerate([6, 12, 36, 24]):
        x = _dense_block(x, layers, growth, f"db{bi}")
        ch += layers * growth
        if bi < 3:
            ch //= 2
            x = _transition(x, ch)
    x = BatchNormalization()(x)
    x = Activation("relu")(x)
    x = GlobalAveragePooling2D()(x)
    x = Dense(num_classes, activation="softmax")(x)
    return Model(input=inp, output=x, name="densenet161", device=device,
                 seed=seed)


# ---------------------------------------------------------------- registry

_ARCHITECTURES: Dict[str, Callable] = {
    "resnet-50": resnet50,
    "vgg-16": vgg16,
    "vgg-19": vgg19,
    "mobilenet": mobilenet,
    "mobilenet-v2": mobilenet_v2,
    "squeezenet": squeezenet,
    "inception-v1": inception_v1,
    "inception-v3": inception_v3,
    "densenet-161": densenet161,
}


@register_zoo_model
class ImageClassifier(QuantizedVariantMixin, ZooModel):
    """A named architecture of the registry (``'resnet-50'``, ...;
    ``'<arch>-quantize'`` names its int8 variant), built at
    ``input_shape`` (NHWC, per sample) with ``num_classes`` softmax
    outputs on ``device`` (``"cuda"`` unless asked otherwise) from
    ``seed``."""

    def __init__(self, model_name="resnet-50", input_shape=(224, 224, 3),
                 num_classes=1000, name=None, device=None, seed: int = 0,
                 **kw):
        base, _ = parse_quantize_name(model_name)
        if base not in _ARCHITECTURES:
            raise ValueError(
                f"Unknown model {model_name!r}; known: "
                f"{sorted(_ARCHITECTURES)} (+ '-quantize' suffixes)")
        super().__init__(name=name, model_name=model_name,
                         input_shape=tuple(input_shape),
                         num_classes=num_classes, **kw)
        self.build_graph(device, seed)

    def build_model(self, device, seed: int) -> Model:
        h = self.hyper
        base, _ = parse_quantize_name(h["model_name"])
        return _ARCHITECTURES[base](
            input_shape=h["input_shape"], num_classes=h["num_classes"],
            device=device, seed=seed)

    def predict_image_set(self, image_set, configure=None):
        """Preprocess, predict, postprocess and attach the results to
        ``image_set`` (the reference's ``predictImageSet``).
        ``configure`` defaults to the model name's registry entry
        (``ImageConfigure.parse``), preprocessing a copy of the images.

        .. warning:: When ``configure`` is omitted, images whose shape
           already equals the model's input are taken as model-ready and
           skip the registry preprocessing: a raw image that happens to
           be exactly ``input_shape`` would go in un-normalized.  Pass
           ``configure=ImageConfigure.parse(model_name)`` to force the
           canonical pipeline whatever the shape.  A model built at
           another input size than the registry's skips the registry
           preprocessing too (it would emit the wrong shape).
        """
        from .config import ImageConfigure
        model_shape = tuple(self.hyper["input_shape"])
        if configure is None:
            shapes = {tuple(f["image"].shape) for f in image_set.features}
            if shapes == {model_shape}:
                configure = ImageConfigure()
            else:
                try:
                    configure = ImageConfigure.parse(
                        self.hyper["model_name"])
                except ValueError:
                    configure = ImageConfigure()
                if configure.input_size is not None and (
                        model_shape[0] != configure.input_size
                        or model_shape[1] != configure.input_size):
                    configure = ImageConfigure(
                        label_map=configure.label_map,
                        batch_per_partition=configure.batch_per_partition)
        work = image_set
        if configure.pre_processor is not None:
            # a copy: the caller's raw images survive
            work = image_set.copy().transform(configure.pre_processor)
        probs = self.predict(
            work.to_array(),
            batch_size=max(configure.batch_per_partition, 1) * 8)
        if configure.post_processor is not None:
            probs = configure.post_processor(probs)
        elif configure.label_map:
            probs = label_output(
                probs, [configure.label_map.get(i, str(i))
                        for i in range(int(np.shape(probs)[-1]))])
        image_set.set_predictions(probs)
        return image_set


def label_output(probs, labels: Optional[List[str]] = None, top_k: int = 5):
    """The top ``top_k`` (label, confidence) pairs of each row of
    ``probs``; the label is the class index when ``labels`` is None."""
    probs = np.asarray(probs)
    idx = np.argsort(-probs, axis=-1)[:, :top_k]
    return [[(labels[i] if labels else int(i), float(row[i])) for i in ids]
            for row, ids in zip(probs, idx)]
