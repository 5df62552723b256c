"""``ImageConfigure`` and ``predict_image_set`` on the port, against the
JAX package's, on the CPU.

Counterparts of ``tests/test_image_configure.py`` (the registry, label
maps, and ``predict_image_set``'s rules: the shape shortcut for
model-ready images, the guard for a model at a non-registry input size,
the raw images left untouched, a label map smaller than the classes).
Beyond them, with the JAX model's weights moved by ``from_jax_params``:
a squeezenet classifier at 32x32 through a configure of resize, center
crop, normalize and a label map, on raw images of 40-64 px, gives the
JAX package's top-5 labels and confidences within 1e-5; an
ssd-mobilenet-300 detector through ``ImageConfigure.parse`` on raw
images of 40-64 px gives the JAX package's detections in original
pixels within 1e-5 of the largest coordinate, labels equal.
"""

import numpy as np
import pytest
import jax

from analytics_zoo_tpu.feature.image import imageset as jimageset
from analytics_zoo_tpu.feature.image import transforms as jtf
from analytics_zoo_tpu.models import ImageClassifier as JImageClassifier
from analytics_zoo_tpu.models import ImageConfigure as JImageConfigure
from analytics_zoo_tpu.models import ObjectDetector as JObjectDetector
from analytics_zoo_tpu_torch.feature.image import transforms as tf2
from analytics_zoo_tpu_torch.feature.image.imageset import ImageSet
from analytics_zoo_tpu_torch.models import (ImageClassifier, ImageConfigure,
                                            ObjectDetector, from_jax_params,
                                            read_coco_label_map,
                                            read_label_map,
                                            read_pascal_label_map)
from analytics_zoo_tpu_torch.models.image import config

TOL = 1e-5


def _raw_images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (40 + 8 * i, 64 - 6 * i, 3)).astype(
        np.float32) for i in range(n)]


def test_torch_parse_registry():
    cfg = ImageConfigure.parse("resnet-50")
    assert cfg.pre_processor is not None and cfg.input_size == 224
    assert ImageConfigure.parse("inception-v3").input_size == 299
    assert ImageConfigure.parse("ssd-vgg16-300").input_size == 300
    assert ImageConfigure.parse("ssd-vgg16-512").input_size == 512
    assert ImageConfigure.parse("resnet-50-quantize").input_size == 224
    assert ImageConfigure.parse("ssd-mobilenet-300-quantize"
                                ).batch_per_partition == 2
    assert sorted(config._CONFIGURES) == sorted(
        __import__("analytics_zoo_tpu.models.image.config",
                   fromlist=["_CONFIGURES"])._CONFIGURES)
    with pytest.raises(ValueError, match="No default configure"):
        ImageConfigure.parse("nope")


@pytest.mark.parametrize("name", ["resnet-50", "inception-v3",
                                  "ssd-vgg16-300"])
def test_torch_parse_preprocessor_equals_jax(name):
    img = np.random.RandomState(0).randint(0, 255, (480, 640, 3)).astype(
        np.float32)
    out = ImageConfigure.parse(name).pre_processor({"image": img})
    want = JImageConfigure.parse(name).pre_processor({"image": img})
    size = ImageConfigure.parse(name).input_size
    assert out["image"].shape == (size, size, 3)
    np.testing.assert_array_equal(out["image"], want["image"])
    if name == "resnet-50":
        assert abs(float(out["image"].mean())) < 60


def test_torch_label_maps():
    pascal = read_pascal_label_map()
    assert pascal[0] == "__background__" and len(pascal) == 21
    assert pascal[15] == "person"
    coco = read_coco_label_map()
    assert len(coco) == 81 and coco[1] == "person"
    assert config.PASCAL_CLASSES[20] == "tvmonitor"


def test_torch_read_label_map_file(tmp_path):
    p = tmp_path / "labels.txt"
    p.write_text("cat\ndog\nfish\n")
    assert read_label_map(str(p)) == {0: "cat", 1: "dog", 2: "fish"}
    assert read_label_map(str(p), start=1)[1] == "cat"
    p2 = tmp_path / "indexed.txt"
    p2.write_text("7\tseven\n9 nine\n")
    assert read_label_map(str(p2)) == {7: "seven", 9: "nine"}
    assert config.read_imagenet_label_map(str(p)) == read_label_map(str(p))


@pytest.fixture(scope="module")
def squeezenet_pair():
    jm = JImageClassifier("squeezenet", input_shape=(32, 32, 3),
                          num_classes=7)
    tm = ImageClassifier("squeezenet", input_shape=(32, 32, 3),
                         num_classes=7, device="cpu")
    from_jax_params(tm, jax.device_get(jm.get_weights()))
    return jm, tm


def test_torch_predict_image_set_with_configure_equals_jax(squeezenet_pair):
    jm, tm = squeezenet_pair
    labels = {i: f"class{i}" for i in range(7)}

    def configure(tf_mod, cls):
        return cls(pre_processor=(
            tf_mod.ImageResize(40, 40) >> tf_mod.ImageCenterCrop(32, 32)
            >> tf_mod.ImageChannelNormalize(123.68, 116.779, 103.939,
                                            58.4, 57.1, 57.4)),
            label_map=labels)

    raw = _raw_images(3)
    got = tm.predict_image_set(ImageSet.from_arrays(raw),
                               configure=configure(tf2, ImageConfigure))
    want = jm.predict_image_set(jimageset.ImageSet.from_arrays(raw),
                                configure=configure(jtf, JImageConfigure))
    for (_, g), (_, w) in zip(got.get_predicts(), want.get_predicts()):
        assert len(g) == 5
        assert [lbl for lbl, _ in g] == [lbl for lbl, _ in w]
        np.testing.assert_allclose([c for _, c in g], [c for _, c in w],
                                   rtol=0, atol=TOL)
    for f, img in zip(got.features, raw):  # the raw images survive
        np.testing.assert_array_equal(f["image"], img)


def test_torch_predict_image_set_skips_mismatched_configure(
        squeezenet_pair):
    """At 32x32 the registry's 224 preprocessing would emit the wrong
    shape: it is skipped, and model-shaped images predict as they are."""
    _, tm = squeezenet_pair
    imgs = np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    preds = tm.predict_image_set(ImageSet.from_arrays(imgs)).get_predicts()
    assert preds[0][1].shape == (7,)
    np.testing.assert_allclose(np.stack([p for _, p in preds]),
                               tm.predict(imgs, batch_size=4), rtol=TOL)
    odd = [img[:30, :31] for img in imgs]   # not model-shaped either
    with pytest.raises(RuntimeError):
        tm.predict_image_set(ImageSet.from_arrays(odd))


def test_torch_predict_image_set_preserves_ready_inputs():
    """Model-shaped (preprocessed) images skip the registry preprocessing
    even at the registry size."""
    tm = ImageClassifier("squeezenet", input_shape=(224, 224, 3),
                         num_classes=3, device="cpu")
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 224, 224, 3)).astype(
        np.float32)
    iset = ImageSet.from_arrays(imgs)
    direct = tm.predict(imgs, batch_size=2)
    preds = tm.predict_image_set(iset).get_predicts()
    np.testing.assert_allclose(preds[0][1], direct[0], rtol=TOL)
    np.testing.assert_array_equal(iset.features[0]["image"], imgs[0])


def test_torch_predict_image_set_parses_the_registry_on_raw_images():
    """Raw images of other sizes take the registry's configure (resize
    256, center crop 224, normalize) on a copy."""
    tm = ImageClassifier("squeezenet-quantize", input_shape=(224, 224, 3),
                         num_classes=3, device="cpu")
    raw = [np.random.default_rng(i).integers(0, 255, (300, 400, 3)).astype(
        np.float32) for i in range(2)]
    iset = ImageSet.from_arrays(raw)
    tm.predict_image_set(iset)
    for f, b in zip(iset.features, raw):
        np.testing.assert_array_equal(f["image"], b)
    ready = ImageSet.from_arrays(raw).transform(
        ImageConfigure.parse("squeezenet").pre_processor).to_array()
    np.testing.assert_allclose(
        np.stack([p for _, p in iset.get_predicts()]),
        tm.predict(ready, batch_size=2), rtol=0, atol=1e-6)


def test_torch_label_map_smaller_than_classes(squeezenet_pair):
    _, tm = squeezenet_pair
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    cfg = ImageConfigure(label_map={0: "zero", 1: "one"})
    preds = tm.predict_image_set(ImageSet.from_arrays(imgs),
                                 configure=cfg).get_predicts()
    labels = [lbl for lbl, _ in preds[0][1]]
    assert len(labels) == 5 and all(isinstance(l, str) for l in labels)


def test_torch_set_predictions_numeric_lists_stay_arrays():
    iset = ImageSet.from_arrays(np.zeros((2, 4, 4, 3), np.float32))
    iset.set_predictions([[0.1, 0.9], [0.8, 0.2]])
    assert iset.get_predicts()[0][1].shape == (2,)


def test_torch_detector_predict_image_set_equals_jax():
    jdet = JObjectDetector("ssd-mobilenet-300", num_classes=4,
                           max_detections=20)
    tdet = ObjectDetector("ssd-mobilenet-300", num_classes=4,
                          max_detections=20, device="cpu")
    from_jax_params(tdet, jax.device_get(jdet.get_weights()))
    raw = _raw_images(3, seed=5)
    iset = ImageSet.from_arrays(raw)
    got = tdet.predict_image_set(
        iset, batch_size=3,
        configure=ImageConfigure.parse("ssd-mobilenet-300"))
    want = jdet.predict_image_set(
        jimageset.ImageSet.from_arrays(raw), batch_size=3,
        configure=JImageConfigure.parse("ssd-mobilenet-300"))
    for img, (_, g), (_, w), f in zip(raw, got.get_predicts(),
                                      want.get_predicts(), iset.features):
        np.testing.assert_array_equal(f["image"], img)  # a copy was used
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == (20, 6)
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        scale = max(img.shape[:2])
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=0, atol=TOL)
        np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=0,
                                   atol=TOL * scale)
        real = g[:, 0] >= 0
        assert real.any()
        assert (g[real][:, [2, 4]] <= img.shape[1] + 1e-3).all()
        assert (g[real][:, [3, 5]] <= img.shape[0] + 1e-3).all()
