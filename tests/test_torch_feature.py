"""The port's feature layer (``feature/``) against the JAX package's, on
the CPU.

Counterparts of ``tests/test_feature.py``'s feature cases.  Every 2-D
and 3-D transform gives the JAX package's arrays exactly (atol 0) on the
same seeded inputs and seeds, over three images in a row, so the random
transforms' streams agree too: both are numpy (and scipy, and PIL) on
the host.  ``ImageResize``'s two branches are each held to the other
package's with ``_HAS_PIL`` monkeypatched in both modules (no file
edited), and ``resize_branch`` names the branch taken.  ``ImageSet.read``
of PNG and JPEG class folders written under ``tmp_path`` decodes to the
JAX package's pixels exactly, with the same labels (1-based and
0-based); the preprocessing spec round-trips, and the port's spec equals
the JAX package's.
"""

import numpy as np
import pytest
from PIL import Image

from analytics_zoo_tpu.feature import common as jcommon
from analytics_zoo_tpu.feature.image import imageset as jimageset
from analytics_zoo_tpu.feature.image import transforms as jtf
from analytics_zoo_tpu.feature.image3d import transforms as jtf3
from analytics_zoo_tpu_torch.data.dataset import Dataset
from analytics_zoo_tpu_torch.feature import common
from analytics_zoo_tpu_torch.feature.image import imageset
from analytics_zoo_tpu_torch.feature.image import transforms as tf2
from analytics_zoo_tpu_torch.feature.image3d import transforms as tf3

_RNG = np.random.default_rng(0)
IMAGES = [_RNG.uniform(0, 255, (40 + 3 * i, 60 - 5 * i, 3)).astype(
    np.float32) for i in range(3)]

# (class name, constructor args), the same for both packages
TRANSFORMS_2D = [
    ("ImageResize", (32, 24)),
    ("BufferedImageResize", (17, 33)),
    ("ImageAspectScale", (30, 50, 4)),
    ("ImageCenterCrop", (24, 20)),
    ("ImageRandomCrop", (24, 20, 3)),
    ("ImageFixedCrop", (0.1, 0.2, 0.8, 0.9, True)),
    ("ImageFixedCrop", (3, 4, 30, 25, False)),
    ("ImageChannelNormalize", (123.0, 117.0, 104.0, 58.4, 57.1, 57.4)),
    ("ImageChannelOrder", ()),
    ("ImageBrightness", (-32, 32, 5)),
    ("ImageHue", (-18, 18, 6)),
    ("ImageSaturation", (0.5, 1.5, 7)),
    ("ImageContrast", (0.5, 1.5, 8)),
    ("ImageColorJitter", (9,)),
    ("ImageExpand", (123, 117, 104, 2.5, 10)),
    ("ImageFiller", (0.1, 0.2, 0.5, 0.6, 7)),
    ("ImageHFlip", (0.5, 11)),
    ("ImageMatToFloats", ()),
    ("ImageRandomAspectScale", ([20, 30, 40], 2, 60, 12)),
]


def _run(tf_module, name, args, images):
    t = getattr(tf_module, name)(*args)
    return [t.apply({"image": img.copy(), "uri": "u"}) for img in images]


@pytest.mark.parametrize("name,args", TRANSFORMS_2D,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(TRANSFORMS_2D)])
def test_torch_2d_transform_equals_jax(name, args):
    got = _run(tf2, name, args, IMAGES)
    want = _run(jtf, name, args, IMAGES)
    for g, w in zip(got, want):
        assert isinstance(g, tf2.ImageFeature) and g["uri"] == "u"
        assert g["image"].dtype == w["image"].dtype
        np.testing.assert_array_equal(g["image"], w["image"])


@pytest.mark.parametrize("has_pil", [True, False])
def test_torch_resize_branches_equal_jax(monkeypatch, has_pil):
    """Both branches of ImageResize, under one test: PIL's bilinear
    filter on uint8-range 3-channel images when PIL is importable, scipy
    zoom otherwise (and always for floats outside [0, 255])."""
    monkeypatch.setattr(tf2, "_HAS_PIL", has_pil)
    monkeypatch.setattr(jtf, "_HAS_PIL", has_pil)
    pixels = IMAGES[0]
    normalized = (IMAGES[1] - 128.0) / 64.0
    gray = IMAGES[2][..., :1]
    assert tf2.resize_branch(pixels) == ("pil" if has_pil else "scipy")
    assert tf2.resize_branch(normalized) == "scipy"
    assert tf2.resize_branch(gray) == "scipy"
    for img in (pixels, normalized, gray):
        got = tf2.ImageResize(23, 31).transform(img)
        want = jtf.ImageResize(23, 31).transform(img)
        assert got.shape == (23, 31, img.shape[2])
        np.testing.assert_array_equal(got, want)
    if has_pil:  # the PIL branch drops the fractions (uint8 pixels)
        np.testing.assert_array_equal(
            tf2.ImageResize(23, 31).transform(pixels),
            tf2.ImageResize(23, 31).transform(np.floor(pixels)))


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_torch_tensor_and_sample_adapters_equal_jax(fmt):
    got = tf2.ImageMatToTensor(fmt).apply(
        {"image": IMAGES[0], "label": np.float32(3)})
    want = jtf.ImageMatToTensor(fmt).apply(
        {"image": IMAGES[0], "label": np.float32(3)})
    np.testing.assert_array_equal(got["tensor"], want["tensor"])
    gx, gy = tf2.ImageSetToSample().apply(got)
    wx, wy = jtf.ImageSetToSample().apply(want)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert tf2.ImageSetToSample().apply({"image": IMAGES[0],
                                         "tensor": IMAGES[0]})[1] is None


def test_torch_pixel_normalizer_and_random_preprocessing_equal_jax():
    means = _RNG.uniform(0, 255, IMAGES[0].shape).astype(np.float32)
    np.testing.assert_array_equal(
        tf2.ImagePixelNormalizer(means).transform(IMAGES[0]),
        jtf.ImagePixelNormalizer(means).transform(IMAGES[0]))
    got = tf2.ImageRandomPreprocessing(tf2.ImageHFlip(), 0.5, seed=3)
    want = jtf.ImageRandomPreprocessing(jtf.ImageHFlip(), 0.5, seed=3)
    for img in IMAGES * 3:
        np.testing.assert_array_equal(got.apply(img)["image"],
                                      want.apply(img)["image"])
    with pytest.raises(ValueError, match="'image' key"):
        tf2.ImageHFlip().apply({"pixels": IMAGES[0]})


def _volume(seed):
    return np.random.default_rng(seed).normal(size=(9, 10, 11)).astype(
        np.float32)


TRANSFORMS_3D = [
    ("Rotate3D", ((0.3, -0.2, 1.0),)),
    ("AffineTransform3D", (np.diag([1.1, 0.9, 1.0]).tolist(),
                           (0.5, -1.0, 0.25), "clamp")),
    ("AffineTransform3D", (np.eye(3).tolist(), (1.5, 0, 0), "padding",
                           -1.0)),
    ("Crop3D", ((1, 2, 3), (4, 5, 6))),
    ("CenterCrop3D", ((5, 6, 7),)),
    ("RandomCrop3D", ((5, 6, 7), 4)),
]


@pytest.mark.parametrize("name,args", TRANSFORMS_3D,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(TRANSFORMS_3D)])
@pytest.mark.parametrize("channel", [False, True])
def test_torch_3d_transform_equals_jax(name, args, channel):
    vols = [_volume(s) for s in range(3)]
    if channel:
        vols = [v[..., None] for v in vols]
    t, j = getattr(tf3, name)(*args), getattr(jtf3, name)(*args)
    for v in vols:
        got, want = t.apply(v), j.apply(v)
        assert isinstance(got, tf3.ImageFeature3D)
        np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(tf3.rotation_matrix(0.3, -0.2, 1.0),
                                  jtf3.rotation_matrix(0.3, -0.2, 1.0))


def test_torch_chains_adapters_and_spec_round_trip():
    chain = common.SeqToTensor((2, 2)) >> common.SeqToTensor((4,))
    np.testing.assert_array_equal(chain.apply([1, 2, 3, 4]), [1, 2, 3, 4])
    flp = common.FeatureLabelPreprocessing(common.SeqToTensor((2,)),
                                           common.ScalarToTensor())
    f, lab = flp.apply(([3.0, 4.0], 7))
    np.testing.assert_array_equal(f, [3, 4])
    np.testing.assert_array_equal(lab, [7])
    assert common.ToTuple().apply(5) == (5, None)
    assert common.TensorToSample().apply(5) == (5, None)
    assert common.FeatureToTupleAdapter(common.ScalarToTensor()).apply(
        (2, "y"))[1] == "y"
    assert common.Lambda(lambda v: v * 2).apply(3) == 6
    assert common.BigDLAdapter().apply(4) == 4
    np.testing.assert_array_equal(
        common.MLlibVectorToTensor((2,)).apply(np.arange(2)), [0, 1])

    pipeline = common.ChainedPreprocessing([
        tf2.ImageResize(32, 32), tf2.ImageCenterCrop(24, 24),
        tf2.ImageChannelNormalize(123, 117, 104), tf2.ImageHFlip(0.5, 3),
        tf2.ImageMatToTensor("NCHW"), tf2.ImageSetToSample()])
    jpipeline = jcommon.ChainedPreprocessing([
        jtf.ImageResize(32, 32), jtf.ImageCenterCrop(24, 24),
        jtf.ImageChannelNormalize(123, 117, 104), jtf.ImageHFlip(0.5, 3),
        jtf.ImageMatToTensor("NCHW"), jtf.ImageSetToSample()])
    spec = common.preprocessing_to_spec(pipeline)
    assert spec == jcommon.preprocessing_to_spec(jpipeline)
    again = common.preprocessing_from_spec(spec)
    for img in IMAGES:
        x, y = again.apply(img)
        wx, _ = jpipeline.apply(img)
        assert x.shape == (3, 24, 24) and y is None
        np.testing.assert_array_equal(x, wx)
    flp_spec = common.preprocessing_to_spec(flp)
    assert common.preprocessing_from_spec(flp_spec).apply(
        ([1.0, 2.0], 3))[1].tolist() == [3.0]


def _write_folder(root, fmt):
    rng = np.random.default_rng(1)
    for cls_name in ("cats", "dogs", "emus"):
        d = root / cls_name
        d.mkdir()
        for i in range(2):
            arr = rng.integers(0, 256, (12 + i, 16, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img{i}.{fmt}")


@pytest.mark.parametrize("fmt", ["png", "jpg"])
@pytest.mark.parametrize("one_based", [True, False])
def test_torch_imageset_read_equals_jax(tmp_path, fmt, one_based):
    _write_folder(tmp_path, fmt)
    got = imageset.ImageSet.read(str(tmp_path), with_label=True,
                                 one_based_label=one_based)
    want = jimageset.ImageSet.read(str(tmp_path), with_label=True,
                                   one_based_label=one_based)
    assert len(got) == len(want) == 6
    assert got.label_map == want.label_map
    np.testing.assert_array_equal(got.labels(), want.labels())
    assert sorted(np.unique(got.labels()).tolist()) == (
        [1, 2, 3] if one_based else [0, 1, 2])
    for g, w in zip(got.features, want.features):
        assert g["uri"] == w["uri"]
        assert g["original_size"] == w["original_size"] == g["image"].shape
        np.testing.assert_array_equal(g["image"], w["image"])
    if fmt == "png":  # lossless: BGR of the written pixels
        arr = np.asarray(Image.open(got.features[0]["uri"]).convert("RGB"))
        np.testing.assert_array_equal(got.features[0]["image"][..., ::-1],
                                      arr)
    one = imageset.ImageSet.read(got.features[0]["uri"])
    assert len(one) == 1 and one.labels() is None
    globbed = imageset.ImageSet.read(str(tmp_path / "dogs" / f"*.{fmt}"))
    assert len(globbed) == 2


def test_torch_imageset_operations():
    arrs = np.stack([img[:20, :20] for img in IMAGES])
    iset = imageset.ImageSet.from_arrays(arrs, labels=np.arange(3))
    copy = iset.copy()
    copy >> tf2.ImageCenterCrop(10, 10)
    assert iset.to_array().shape == (3, 20, 20, 3)
    assert copy.to_array().shape == (3, 10, 10, 3)
    copy.transform(tf2.ImageMatToTensor("NCHW"))
    assert copy.to_array().shape == (3, 3, 10, 10)  # the tensor key
    ds = iset.to_dataset()
    assert isinstance(ds, Dataset) and ds.size == 3
    np.testing.assert_array_equal(ds.y, [0, 1, 2])
    iset.set_predictions([[0.1, 0.9], [0.8, 0.2], [0.5, 0.5]])
    assert iset.get_predicts()[0][1].shape == (2,)
    iset.set_predictions([[("cat", 0.9)], [("dog", 0.8)], [("emu", 0.7)]])
    assert iset.get_predicts()[2][1] == [("emu", 0.7)]
    assert imageset.LocalImageSet is imageset.DistributedImageSet
    assert isinstance(imageset.LocalImageSet([]), imageset.ImageSet)
