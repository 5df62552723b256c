"""The port's image apps (``apps/*/*_torch.py``: image augmentation 2-D
and 3-D, image similarity, object detection, TFNet inference, the
dogs-vs-cats transfer learning) on the CPU.

Each app runs in process with ``--device cpu`` at the JAX test's own
arguments (``tests/test_examples.py::TestApps``) and prints its JAX
twin's contract lines.  The augmentation apps' arrays equal the JAX
feature layer's.  Each model an app builds is held to the JAX twin's at
the app's widths, with the JAX model's parameters carried over
(``from_jax_params``) and the same seeded inputs: outputs within 1e-5 of
their largest entry (f32), the SSD's detections within 1e-5.  The TFNet
app's GraphDef, written with the port's codec, parses in TF and runs
through the JAX package's TFNet to the port's outputs.  Without
``--device`` every app asks for the card and raises where there is none.

The transfer app's task-B accuracy depends on the initial draw of its
weights: 24 adam steps of a head over near-constant pooled features
leave the predictions within 0.03 of 0.5, so which side of it each row
falls is the draw's.  The JAX twin's draw gives 0.848; so the threshold
(> 0.8) is held where the draws are the same: the JAX twin runs with its
fits' initial weights recorded, and the port's app, starting each fit
from them, prints the same accuracies and losses within 1e-5.
"""

import re

import numpy as np
import pytest
import jax
import torch

from analytics_zoo_tpu.core.module import name_scope as j_name_scope
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models import from_jax_params
from torch_programs import (fresh_context, load_program,  # noqa: F401
                            run_main)

AUG = "apps/image-augmentation/augmentation_torch.py"
AUG3D = "apps/image-augmentation-3d/augmentation_3d_torch.py"
SIMILARITY = "apps/image-similarity/image_similarity_torch.py"
DETECTION = "apps/object-detection/object_detection_torch.py"
TFNET = "apps/tfnet/image_classification_inference_torch.py"
TRANSFER = "apps/dogs-vs-cats/transfer_learning_torch.py"
TOL = 1e-5


@pytest.mark.parametrize("rel", [AUG, AUG3D, SIMILARITY, DETECTION, TFNET,
                                 TRANSFER])
def test_torch_image_apps_run_on_the_card_by_default(rel):
    """Without ``--device`` an app asks for the card, and where there is
    none it raises: it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_program(rel).main([])


def close_rel(got, ref, tol=TOL):
    """Within ``tol`` of the largest entry of ``ref``."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= tol, err


# ---- image augmentation ---------------------------------------------------


def test_torch_augmentation_app():
    out = run_main(AUG)
    assert "2D pipeline output: (4, 24, 24, 3)" in out
    assert "3D pipeline output: (16, 16, 16)" in out
    assert "batches on cpu" in out


def test_torch_augmentation_app_equals_jax_feature_layer():
    from analytics_zoo_tpu.feature.image.imageset import ImageSet
    from analytics_zoo_tpu.feature.image.transforms import (
        ImageBrightness, ImageCenterCrop, ImageChannelNormalize,
        ImageHFlip, ImageResize)
    from analytics_zoo_tpu.feature.image3d.transforms import (
        CenterCrop3D, Rotate3D)
    app = load_program(AUG)
    rs = np.random.RandomState(0)
    images = (rs.rand(4, 40, 48, 3) * 255).astype(np.float32)
    volume = rs.rand(32, 32, 32).astype(np.float32)
    pipeline = (ImageResize(32, 32)
                >> ImageCenterCrop(24, 24)
                >> ImageHFlip(probability=1.0)
                >> ImageBrightness(delta_low=10, delta_high=10)
                >> ImageChannelNormalize(123.0, 117.0, 104.0))
    want = ImageSet.from_arrays(images).transform(pipeline).to_array()
    np.testing.assert_array_equal(app.augment_2d(images), want)
    rotated = Rotate3D([0.0, 0.0, np.pi / 6]).apply({"image": volume})
    want3d = np.asarray(CenterCrop3D([16, 16, 16]).apply(rotated)["image"])
    np.testing.assert_array_equal(app.augment_3d(volume), want3d)


def test_torch_augmentation_3d_app():
    out = run_main(AUG3D)
    assert "3d augmentation done: 3 volumes" in out
    assert len(re.findall(r"crop \(16, 16, 16\), mean \d\.\d{4}", out)) == 3


def test_torch_augmentation_3d_app_equals_jax_feature_layer():
    from analytics_zoo_tpu.feature.image3d.transforms import (
        AffineTransform3D, CenterCrop3D, RandomCrop3D, Rotate3D)
    app = load_program(AUG3D)
    rs = np.random.RandomState(0)
    for i in range(3):
        vol = app.synthetic_volume(rs, 40)
        mat = np.eye(3) + rs.uniform(-0.1, 0.1, (3, 3))
        rotated = Rotate3D([0.0, np.pi / 8, np.pi / 6]).apply(
            {"image": vol})
        warped = AffineTransform3D(mat).apply(rotated)
        cropped = RandomCrop3D([24, 24, 24], seed=i).apply(warped)
        want = np.asarray(CenterCrop3D([16, 16, 16]).apply(cropped)["image"])
        np.testing.assert_array_equal(app.augment(vol, mat, seed=i), want)


# ---- image similarity -----------------------------------------------------


def test_torch_image_similarity_app():
    out = run_main(SIMILARITY)
    m = re.search(r"top-5 purity: ([0-9.]+)", out)
    assert m and 0.0 <= float(m.group(1)) <= 1.0, out


def test_torch_image_similarity_model_matches_jax():
    from analytics_zoo_tpu.core.graph import Input
    from analytics_zoo_tpu.pipeline.api.keras import layers as JL
    from analytics_zoo_tpu.pipeline.api.keras.engine import Model
    from analytics_zoo_tpu.pipeline.api.net import GraphNet as JGraphNet
    from analytics_zoo_tpu_torch.pipeline.api.net import GraphNet
    app = load_program(SIMILARITY)
    with j_name_scope("app"):
        inp = Input((24, 24, 3), name="image")
        h = JL.Convolution2D(8, 3, 3, activation="relu")(inp)
        h = JL.Convolution2D(16, 3, 3, activation="relu")(h)
        emb = JL.GlobalAveragePooling2D(name="embedding")(h)
        jm = Model(input=inp, output=JL.Dense(4, activation="softmax")(emb),
                   name="feature_net")
    with name_scope("app"):
        tm = app.build_model("cpu")
    from_jax_params(tm, jax.device_get(jm.get_weights()))
    x = np.random.default_rng(0).uniform(0, 1.3, (16, 24, 24, 3)).astype(
        np.float32)
    close_rel(tm.predict(x, batch_size=8), jm.predict(x, batch_size=8))
    close_rel(GraphNet.from_model(tm).new_graph(["embedding"]).predict(x),
              JGraphNet.from_model(jm).new_graph(["embedding"]).predict(x))


# ---- object detection -----------------------------------------------------


def test_torch_object_detection_app(tmp_path):
    out = run_main(DETECTION, "--frames", "2", "--out-dir", str(tmp_path))
    assert "object detection done: 2 frames annotated" in out
    assert (tmp_path / "frame0.png").exists()
    assert (tmp_path / "frame1.png").exists()
    assert f"writing annotated frames to {tmp_path}" in out


def test_torch_object_detection_app_default_out_dir_is_fresh(
        tmp_path, monkeypatch):
    """Without ``--out-dir`` each run writes into a new directory of its
    own under the temporary root (``TMPDIR``), which it prints."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    dirs = [re.search(r"writing annotated frames to (\S+)",
                      run_main(DETECTION, "--frames", "1")).group(1)
            for _ in range(2)]
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert d.startswith(str(tmp_path))
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            "frame0.png"]


def test_torch_object_detection_app_matches_jax():
    """SSD-MobileNet-300 at the app's 6 classes, its thresholds and its
    300x300 frames: the raw head and the decoded, suppressed and rescaled
    detections of ``predict_image_set``."""
    from analytics_zoo_tpu.feature.image import ImageSet as JImageSet
    from analytics_zoo_tpu.models.image.detection import (
        ObjectDetector as JObjectDetector)
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    app = load_program(DETECTION)
    jnet = JObjectDetector(model_name="ssd-mobilenet-300", num_classes=6,
                           conf_threshold=0.05, max_detections=20)
    tnet = app.build_detector("ssd-mobilenet-300", 6, "cpu")
    from_jax_params(tnet, jax.device_get(jnet.get_weights()))
    frames = app.synthetic_frames(2)
    close_rel(tnet.predict(frames, batch_size=2),
              jnet.predict(frames, batch_size=2))
    want = jnet.predict_image_set(JImageSet.from_arrays(frames)).features
    got = tnet.predict_image_set(ImageSet.from_arrays(frames)).features
    for a, b in zip(want, got):
        assert (b["predict"][:, 0] >= 0).sum() == 20
        np.testing.assert_allclose(b["predict"], np.asarray(a["predict"]),
                                   rtol=TOL, atol=TOL)


# ---- TFNet ----------------------------------------------------------------


def test_torch_tfnet_app():
    out = run_main(TFNET, "--images", "4")
    assert "tfnet inference done: 4 images, 5 classes" in out
    assert len(re.findall(r"image \d: class \d \(p=0\.\d{3}\)", out)) == 4


def test_torch_tfnet_app_graph_matches_jax_tfnet():
    """The app's GraphDef bytes (the port's codec) parse in TF, and the
    JAX package's TFNet over them predicts the port's outputs."""
    import tensorflow.compat.v1 as tf1
    from analytics_zoo_tpu.pipeline.api.tfgraph.net import TFNet as JTFNet
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph.net import TFNet
    app = load_program(TFNET)
    data = app.build_graph_def()
    gd = tf1.GraphDef()
    gd.ParseFromString(data)
    jnet = JTFNet(graph_def=gd, input_names=[app.INPUT],
                  output_names=[app.OUTPUT])
    tnet = TFNet(graph_def=data, input_names=[app.INPUT],
                 output_names=[app.OUTPUT], device="cpu")
    rs = np.random.RandomState(0)
    batch = app.preprocess((rs.rand(4, 48, 48, 3) * 255).astype(np.float32))
    out = tnet.predict(batch)
    close_rel(out, jnet.predict(batch))
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)


# ---- dogs-vs-cats transfer learning ---------------------------------------


def accuracies(text):
    return [float(a) for a in re.findall(r"'accuracy': ([0-9.]+)", text)]


def test_torch_transfer_learning_app():
    out = run_main(TRANSFER, "--epochs", "3")
    assert "frozen layers: ['backbone_conv1', 'backbone_conv2', " \
           "'backbone_pool']" in out
    assert re.search(r"task B \(frozen backbone\): \{'accuracy': [0-9.]+",
                     out), out
    assert all(0.0 <= a <= 1.0 for a in accuracies(out))


def test_torch_transfer_learning_weights_actually_transfer(
        monkeypatch, capsys):
    """From the JAX twin's initial weights the frozen-backbone task B
    beats chance by a wide margin (the JAX test's threshold), and every
    printed accuracy and loss is the twin's within 1e-5."""
    import sys
    from analytics_zoo_tpu.pipeline.api.keras import engine as jengine
    from analytics_zoo_tpu_torch.pipeline.api.keras import engine
    inits = []
    jfit = jengine.KerasNet.fit

    def recording_fit(self, *a, **kw):
        inits.append(jax.device_get(self.get_weights()))
        return jfit(self, *a, **kw)

    monkeypatch.setattr(jengine.KerasNet, "fit", recording_fit)
    monkeypatch.setattr(sys, "argv", ["transfer_learning.py", "--epochs",
                                      "3"])
    capsys.readouterr()
    load_program("apps/dogs-vs-cats/transfer_learning.py").main()
    want = capsys.readouterr().out
    assert len(inits) == 2  # task A's base, task B's tuned model

    feed = iter(inits)
    fit = engine.KerasNet.fit

    def seeded_fit(self, *a, **kw):
        from_jax_params(self, next(feed))
        return fit(self, *a, **kw)

    monkeypatch.setattr(engine.KerasNet, "fit", seeded_fit)
    out = run_main(TRANSFER, "--epochs", "3")
    m = re.search(r"task B \(frozen backbone\): \{'accuracy': ([0-9.]+)",
                  out)
    assert m and float(m.group(1)) > 0.8, out
    numbers = [re.findall(r"\d+\.\d+", t) for t in (out, want)]
    np.testing.assert_allclose([float(v) for v in numbers[0]],
                               [float(v) for v in numbers[1]], rtol=TOL)
