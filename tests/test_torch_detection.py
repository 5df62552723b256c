"""The port's SSD detection zoo against the JAX package's, on the CPU.

Counterpart of ``tests/test_object_detection.py``.  Priors equal the
JAX package's exactly, for the recipe and for each registry
architecture's own head shapes.  ``ssd-vgg16-300`` with 4 classes, at
300x300 and batch 1 on U(0, 255) pixels with the JAX model's weights,
gives the JAX package's raw head within 1e-4 of its largest entry (so
does ``ssd-mobilenet-300`` with its BatchNorm state).  ``decode_output``
gives the JAX package's labels exactly and its scores and boxes within
1e-5 in three cases: one planted box, random logits at 8,732 priors with
21 classes and batch 2, and all-zero logits, where every score ties and
only the tie rules decide the order.  ``nms_padded`` gives the JAX
package's picks, and the batched decode equals a loop over images and
classes of ``nms_padded``.  ``Reshape`` keeps ``jnp.reshape``'s element
order on a convolution's output.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.models.image import detection as jdet
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models import from_jax_params, to_jax_state
from analytics_zoo_tpu_torch.models.image import detection as tdet
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers

HEAD_TOL = 1e-4     # raw head, over its largest entry
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,n_priors", [
    ("ssd-vgg16-300", 8732), ("ssd-mobilenet-300", 2252),
    ("ssd-vgg16-512", 24656)])
def test_registry_priors_equal_jax(name, n_priors):
    t = tdet.ObjectDetector(name, num_classes=21, device="cpu")
    arch, size = {"ssd-vgg16-300": (jdet.ssd_vgg16, 300),
                  "ssd-mobilenet-300": (jdet.ssd_mobilenet, 300),
                  "ssd-vgg16-512": (jdet.ssd_vgg16, 512)}[name]
    jmodel = arch(21, size)
    ref = jdet.model_priors(jmodel, 21, size)
    assert t.priors.shape == (n_priors, 4) and t.priors.device.type == "cpu"
    np.testing.assert_array_equal(t.priors.numpy(), ref)
    assert t.to_graph().output_shapes == jmodel.to_graph().output_shapes \
        == [(None, n_priors, 25)]
    np.testing.assert_array_equal(tdet.ssd_priors(300),
                                  jdet.ssd_priors(300))


def _head_parity(name, classes, rows, seed):
    jnet = jdet.ObjectDetector(model_name=name, num_classes=classes)
    tnet = tdet.ObjectDetector(name, num_classes=classes, device="cpu")
    params = jax.device_get(jnet.get_weights())
    rng = np.random.default_rng(seed)
    state = None
    if to_jax_state(tnet):
        # imported moving statistics (count inf: eval mode uses them
        # as they are)
        state = {n: {k: (rng.uniform(0.5, 1.5, v.shape)
                         if k == "moving_var" else
                         rng.normal(0, 0.2, v.shape) if k == "moving_mean"
                         else np.asarray(np.inf)).astype(np.float32)
                     for k, v in d.items()}
                 for n, d in to_jax_state(tnet).items()}
    from_jax_params(tnet, params, state)
    x = rng.uniform(0, 255, (rows, 300, 300, 3)).astype(np.float32)
    if state is None:
        ref = np.asarray(jnet.predict(x, batch_size=rows))
    else:
        g = jnet.to_graph()
        ref = np.asarray(g.apply(params, jax.tree_util.tree_map(
            jnp.asarray, state), jnp.asarray(x), training=False)[0])
    out = tnet.predict(x, batch_size=rows)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max() / np.abs(ref).max())
    assert err <= HEAD_TOL, err
    return jnet, tnet, out, ref


def test_ssd_vgg16_head_matches_jax():
    _head_parity("ssd-vgg16-300", classes=4, rows=1, seed=0)


def test_ssd_mobilenet_head_matches_jax():
    """ssd-mobilenet-300 builds, its priors match its head, and with
    the JAX model's weights and BatchNorm statistics it gives the JAX
    package's head."""
    _head_parity("ssd-mobilenet-300", classes=21, rows=1, seed=1)


def _jax_decode(out, priors, classes, **kw):
    return np.asarray(jdet.decode_output(jnp.asarray(out),
                                         jnp.asarray(priors), classes, **kw))


def _check_decode(out, priors, classes, **kw):
    ref = _jax_decode(out, priors, classes, **kw)
    got = tdet.decode_output(torch.from_numpy(out), torch.from_numpy(priors),
                             classes, **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_allclose(got[..., 1:], ref[..., 1:], **DECODE_TOL)
    pad = got[..., 0] < 0
    assert (got[pad] == -1).all()
    return got


def test_decode_finds_planted_box_like_jax():
    priors = tdet.ssd_priors(300)
    out = np.zeros((1, priors.shape[0], 8), np.float32)
    out[:, :, 4] = 5.0  # background logits everywhere
    target = 1234
    out[0, target, 4] = 0.0
    out[0, target, 6] = 8.0  # class 2 confident
    dets = _check_decode(out, priors, 4, conf_threshold=0.3,
                         max_detections=10)
    top = dets[0, 0]
    assert top[0] == 2 and top[1] > 0.9
    cx, cy, w, h = priors[target]
    np.testing.assert_allclose(top[2:], [cx - w / 2, cy - h / 2,
                                         cx + w / 2, cy + h / 2], atol=1e-5)
    assert (dets[0, 1:, 0] == -1).all()


def test_decode_random_logits_like_jax():
    """8,732 priors, 21 classes, batch 2: every score above the 0.01
    threshold, top_k 200 and 100 detections."""
    priors = tdet.ssd_priors(300)
    rng = np.random.default_rng(0)
    out = rng.normal(0, 1.0, (2, priors.shape[0], 25)).astype(np.float32)
    out[..., :4] *= 0.5
    dets = _check_decode(out, priors, 21, conf_threshold=0.01,
                         nms_threshold=0.45, top_k=200, max_detections=100)
    assert (dets[..., 0] >= 1).all()  # 100 real rows an image


@pytest.mark.parametrize("conf_threshold", [0.01, 0.5])
def test_decode_all_zero_logits_ties_like_jax(conf_threshold):
    """All-zero logits: every class scores 1/21 at every prior, so top-k,
    the NMS picks and the final sort are all ties (broken toward the
    lower index); above 1/21 every row is padding."""
    priors = tdet.ssd_priors(300)
    out = np.zeros((2, priors.shape[0], 25), np.float32)
    dets = _check_decode(out, priors, 21, conf_threshold=conf_threshold,
                         top_k=200, max_detections=100)
    if conf_threshold > 1 / 21:
        assert (dets == -1).all()
    else:
        # equal scores keep class-major order: labels never fall
        assert (np.diff(dets[..., 0], axis=-1) >= 0).all()
        assert dets[0, 0, 0] == 1


def test_nms_padded_matches_jax():
    boxes = np.asarray([[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52],
                        [0.6, 0.6, 0.9, 0.9]], np.float32)
    scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    idx, kept = tdet.nms_padded(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.5, 3)
    assert idx.tolist() == [0, 2, 0] and kept[0] == pytest.approx(0.9)
    assert kept[1] == pytest.approx(0.7) and kept[2] < 0
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 0.8, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (64, 2))],
                           axis=1).astype(np.float32)
    scores = rng.uniform(0, 1, 64).astype(np.float32)
    scores[::7] = scores[0]  # ties
    ji, js = jdet.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 40)
    ti, ts = tdet.nms_padded(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.3, 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_batched_decode_equals_per_class_loop():
    """The one batched loop against images and classes one at a time
    through nms_padded, as the JAX package's decode runs them."""
    priors = torch.from_numpy(tdet.ssd_priors(
        300, feature_sizes=(10, 5, 3, 1)))
    classes, top_k, m = 6, 50, 20
    rng = np.random.default_rng(4)
    out = torch.from_numpy(rng.normal(0, 2.0, (3, priors.shape[0],
                                               4 + classes)).astype(
        np.float32))
    got = tdet.decode_output(out, priors, classes, conf_threshold=0.05,
                             nms_threshold=0.4, top_k=top_k,
                             max_detections=m)
    for b in range(out.shape[0]):
        probs = torch.softmax(out[b, :, 4:], dim=-1)
        boxes = tdet.decode_boxes(out[b, :, :4], priors)
        rows = []
        for c in range(1, classes):
            scores = torch.where(probs[:, c] >= 0.05, probs[:, c], -1.0)
            order = torch.sort(scores, descending=True, stable=True)[1][:top_k]
            keep, kept = tdet.nms_padded(boxes[order], scores[order], 0.4, m)
            r = torch.cat([torch.full((m, 1), float(c)), kept[:, None],
                           boxes[order][keep]], dim=1)
            rows.append(torch.where(kept[:, None] > 0, r, -1.0))
        rows = torch.cat(rows)
        ref = rows[torch.argsort(-rows[:, 1], stable=True)[:m]]
        np.testing.assert_array_equal(got[b].numpy(), ref.numpy())


def test_decode_boxes_zero_deltas_recover_priors():
    priors = torch.tensor([[0.5, 0.5, 0.2, 0.4]])
    boxes = tdet.decode_boxes(torch.zeros((1, 4)), priors)
    np.testing.assert_allclose(boxes[0].numpy(), [0.4, 0.3, 0.6, 0.7],
                               atol=1e-6)


def test_reshape_keeps_jax_element_order():
    """Reshape of a convolution's output (a permuted view here) with a
    -1, as SSD's heads use it, against the JAX package's."""
    def build(L, seq, **kw):
        m = seq(**kw)
        m.add(L.Convolution2D(6, 3, 3, border_mode="same",
                              input_shape=(5, 7, 3)))
        m.add(L.Reshape((-1, 2)))
        return m

    with jname_scope("rs"):
        jm = build(jlayers, JSequential)
    with name_scope("rs"):
        tm = build(tlayers, Sequential, device="cpu")
    tm.set_weights(jax.device_get(jm.get_weights()))
    assert tm.to_graph().output_shapes == [(None, 105, 2)]
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.predict(x, batch_size=2),
                               np.asarray(jm.predict(x, batch_size=2)),
                               rtol=1e-5, atol=1e-5)
    assert tlayers.Reshape((-1, 4)).get_config()["target_shape"] == [-1, 4]


def test_scale_detection_and_visualize():
    dets = np.full((1, 2, 6), -1.0, np.float32)
    dets[0, 0] = [1, 0.9, 0.1, 0.2, 0.5, 0.6]
    scaled = tdet.ScaleDetection()(dets, heights=[100], widths=[200])
    np.testing.assert_allclose(scaled[0, 0], [1, 0.9, 20, 20, 100, 60],
                               atol=1e-4)
    np.testing.assert_array_equal(
        scaled, jdet.ScaleDetection()(dets, heights=[100], widths=[200]))
    img = np.zeros((100, 200, 3), np.float32)
    drawn = tdet.visualize(img, scaled[0], threshold=0.5)
    assert drawn.shape == (100, 200, 3) and drawn.max() > 0
    np.testing.assert_array_equal(
        drawn, jdet.visualize(img, scaled[0], threshold=0.5))
    vis = tdet.Visualizer(label_map={1: "cat"}, threshold=0.5)
    np.testing.assert_array_equal(vis(img, scaled[0]),
                                  jdet.Visualizer({1: "cat"}, 0.5)(
                                      img, scaled[0]))


def test_object_detector_names_and_unported_paths():
    with pytest.raises(ValueError, match="frcnn|Unknown detector"):
        tdet.ObjectDetector(model_name="frcnn-vgg16", device="cpu")
    det = tdet.ObjectDetector("ssd-vgg16-300-quantize", num_classes=3,
                              device="cpu")
    assert det.priors.shape == (8732, 4) and det.image_size == 300
    # the int8 path is ported: a '-quantize' name predicts through it
    assert det.predict(np.zeros((1, 300, 300, 3)).astype(np.float32)
                       ).shape == (1, 8732, 7)
    assert det._quantized_net is not None
