"""ImageClassifier('resnet-50') on the port against the JAX package's,
at 32x32 with 7 classes (``tests/test_model_zoo.py``'s small variant),
on the CPU: prediction with the same weights and BatchNorm state, three
sgd-momentum training steps through both packages' ``Trainer`` (f32,
bf16 compute and ``accum_steps=2``), the space-to-depth stem, save/load
with state, the registry's errors and ``label_output``.

Training tolerances.  At its random init on noise images this network
is ill-conditioned in training mode: the stem convolution's gradient has
a norm near 1e4, so sgd is stable only at a learning rate below ~1e-8
(1e-9 here lowers the loss from 2.63 to 2.30 in three steps), and f32
rounding moves the gradient's direction by a few percent.  The JAX
package does not agree with itself closer than that: its two forms of
the same BatchNorm (the closed-form VJP and the naive autodiff one,
``ops/batchnorm.py``) give, after these three steps, losses 3.8e-4
apart (relative), moving statistics 3.2e-4 apart (of each tensor's
largest entry), momentum traces 3.3e-2 and weight changes 4.9e-2 apart
(of the largest).  The port is held to the JAX package's closed form at
twice to four times that spread, fixed beforehand: losses within 2e-3,
moving statistics within 2e-3, weight changes within 0.1; the counts
exactly.  A wrong momentum convention or the unbiased variance would be
off by 1e-1 to 1e1.  The model's function is held tighter by prediction
(1e-5, here and for every architecture in
``tests/test_torch_image_registry*.py``) and BatchNorm's training step by
``tests/test_torch_batchnorm.py`` (1e-5).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from analytics_zoo_tpu.data.dataset import Dataset as JDataset
from analytics_zoo_tpu.models.image import ImageClassifier as JImageClassifier
from analytics_zoo_tpu.models.image.classification import (
    label_output as jlabel_output, resnet50 as jresnet50,
    space_to_depth_stem_kernel as jstem_kernel)
from analytics_zoo_tpu.parallel import mesh as mesh_lib
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.train import triggers as jtriggers
from analytics_zoo_tpu.train.trainer import Trainer as JTrainer
from analytics_zoo_tpu_torch.data.dataset import Dataset
from analytics_zoo_tpu_torch.models import (ImageClassifier, from_jax_params,
                                            to_jax_params, to_jax_state)
from analytics_zoo_tpu_torch.models.image import (
    label_output, resnet50, space_to_depth_stem_kernel)
from analytics_zoo_tpu_torch.pipeline.api.keras import (load_model,
                                                        objectives,
                                                        optimizers)
from analytics_zoo_tpu_torch.train import triggers
from analytics_zoo_tpu_torch.train.trainer import Trainer

SHAPE, CLASSES, BATCH = (32, 32, 3), 7, 8
LR = 1e-9
LOSS_RTOL, STATE_TOL, CHANGE_TOL = 2e-3, 2e-3, 0.1


@pytest.fixture(scope="module")
def jax_model():
    return JImageClassifier("resnet-50", input_shape=SHAPE,
                            num_classes=CLASSES)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(BATCH,) + SHAPE).astype(np.float32),
            rng.integers(0, CLASSES, BATCH).astype(np.int32))


def _port(**kw):
    return ImageClassifier("resnet-50", input_shape=SHAPE,
                           num_classes=CLASSES, device="cpu", **kw)


def _random_state(state, rng, count=5, momentum=0.99):
    """A JAX model_state as ``count`` EMA updates toward random
    statistics would leave it (eval mode debiases with the count)."""
    d = momentum ** count

    def leaf(shape):
        mean = rng.normal(0, 0.5, shape)
        var = rng.uniform(0.5, 2.0, shape)
        return {"moving_mean": ((1 - d) * mean).astype(np.float32),
                "moving_var": (d + (1 - d) * var).astype(np.float32),
                "count": np.asarray(count, np.float32)}
    return {name: leaf(np.shape(leaves["moving_mean"]))
            for name, leaves in state.items()}


def test_resnet50_names_and_shapes_are_jax(jax_model):
    tm = _port()
    jax_model.ensure_inference_ready()
    jparams = jax.device_get(jax_model.trainer.state.params)
    jstate = jax.device_get(jax_model.trainer.state.model_state)
    assert set(tm.get_weights()) == set(jparams)
    for name, leaves in jparams.items():
        assert {k: np.shape(v) for k, v in leaves.items()} == \
            {k: v.shape for k, v in tm.get_weights()[name].items()}
    assert set(to_jax_state(tm)) == set(jstate)
    assert len(jstate) == 53 and len(jparams) == 107
    full = ImageClassifier("resnet-50", device="cpu")
    assert full.to_graph().output_shapes[0] == (None, 1000)
    assert sum(p.numel() for p in full.parameters()) == 25_557_032


def test_resnet50_predicts_like_jax(jax_model, data):
    """Eval mode on moving statistics off their init: the same weights
    and state in both packages predict within 1e-5."""
    jax_model.ensure_inference_ready()
    st = jax_model.trainer.state
    params = jax.device_get(st.params)
    state = _random_state(jax.device_get(st.model_state),
                          np.random.default_rng(1))
    st.model_state = jax.device_put(state)
    ref = np.asarray(jax_model.predict(data[0], batch_size=BATCH))
    tm = _port()
    from_jax_params(tm, params, state)
    out = tm.predict(data[0], batch_size=BATCH)
    assert out.shape == (BATCH, CLASSES) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    # the state round trip is bit-exact
    for name, leaves in to_jax_state(tm).items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(v, state[name][k])


def _fit_both(jax_model, data, compute_dtype=None, accum_steps=1, steps=3):
    """``steps`` sgd-momentum steps (lr LR) of the JAX package's Trainer
    and the port's from the same weights and state on the same batch."""
    mesh = mesh_lib.create_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JTrainer(jax_model.to_graph(),
                  jobj.get("sparse_categorical_crossentropy"),
                  optax.sgd(LR, momentum=0.9), mesh=mesh, seed=0,
                  accum_steps=accum_steps,
                  compute_dtype=None if compute_dtype is None
                  else jnp.bfloat16)
    jt.ensure_initialized()
    p0 = jax.device_get(jt.state.params)
    s0 = jax.device_get(jt.state.model_state)
    tm = _port()
    from_jax_params(tm, p0, s0)
    tt = Trainer(tm, objectives.get("sparse_categorical_crossentropy"),
                 optimizers.get({"name": "sgd", "lr": LR, "momentum": 0.9}),
                 seed=0, accum_steps=accum_steps,
                 compute_dtype=compute_dtype)
    x, y = data
    ref = jt.fit(JDataset.from_ndarray(x, y), batch_size=BATCH,
                 end_trigger=jtriggers.MaxIteration(steps), shuffle=False)
    out = tt.fit(Dataset.from_ndarray(x, y), batch_size=BATCH,
                 end_trigger=triggers.MaxIteration(steps), shuffle=False)
    return (np.asarray(ref["loss"]), np.asarray(out["loss"]), p0,
            jax.device_get(jt.state.params), to_jax_params(tm),
            jax.device_get(jt.state.model_state), to_jax_state(tm), tt)


def _state_err(got, ref):
    """The largest distance of a state tensor, over its largest entry."""
    return max(float(np.abs(got[n][k] - np.asarray(ref[n][k])).max()
                     / np.abs(np.asarray(ref[n][k])).max())
               for n in ref for k in ("moving_mean", "moving_var"))


def _change_err(p0, got, ref):
    """max |port change - JAX change| over max |JAX change|, all
    parameters."""
    num = max(float(np.abs(got[n][k] - np.asarray(ref[n][k])).max())
              for n in ref for k in ref[n])
    den = max(float(np.abs(np.asarray(ref[n][k]) - p0[n][k]).max())
              for n in ref for k in ref[n])
    return num / den


@pytest.fixture(scope="module")
def f32_run(jax_model, data):
    return _fit_both(jax_model, data)


def test_resnet50_trains_like_jax(f32_run):
    """f32: three steps against the JAX package's Trainer (see the module
    docstring for the tolerances); every BN counted 3 updates."""
    ref, out, p0, jp, tp, js, ts, tt = f32_run
    assert np.all(np.isfinite(out)) and out[-1] < out[0]
    np.testing.assert_allclose(out, ref, rtol=LOSS_RTOL)
    assert _state_err(ts, js) <= STATE_TOL
    assert _change_err(p0, tp, jp) <= CHANGE_TOL
    assert {float(v["count"]) for v in ts.values()} == {3.0} == \
        {float(v["count"]) for v in js.values()}
    # the trainer's state tree holds the live buffers
    assert tt.state_tree()["model_state"]["conv1_bn"]["count"] is \
        tt.model.get_layer("conv1_bn").count


def test_resnet50_bf16_trains_like_jax(jax_model, data, f32_run):
    """bf16 compute over f32 master weights, momentum and state.  Rounding
    to bf16 moves this ill-conditioned network's training-mode loss by
    tenths (the JAX package's own bf16 run starts 0.46 above its f32
    one), so the two packages' bf16 runs are compared by their distance
    from their own f32 runs: the port's bf16 losses and moving statistics
    lie within twice the distance of the JAX package's from its f32 run
    (measured: 0.75 and 1.06 times it).  The statistics accumulate in
    f32, the counts are exact."""
    ref, out, p0, jp, tp, js, ts, tt = _fit_both(
        jax_model, data, compute_dtype=torch.bfloat16)
    ref32, out32, _, _, _, js32, ts32, _ = f32_run
    assert np.all(np.isfinite(out))
    assert np.abs(out - out32).max() <= 2 * np.abs(ref - ref32).max()
    assert _state_err(ts, ts32) <= 2 * _state_err(js, js32)
    assert all(p.dtype == torch.float32 for p in tt.state.params)
    assert all(t.dtype == torch.float32 for s in tt.state.opt_state.states
               if s is not None for t in s)
    assert all(b.dtype == torch.float32 for b in tt.model.buffers())
    assert {float(v["count"]) for v in ts.values()} == {3.0}


def test_resnet50_accum_threads_state_like_jax(jax_model, data):
    """accum_steps=2, one step: microbatch 2 sees the moving statistics
    that microbatch 1 left, as the JAX package's scan carries them (two
    updates; the statistics within 2e-3 of JAX's, the loss, the mean of
    the two microbatches' at the same weights, within 2e-3)."""
    ref, out, p0, jp, tp, js, ts, tt = _fit_both(jax_model, data,
                                                 accum_steps=2, steps=1)
    assert {float(v["count"]) for v in ts.values()} == {2.0} == \
        {float(v["count"]) for v in js.values()}
    np.testing.assert_allclose(out, ref, rtol=LOSS_RTOL)
    assert _state_err(ts, js) <= STATE_TOL
    assert _change_err(p0, tp, jp) <= CHANGE_TOL


def test_space_to_depth_stem_matches_jax_and_standard():
    """space_to_depth_stem_kernel against JAX's on one kernel (exactly),
    and the packed stem with the converted kernel predicts what the
    standard 7x7/s2 stem does (1e-5)."""
    w = np.random.RandomState(0).randn(7, 7, 3, 64).astype(np.float32)
    packed = space_to_depth_stem_kernel(w)
    np.testing.assert_array_equal(packed, np.asarray(jstem_kernel(w)))
    assert packed.shape == (4, 4, 12, 64)
    assert torch.equal(space_to_depth_stem_kernel(torch.from_numpy(w)),
                       torch.from_numpy(packed))
    std = resnet50(input_shape=(64, 64, 3), num_classes=10, device="cpu")
    s2d = resnet50(input_shape=(64, 64, 3), num_classes=10,
                   space_to_depth=True, device="cpu", seed=1)
    weights = std.get_weights()
    weights["conv1"] = {"W": space_to_depth_stem_kernel(
        weights["conv1"]["W"])}
    s2d.set_weights(weights)
    x = np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(s2d.predict(x, batch_size=4),
                               std.predict(x, batch_size=4),
                               rtol=1e-4, atol=1e-5)
    j = jresnet50(input_shape=(64, 64, 3), num_classes=10,
                  space_to_depth=True)
    assert set(j.get_weights()) == set(s2d.get_weights())


def test_save_load_and_checkpoint_restore_state(tmp_path, data):
    """save_model/load_model carry the weights and every moving statistic
    and count: the reload predicts what the saved model did; an epoch
    checkpoint restores the state too; get_weights stays params-only."""
    x, y = data
    m = _port()
    m.compile({"name": "sgd", "lr": LR, "momentum": 0.9},
              "sparse_categorical_crossentropy")
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=BATCH, nb_epoch=2)
    ref = m.predict(x, batch_size=BATCH)
    state = to_jax_state(m)
    assert {float(v["count"]) for v in state.values()} == {2.0}
    m.save_model(str(tmp_path / "resnet"))
    loaded = load_model(str(tmp_path / "resnet"), device="cpu")
    assert isinstance(loaded, ImageClassifier)
    np.testing.assert_allclose(loaded.predict(x, batch_size=BATCH), ref,
                               rtol=0, atol=1e-6)
    for name, leaves in to_jax_state(loaded).items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(v, state[name][k])
    assert all("moving_mean" not in leaves
               for leaves in m.get_weights().values())
    # the epoch checkpoint holds params, model_state and opt_state
    fresh = _port(seed=3)
    fresh.compile({"name": "sgd", "lr": LR, "momentum": 0.9},
                  "sparse_categorical_crossentropy")
    fresh.trainer.load_weights(str(tmp_path / "ckpt"))
    assert fresh.trainer.state.step == 2
    for name, leaves in to_jax_state(fresh).items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(v, state[name][k])
    np.testing.assert_allclose(fresh.predict(x, batch_size=BATCH), ref,
                               rtol=0, atol=1e-6)


def test_serving_predicts_with_state(tmp_path, data):
    """A trained ImageClassifier (moving statistics off their init)
    served two ways, each within 1e-6 of its predict: ``to_serving()``
    (the bucketed path, eval mode, from two threads) and
    ``InferenceModel.load`` of its save, which rebuilds it with its
    state."""
    import threading
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    x, y = data
    m = _port(seed=2)
    m.compile({"name": "sgd", "lr": LR, "momentum": 0.9},
              "sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=BATCH)
    ref = m.predict(x, batch_size=BATCH)
    im = m.to_serving(max_batch_size=BATCH)
    out = [None, None]
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, im.predict(x[4 * i:4 * i + 4]))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        im.close()
    np.testing.assert_allclose(np.concatenate(out), ref, rtol=0, atol=1e-6)
    m.save_model(str(tmp_path / "served"))
    handle = InferenceModel(device="cpu").load(str(tmp_path / "served"))
    try:
        np.testing.assert_allclose(handle.predict(x), ref, rtol=0,
                                   atol=1e-6)
    finally:
        handle.close()


def test_registry_errors():
    with pytest.raises(ValueError, match="Unknown model"):
        ImageClassifier("resnet-51", device="cpu")
    q = ImageClassifier("squeezenet-quantize", input_shape=SHAPE,
                        num_classes=CLASSES, device="cpu")
    # the int8 path and predict_image_set are ported
    assert q.predict(np.zeros((1,) + SHAPE, np.float32)).shape == (
        1, CLASSES)
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    iset = q.predict_image_set(ImageSet.from_arrays(
        np.zeros((2,) + SHAPE, np.float32)))
    assert iset.get_predicts()[1][1].shape == (CLASSES,)


def test_label_output_matches_jax():
    probs = np.random.default_rng(2).dirichlet(np.ones(10), size=4)
    labels = [f"class_{i}" for i in range(10)]
    for kw in ({}, {"labels": labels}, {"labels": labels, "top_k": 3}):
        assert label_output(probs, **kw) == jlabel_output(probs, **kw)
