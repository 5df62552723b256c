"""The port's nnframes estimators, GraphNet and graph serving against the
JAX package's.

Counterparts of ``tests/test_nnframes_inference.py`` (all but the JAX
``InferenceModel``'s own cases) and of ``test_parity_aliases.py``'s
estimator aliases: ``NNEstimator``/``NNClassifier`` fit and transform one
frame as the JAX package's do from the same initial weights (1e-5);
validation metrics inherit the criterion's label base; ``NNModel`` saves
and loads within the port and across the packages (the same files);
``GraphNet.freeze_up_to`` freezes the JAX package's set;
``InferenceModel.load_graph`` and ``load_fn`` serve as the JAX graph's
``apply`` and function compute; the error paths.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from analytics_zoo_tpu.feature.common import SeqToTensor as JSeqToTensor
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.estimator import (
    NNClassifier as JNNClassifier, NNEstimator as JNNEstimator,
    NNModel as JNNModel)
from analytics_zoo_tpu.train.triggers import EveryEpoch as JEveryEpoch
from analytics_zoo_tpu_torch.feature.common import SeqToTensor
from analytics_zoo_tpu_torch.models import from_jax_params
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.net import GraphNet, Net
from analytics_zoo_tpu_torch.pipeline.estimator import (
    NNClassifier, NNClassifierModel, NNEstimator, NNModel)
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.train.triggers import EveryEpoch


def make_df(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    return pd.DataFrame({"features": [row.tolist() for row in x],
                         "label": y.tolist()})


def models(out=2, activation="softmax"):
    """The same two-layer net in both packages (names d1, d2)."""
    jm = JSequential()
    jm.add(JDense(16, input_shape=(4,), activation="relu", name="d1"))
    jm.add(JDense(out, activation=activation, name="d2"))
    tm = Sequential(device="cpu")
    tm.add(Dense(16, input_shape=(4,), activation="relu", name="d1"))
    tm.add(Dense(out, activation=activation, name="d2"))
    return jm, tm


def _seed_port_from_jax(jest, tm):
    """The port model gets the weights the JAX estimator's trainer starts
    from (its seed's init)."""
    tr = jest._build_trainer()
    tr.ensure_initialized()
    from_jax_params(tm, jax.device_get(tr.state.params))


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_nnestimator_fit_transform_follows_jax(optim):
    df = make_df()
    jm, tm = models(1, None)
    jest = (JNNEstimator(jm, "mse", feature_preprocessing=JSeqToTensor((4,)))
            .set_batch_size(32).set_max_epoch(5)
            .set_learning_rate(0.05).set_optim_method(optim))
    est = (NNEstimator(tm, "mse", feature_preprocessing=SeqToTensor((4,)))
           .set_batch_size(32).set_max_epoch(5)
           .set_learning_rate(0.05).set_optim_method(optim))
    _seed_port_from_jax(jest, tm)
    jmodel, model = jest.fit(df), est.fit(df)
    assert isinstance(model, NNModel)
    out, jout = model.transform(df), jmodel.transform(df)
    assert "prediction" in out.columns and len(out) == len(df)
    np.testing.assert_allclose(np.asarray(out["prediction"].tolist()),
                               np.asarray(jout["prediction"].tolist()),
                               rtol=1e-5, atol=1e-5)
    if optim == "adam":  # sgd at this rate learns slower, in both
        preds = np.asarray([p[0] for p in out["prediction"]])
        acc = np.mean((preds > 0.5) == (df["label"].to_numpy() > 0.5))
        assert acc > 0.8, acc


def test_nnclassifier_argmax_validation_follows_jax(tmp_path):
    df, val_df = make_df(128), make_df(64, seed=1)
    jm, tm = models(2)
    jclf = (JNNClassifier(jm, "sparse_categorical_crossentropy",
                          feature_preprocessing=JSeqToTensor((4,)))
            .set_batch_size(32).set_max_epoch(6)
            .set_learning_rate(0.05).set_optim_method("adam")
            .set_validation(JEveryEpoch(), val_df, ["accuracy"], 32))
    clf = (NNClassifier(tm, "sparse_categorical_crossentropy",
                        feature_preprocessing=SeqToTensor((4,)))
           .set_batch_size(32).set_max_epoch(6)
           .set_learning_rate(0.05).set_optim_method("adam")
           .set_validation(EveryEpoch(), val_df, ["accuracy"], 32)
           .set_tensorboard(str(tmp_path / "logs"), "clf"))
    _seed_port_from_jax(jclf, tm)
    model, jmodel = clf.fit(df), jclf.fit(df)
    assert isinstance(model, NNClassifierModel)
    preds = model.transform(df)["prediction"].to_numpy()
    np.testing.assert_array_equal(preds, jmodel.transform(df)[
        "prediction"].to_numpy())
    assert set(np.unique(preds)) <= {0.0, 1.0}
    assert np.mean(preds == df["label"].to_numpy()) > 0.8
    assert (tmp_path / "logs" / "clf" / "validation").exists()
    w, jw = tm.get_weights(), jax.device_get(
        jclf.last_trainer.state.params)
    for layer in ("d1", "d2"):
        np.testing.assert_allclose(w[layer]["W"], jw[layer]["W"],
                                   rtol=1e-5, atol=1e-5)


def test_nnestimator_validation_inherits_label_base():
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Activation
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        ClassNLLCriterion)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(96, 4)).astype(np.float32)
    y1 = (np.argmax(x[:, :3], axis=1) + 1).astype(np.int32)  # 1-based
    df = pd.DataFrame({"features": [r.tolist() for r in x],
                       "label": y1.tolist()})
    m = Sequential(device="cpu")
    m.add(Dense(3, input_shape=(4,)))
    m.add(Activation("log_softmax"))
    est = (NNEstimator(m, ClassNLLCriterion(zero_based_label=False),
                       feature_preprocessing=SeqToTensor((4,)))
           .set_batch_size(32).set_max_epoch(8)
           .set_learning_rate(0.05).set_optim_method("adam"))
    est.set_validation(EveryEpoch(), df, ["accuracy"], 32)
    assert est._build_trainer().metrics[0].zero_based_label is False
    est.fit(df)
    res = est.last_trainer.evaluate(est._to_dataset(df), 32)
    assert np.isfinite(res["loss"]) and res["accuracy"] > 0.5


def test_nnmodel_save_load_within_and_across_packages(tmp_path):
    df = make_df(64)
    jm, tm = models(1, None)
    jest = (JNNEstimator(jm, "mse", feature_preprocessing=JSeqToTensor((4,)))
            .set_batch_size(32).set_max_epoch(2).set_optim_method("adam"))
    est = (NNEstimator(tm, "mse", feature_preprocessing=SeqToTensor((4,)))
           .set_batch_size(32).set_max_epoch(2).set_optim_method("adam"))
    _seed_port_from_jax(jest, tm)
    model, jmodel = est.fit(df), jest.fit(df)
    ref = np.asarray(model.transform(df)["prediction"].tolist())
    jref = np.asarray(jmodel.transform(df)["prediction"].tolist())
    model.save(str(tmp_path / "port"))
    jmodel.save(str(tmp_path / "jax"))
    # the port's save, loaded by the port and by the JAX package
    own = NNModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(
        np.asarray(own.transform(df)["prediction"].tolist()), ref)
    cross = JNNModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(
        np.asarray(cross.transform(df)["prediction"].tolist()), ref,
        rtol=1e-5, atol=1e-6)
    # the JAX package's save, loaded by the port
    back = NNModel.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(
        np.asarray(back.transform(df)["prediction"].tolist()), jref,
        rtol=1e-5, atol=1e-6)
    with pytest.raises(FileExistsError):
        model.save(str(tmp_path / "port"), over_write=False)


def test_nnclassifier_model_class_survives_save(tmp_path):
    df = make_df(64)
    _, tm = models(2)
    model = (NNClassifier(tm, "sparse_categorical_crossentropy",
                          feature_preprocessing=SeqToTensor((4,)))
             .set_batch_size(32).set_max_epoch(1)).fit(df)
    model.save(str(tmp_path / "c"))
    loaded = NNModel.load(str(tmp_path / "c"), device="cpu")
    assert isinstance(loaded, NNClassifierModel)
    assert loaded.transform(df)["prediction"].tolist() == \
        model.transform(df)["prediction"].tolist()


def test_graphnet_freeze_up_to_matches_jax():
    from analytics_zoo_tpu.core.graph import Input as JInput
    from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
    from analytics_zoo_tpu.pipeline.api.net import GraphNet as JGraphNet
    from analytics_zoo_tpu_torch.core.graph import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras import Model

    from analytics_zoo_tpu.pipeline.api.keras.layers import Merge as JMerge
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Merge

    def build(Input, Dense, Merge, Model, **kw):
        x = Input((4,), name="gin")
        a = Dense(8, name="frozen_dense")(x)
        b = Dense(6, name="side")(x)
        m = Merge(mode="concat", concat_axis=-1, name="cat")([a, b])
        return Model(input=x, output=Dense(2, name="head_dense")(m), **kw)

    jnet = JGraphNet.from_model(build(JInput, JDense, JMerge, JModel))
    net = GraphNet.from_model(build(Input, Dense, Merge, Model,
                                    device="cpu"))
    jnet.freeze_up_to(["frozen_dense"])
    net.freeze_up_to(["frozen_dense"])
    assert set(net.frozen_layer_names()) == set(
        jnet.frozen_layer_names()) == {"frozen_dense"}
    net.compile(optimizer={"name": "sgd", "lr": 0.5}, loss="mse")
    x = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    before = {k: v["W"].copy() for k, v in net.get_weights().items()
              if "W" in v}
    net.fit(x, y, batch_size=32, nb_epoch=2)
    after = net.get_weights()
    np.testing.assert_array_equal(after["frozen_dense"]["W"],
                                  before["frozen_dense"])
    assert not np.allclose(after["head_dense"]["W"], before["head_dense"])
    assert not np.allclose(after["side"]["W"], before["side"])
    assert net.to_keras() is net
    net.unfreeze()
    jnet.unfreeze()
    assert net.frozen_layer_names() == [] == jnet.frozen_layer_names()


def test_load_graph_serves_as_the_jax_graph_applies():
    jm, tm = models(3)
    graph = jm.to_graph()
    params, state = graph.init(jax.random.PRNGKey(3), (None, 4))
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    want, _ = graph.apply(params, state, x, training=False)
    im = InferenceModel(device="cpu").load_graph(
        tm, jax.device_get(params), jax.device_get(state))
    try:
        np.testing.assert_allclose(im.predict(x), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    finally:
        im.close()


def test_load_fn_and_error_paths():
    im = InferenceModel(device="cpu")
    with pytest.raises(RuntimeError, match="no model loaded"):
        im.predict(np.zeros((1, 2)))
    im.load_fn(lambda p, x: x @ p["w"],
               {"w": np.eye(4, dtype=np.float32) * 2.0})
    x = np.ones((2, 4), dtype=np.float32)
    np.testing.assert_allclose(im.predict(x), 2 * x)
    im.close()
    with pytest.raises(ValueError, match="input_names"):
        Net.load_tf("/nonexistent.pb", device="cpu")
    with pytest.raises(NotImplementedError, match="Caffe"):
        Net.load_caffe("a", "b")
    with pytest.raises(ValueError, match="pass path"):
        InferenceModel(device="cpu").load_tf()


def test_estimator_aliases_and_read_images(tmp_path):
    from PIL import Image
    from analytics_zoo_tpu.pipeline.estimator.nn_estimator import (
        read_images as jread)
    from analytics_zoo_tpu_torch.pipeline.estimator.nn_estimator import (
        NNImageReader, read_images)
    assert NNImageReader is read_images
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            Image.fromarray(np.full((6, 5, 3), 40 * i, np.uint8)).save(
                str(tmp_path / cls / f"{i}.png"))
    df = read_images(str(tmp_path), with_label=True, resize_h=4,
                     resize_w=4)
    jdf = jread(str(tmp_path), with_label=True, resize_h=4, resize_w=4)
    assert list(df.columns) == list(jdf.columns)
    assert df["label"].tolist() == jdf["label"].tolist()
    for a, b in zip(df["image"], jdf["image"]):
        np.testing.assert_array_equal(a, b)


def test_numpy_column_frame_duck_types():
    """A frame of numpy columns (no pandas) fits and transforms, as
    chip_smoke drives it on the card's machine."""

    class Frame(dict):
        @property
        def columns(self):
            return list(self)

        def copy(self):
            return Frame(self)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    frame = Frame(features=x, label=(x.sum(1) > 0).astype(np.float32))
    _, tm = models(2)
    out = (NNClassifier(tm, "sparse_categorical_crossentropy")
           .set_batch_size(16).set_max_epoch(1)).fit(frame).transform(frame)
    assert len(out["prediction"]) == 64 and "features" in out.columns
    assert torch.is_tensor(next(tm.parameters()))
