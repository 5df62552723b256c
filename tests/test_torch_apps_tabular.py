"""The port's tabular and sequence apps (``apps/*/*_torch.py``:
anomaly detection, sentiment analysis, NCF, Wide & Deep, fraud
detection, the variational autoencoder) on the CPU.

Each app runs in process with ``--device cpu`` at the JAX test's own
arguments (``tests/test_examples.py::TestApps``; the fraud and VAE apps,
which no JAX test runs, at their defaults) and prints its JAX twin's
contract lines.  Each model an app builds is held to the JAX twin's
model at the app's widths: the JAX model's parameters go into the port's
(``from_jax_params``) and both take the same seeded inputs; outputs agree
within 1e-5 of their largest entry (f32).  The VAE's sampler takes the
JAX package's own noise, and three of its training steps give the same
losses within 1e-5 relative.  Without ``--device`` every app asks for
the card and raises where there is none.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import analytics_zoo_tpu.pipeline.api.autograd as JA
from analytics_zoo_tpu.core.graph import Input as JInput
from analytics_zoo_tpu.core.module import name_scope as j_name_scope
from analytics_zoo_tpu.models import (
    ColumnFeatureInfo as JColumnFeatureInfo, NeuralCF as JNeuralCF,
    WideAndDeep as JWideAndDeep)
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras.engine import (
    Model as JModel, Sequential as JSequential)
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models import features_to_arrays, from_jax_params
from torch_programs import fresh_context, load_program, run_main  # noqa: F401

ANOMALY = "apps/anomaly-detection/anomaly_detection_torch.py"
SENTIMENT = "apps/sentiment-analysis/sentiment_torch.py"
NCF = "apps/recommendation-ncf/ncf_explicit_feedback_torch.py"
WND = "apps/recommendation-wide-n-deep/wide_n_deep_torch.py"
FRAUD = "apps/fraud-detection/fraud_detection_torch.py"
VAE = "apps/variational-autoencoder/vae_torch.py"
TOL = 1e-5


@pytest.mark.parametrize("rel", [ANOMALY, SENTIMENT, NCF, WND, FRAUD, VAE])
def test_torch_tabular_apps_run_on_the_card_by_default(rel):
    """Without ``--device`` an app asks for the card, and where there is
    none it raises: it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_program(rel).main(["--epochs", "1"])


def close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def pair(build_jax, build_port):
    """Both packages' models, each built in the name scope "app", so the
    layers' names match."""
    with j_name_scope("app"):
        jm = build_jax()
    with name_scope("app"):
        tm = build_port()
    return jm, tm


def held_to_jax(jm, tm, x, batch_size=64):
    """The JAX model's parameters into the port's, then the same
    eval-mode forward of ``x``."""
    from_jax_params(tm, jax.device_get(jm.get_weights()))
    out = tm.predict(x, batch_size=batch_size)
    close(out, jm.predict(x, batch_size=batch_size))
    return out


# ---- anomaly detection ----------------------------------------------------


def test_torch_anomaly_detection_app():
    out = run_main(ANOMALY, "--epochs", "1")
    assert "synthetic fallback" in out
    assert "true anomalies hit=" in out


def test_torch_anomaly_detection_lstm_matches_jax():
    app = load_program(ANOMALY)
    series, _ = app.make_series()
    x, _ = app.windows((series - series.mean()) / series.std(), 24)

    def build_jax():
        jm = JSequential(name="anomaly_lstm")
        jm.add(JL.LSTM(32, input_shape=(24, 1)))
        jm.add(JL.Dropout(0.2))
        jm.add(JL.Dense(1))
        jm.compile(optimizer="adam", loss="mean_squared_error")
        return jm

    out = held_to_jax(*pair(build_jax, lambda: app.build_model(24, "cpu")),
                      x[:256])
    assert out.shape == (256, 1)


# ---- sentiment analysis ---------------------------------------------------


def test_torch_sentiment_app():
    out = run_main(SENTIMENT, "--epochs", "1")
    assert "synthetic fallback" in out
    assert "test metrics:" in out


def test_torch_sentiment_bilstm_matches_jax():
    app = load_program(SENTIMENT)
    x, _ = app.synthetic_task(128, 30, 8, seed=1)

    def build_jax():
        jm = JSequential(name="sentiment_bilstm")
        jm.add(JL.Bidirectional(JL.LSTM(16), input_shape=(30, 8)))
        jm.add(JL.Dense(2, activation="softmax"))
        jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        return jm

    out = held_to_jax(*pair(build_jax,
                            lambda: app.build_model("cpu", 30, dim=8)), x)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)


# ---- NCF ------------------------------------------------------------------


def test_torch_ncf_app(tmp_path):
    log_dir = tmp_path / "tb"
    out = run_main(NCF, "--epochs", "2", "--ratings", "1024",
                   "--log-dir", str(log_dir))
    assert "ncf app done" in out
    assert "top-3 items per user" in out
    assert "val MAE per epoch" in out  # summaries round-trip from disk
    assert "HitRatio@3" in out
    assert any(log_dir.rglob("*")), "the summaries went to --log-dir"


@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_torch_ncf_app_models_match_jax(kind):
    app = load_program(NCF)
    hyper = dict(user_count=100, item_count=80, hidden_layers=(20, 10))
    hyper.update(dict(num_classes=5, include_mf=False) if kind == "explicit"
                 else dict(num_classes=2, include_mf=True, mf_embed=8))
    data = app.synthetic_movielens(100, 80, 256)
    build = app.build_explicit if kind == "explicit" else app.build_implicit
    held_to_jax(*pair(lambda: JNeuralCF(**hyper),
                      lambda: build(100, 80, "cpu")), data[:, :2])


# ---- Wide & Deep ----------------------------------------------------------


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_torch_wide_n_deep_app(model_type):
    out = run_main(WND, "--epochs", "2", "--ratings", "1024",
                   "--model-type", model_type)
    assert "wide-n-deep app done" in out
    assert "validation metrics:" in out
    assert ("top-3 users per item" in out) == (model_type == "wide_n_deep")


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_torch_wide_n_deep_app_model_matches_jax(model_type):
    app = load_program(WND)
    info = app.column_info(80, 60)
    (wide, deep), _ = features_to_arrays(
        app.featurize(app.synthetic_tables(80, 60, 128), info))
    x = {"wide": wide, "deep": deep, "wide_n_deep": [wide, deep]}[
        model_type]
    jm, tm = pair(lambda: JWideAndDeep(
        model_type=model_type, num_classes=5,
        column_info=JColumnFeatureInfo(**dataclasses.asdict(info)),
        hidden_layers=(40, 20, 10)),
        lambda: app.build_model(model_type, info, "cpu"))
    # the wide part's zero init predicts uniform: give it a signal
    rng = np.random.default_rng(5)
    noisy = {layer: {k: np.asarray(v) + rng.normal(0, 0.3, v.shape).astype(
        np.float32) for k, v in leaves.items()}
        for layer, leaves in jax.device_get(jm.get_weights()).items()}
    jm.set_weights(noisy)
    out = held_to_jax(jm, tm, x)
    np.testing.assert_allclose(np.exp(out).sum(axis=1), 1.0, rtol=1e-5)


# ---- fraud detection ------------------------------------------------------


def test_torch_fraud_detection_app():
    out = run_main(FRAUD)
    assert "held-out metrics:" in out
    auc = float(out.split("'auc': ")[1].split(",")[0])
    assert auc > 0.8, out


def test_torch_fraud_detection_mlp_matches_jax():
    app = load_program(FRAUD)
    x, _, _, _ = app.make_data(0.03)

    def build_jax():
        jm = JSequential(name="fraud_mlp")
        jm.add(JL.Dense(32, activation="relu", input_shape=(app.D,)))
        jm.add(JL.Dropout(0.3))
        jm.add(JL.Dense(16, activation="relu"))
        jm.add(JL.Dense(2, activation="softmax"))
        jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        return jm

    held_to_jax(*pair(build_jax, lambda: app.build_model("cpu")), x[:512],
                batch_size=256)


# ---- variational autoencoder ----------------------------------------------


def test_torch_vae_app():
    out = run_main(VAE, "--epochs", "2")
    mse = float(out.split("reconstruction MSE: ")[1].split()[0])
    assert np.isfinite(mse) and mse < 1.0, out  # the data's variance ~0.5
    assert "latent mean of first 3 encodings:" in out


def _jax_vae(d, latent):
    """The JAX twin's VAE (``vae.py``), with its packed output."""
    inp = JInput((d,), name="x")
    h = JL.Dense(32, activation="relu")(inp)
    z_mean = JL.Dense(latent, name="z_mean")(h)
    z_log_var = JL.Dense(latent, name="z_log_var")(h)
    z = JL.GaussianSampler()([z_mean, z_log_var])
    dh = JL.Dense(32, activation="relu")(z)
    recon = JL.Dense(d, name="recon")(dh)
    packed = JA.concat([recon, z_mean, z_log_var], axis=1)
    return JModel(input=inp, output=packed, name="vae")


def _jax_vae_loss(d, latent):
    def vae_loss(y_true, y_pred):
        rec = y_pred[:, :d]
        mu = y_pred[:, d:d + latent]
        lv = y_pred[:, d + latent:]
        rec_loss = jnp.sum(jnp.square(y_true[:, :d] - rec), axis=1)
        kl = -0.5 * jnp.sum(1 + lv - jnp.square(mu) - jnp.exp(lv), axis=1)
        return rec_loss + kl
    return vae_loss


def test_torch_vae_app_trains_as_jax_with_the_same_noise():
    from analytics_zoo_tpu.pipeline.api.autograd import (
        CustomLoss as JCustomLoss)
    from analytics_zoo_tpu_torch.pipeline.api.autograd import CustomLoss
    app = load_program(VAE)
    d, latent, steps, batch = app.D, 2, 3, 64
    x = app.make_data()[:batch]
    y = np.concatenate([x, np.zeros((batch, 2 * latent), np.float32)], 1)
    jm, tm = pair(lambda: _jax_vae(d, latent), lambda: app.build_model(
        latent, "cpu", torch.Generator("cpu").manual_seed(0)))
    jm.compile(optimizer="adam", loss=JCustomLoss(_jax_vae_loss(d, latent)))
    tm.compile(optimizer="adam", loss=CustomLoss(app.vae_loss(latent)))
    held_to_jax(jm, tm, x)  # eval mode: the sampler passes the mean

    drawn = []
    jsampler, = [l for l in jm.to_graph().layers
                 if type(l).__name__ == "GaussianSampler"]

    def recording_call(params, state, inputs, training=False, rng=None):
        # the JAX package's GaussianSampler.call, with its noise recorded
        mean, log_var = inputs
        if not training or rng is None:
            return mean
        eps = jax.random.normal(rng, mean.shape, dtype=mean.dtype)
        jax.debug.callback(lambda e: drawn.append(np.asarray(e)), eps)
        return mean + jnp.exp(log_var * 0.5) * eps

    jsampler.call = recording_call
    j_losses = jm.fit(x, y, batch_size=batch, nb_epoch=steps,
                      shuffle=False)["loss"]
    jax.effects_barrier()
    assert len(drawn) == steps
    tsampler, = [l for l in tm.to_graph().layers
                 if type(l).__name__ == "GaussianSampler"]
    feed = iter(drawn)
    tsampler.draw = lambda like: torch.from_numpy(np.array(next(feed))).to(
        like)
    t_losses = tm.fit(x, y, batch_size=batch, nb_epoch=steps,
                      shuffle=False)["loss"]
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL)
    close(tm.predict(x, batch_size=batch), jm.predict(x, batch_size=batch))
