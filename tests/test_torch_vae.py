"""The conv VAE of the reference's faces app (``chip_smoke.conv_vae``:
strided Convolution2D, BatchNormalization, LeakyReLU, GaussianSampler,
ResizeBilinear; vae.py's packed output and CustomLoss) built from the
port's layers against the same model built from the JAX package's, at a
small width: 16x16 images, the widths divided by 8.

The same weights (``from_jax_params``) give the same eval-mode forward
within 1e-5; then 3 adam steps (lr 1e-3) on one seeded batch, with the
sampler's noise the same in both: the test draws the JAX package's own
noise (``jax.random.normal`` on the layer's rng, as its GaussianSampler
does) and gives the port's sampler the same tensors through its
``draw``.  The losses agree within 1e-5, the weights and the moving
statistics within 1e-5 of their largest entry, and a save_model/
load_model round trip predicts the same.

The eval-mode predictions after the steps run through BatchNormalization's
debiased statistics, ``(moving_var - m**3) / (1 - m**3)`` at count 3:
where a channel's batch variance is small, ``moving_var`` lies within
5e-4 of ``m**3``, and the f32 subtraction the JAX package makes loses
up to 1e-4 of the result (the port's f64 debias is exact for its f32
state, pinned here to 1 ulp of an f64 numpy evaluation).  So the
predictions are held within 1e-4 of their largest entry, from the
port's own statistics and from the JAX package's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import analytics_zoo_tpu.pipeline.api.autograd as JA
from analytics_zoo_tpu.core.module import name_scope as j_name_scope
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras.engine import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    GaussianSampler as JGaussianSampler)
import analytics_zoo_tpu_torch.pipeline.api.autograd as TA
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models import from_jax_params, to_jax_state
from analytics_zoo_tpu_torch.pipeline.api.keras import Model as TModel
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import load_model
from chip_smoke import conv_vae, vae_data, vae_loss

SMALL = dict(size=16, widths=(4, 8, 16, 32), dec_widths=(16, 8, 4, 2),
             latent=16)
BATCH, STEPS = 8, 3
OPTIMIZER = {"name": "adam", "lr": 1e-3}


def _sampler(layers):
    return [l for l in layers if type(l).__name__ == "GaussianSampler"][0]


@pytest.fixture(scope="module")
def pair():
    with j_name_scope("vae"):
        jm = conv_vae(JL, JA, JModel, **SMALL)
    with name_scope("vae"):
        tm = conv_vae(TL, TA, TModel, device="cpu", **SMALL)
    jm.compile(optimizer=OPTIMIZER,
               loss=vae_loss(JA, SMALL["size"], SMALL["latent"]))
    jm.trainer.ensure_initialized()
    from_jax_params(tm, jax.device_get(jm.get_weights()),
                    jax.device_get(jm.trainer.state.model_state))
    tm.compile(optimizer=OPTIMIZER,
               loss=vae_loss(TA, SMALL["size"], SMALL["latent"]))
    x, y = vae_data(SMALL["size"], SMALL["latent"], BATCH)
    return jm, tm, x, y


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * max(1.0, np.abs(ref).max()))


def test_torch_vae_shapes_and_eval_forward_match_jax(pair):
    jm, tm, x, _ = pair
    n = SMALL["size"] ** 2 * 3 + 2 * SMALL["latent"]
    ref = np.asarray(jm.predict(x, batch_size=BATCH))
    out = tm.predict(x, batch_size=BATCH)
    assert out.shape == ref.shape == (BATCH, n)
    _close(out, ref)
    names = [l.name for l in tm.to_graph().layers]
    assert sum(n.startswith("vae/resizebilinear") for n in names) == 4
    assert sum(n.startswith("vae/leakyrelu") for n in names) == 8


def test_torch_vae_trains_as_jax_with_the_same_noise(pair, tmp_path):
    jm, tm, x, y = pair
    drawn = []
    jsampler = _sampler(jm.to_graph().layers)
    assert isinstance(jsampler, JGaussianSampler)

    def recording_call(params, state, inputs, training=False, rng=None):
        # the JAX package's GaussianSampler.call, with its noise recorded
        mean, log_var = inputs
        if not training or rng is None:
            return mean
        eps = jax.random.normal(rng, mean.shape, dtype=mean.dtype)
        jax.debug.callback(lambda e: drawn.append(np.asarray(e)), eps)
        return mean + jnp.exp(log_var * 0.5) * eps

    jsampler.call = recording_call
    j_losses = []
    for _ in range(STEPS):
        j_losses += jm.fit(x, y, batch_size=BATCH, nb_epoch=1,
                           shuffle=False)["loss"]
    jax.effects_barrier()
    assert len(drawn) == STEPS

    tsampler = _sampler(tm.to_graph().layers)
    feed = iter(drawn)
    tsampler.draw = lambda like: torch.from_numpy(np.array(next(feed))).to(
        like)
    t_losses = []
    for _ in range(STEPS):
        t_losses += tm.fit(x, y, batch_size=BATCH, nb_epoch=1,
                           shuffle=False)["loss"]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]

    weights = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for k, v in leaves.items():
            _close(v, weights[layer][k])
    state = jax.device_get(jm.trainer.state.model_state)
    mine = to_jax_state(tm)
    for layer, leaves in state.items():
        for k, v in leaves.items():
            _close(mine[layer][k], v)
    for bn in [l for l in tm.to_graph().layers
               if isinstance(l, TL.BatchNormalization)]:
        m = np.float64(np.float32(bn.momentum))
        st = {k: v.numpy().astype(np.float64) for k, v in bn.state().items()}
        decay = m ** st["count"]
        mean, var = bn.debiased_statistics()
        np.testing.assert_array_max_ulp(
            mean.numpy(), (st["moving_mean"] / (1 - decay)).astype(
                np.float32), maxulp=1)
        np.testing.assert_array_max_ulp(
            var.numpy(), ((st["moving_var"] - decay) / (1 - decay)).astype(
                np.float32), maxulp=1)
    ref = np.asarray(jm.predict(x, batch_size=BATCH))
    out = tm.predict(x, batch_size=BATCH)
    _close(out, ref, rtol=1e-4)

    # a CustomLoss does not go into architecture.json (in neither
    # package): save the uncompiled model over the same layers
    infer = tm.new_graph([tm.outputs[0].name])
    infer.save_model(str(tmp_path / "vae"))
    loaded = load_model(str(tmp_path / "vae"), device="cpu")
    np.testing.assert_array_equal(loaded.predict(x, batch_size=BATCH), out)
    from_jax_params(tm, weights, state)
    _close(tm.predict(x, batch_size=BATCH), ref, rtol=1e-4)
