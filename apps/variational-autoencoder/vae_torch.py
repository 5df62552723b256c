"""Variational autoencoder with the GaussianSampler reparameterization,
on the PyTorch/CUDA port.

The port of ``vae.py`` beside it (the reference's
apps/variational-autoencoder): encoder -> (mean, log_var) ->
GaussianSampler -> decoder, trained with reconstruction + KL loss
written as a CustomLoss.  The sampler draws its noise from an explicit
``torch.Generator`` seeded with ``--seed``.  Runs on ``--device``
(default ``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np

D = 16


def make_data(seed=0):
    """1024 rows on a low-dimensional manifold: 2 latent factors -> 16
    dims, with a little noise."""
    rs = np.random.RandomState(seed)
    z_true = rs.randn(1024, 2).astype(np.float32)
    mix = rs.randn(2, D).astype(np.float32)
    return np.tanh(z_true @ mix) + 0.05 * rs.randn(1024, D).astype(
        np.float32)


def build_model(latent, device, generator):
    """The VAE as one Model whose single output packs [recon | mean |
    log_var], so one loss sees all three; the sampler draws from
    ``generator``."""
    from analytics_zoo_tpu_torch.core.graph import Input
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        GaussianSampler)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense

    inp = Input((D,), name="x")
    h = Dense(32, activation="relu")(inp)
    z_mean = Dense(latent, name="z_mean")(h)
    z_log_var = Dense(latent, name="z_log_var")(h)
    z = GaussianSampler(generator=generator)([z_mean, z_log_var])
    dh = Dense(32, activation="relu")(z)
    recon = Dense(D, name="recon")(dh)
    packed = A.concat([recon, z_mean, z_log_var], axis=1)
    return Model(input=inp, output=packed, name="vae", device=device)


def vae_loss(latent):
    """Per-row reconstruction squared error plus the KL divergence of
    N(mean, exp(log_var)) from N(0, 1)."""
    import torch

    def loss(y_true, y_pred):
        rec = y_pred[:, :D]
        mu = y_pred[:, D:D + latent]
        lv = y_pred[:, D + latent:]
        rec_loss = torch.sum(torch.square(y_true[:, :D] - rec), dim=1)
        kl = -0.5 * torch.sum(1 + lv - torch.square(mu) - torch.exp(lv),
                              dim=1)
        return rec_loss + kl
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--latent", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the sampler's generator")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    import torch

    from analytics_zoo_tpu_torch.common.context import resolve_device
    from analytics_zoo_tpu_torch.pipeline.api.autograd import CustomLoss

    device = resolve_device(args.device)
    latent = args.latent
    x = make_data()
    generator = torch.Generator(device).manual_seed(args.seed)
    vae = build_model(latent, device, generator)
    vae.compile(optimizer="adam", loss=CustomLoss(vae_loss(latent)))
    # y_true is x padded to the packed width (ignored beyond :D)
    y = np.concatenate([x, np.zeros((len(x), 2 * latent), np.float32)], 1)
    vae.fit(x, y, batch_size=64, nb_epoch=args.epochs)

    out = np.asarray(vae.predict(x[:256], batch_size=64))
    rec_err = float(np.mean(np.square(out[:, :D] - x[:256])))
    print(f"reconstruction MSE: {rec_err:.4f}")
    print("latent mean of first 3 encodings:",
          np.round(out[:3, D:D + latent], 3))


if __name__ == "__main__":
    main()
