"""The layers the image zoo adds to the port (ZeroPadding2D,
SeparableConvolution2D, SpaceToDepth2D, AveragePooling2D and the six
global pools) against the JAX package's layers on the same parameters
and inputs (made from a numpy seed): the forward and the input's
gradient of a random projection of the output within 1e-6 (relative and
absolute), every parameter's gradient (a sum over the batch and the
image) within 1e-6 of its largest entry, and the output shapes and
configs.
"""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers

TOL = dict(rtol=1e-6, atol=1e-6)


def _check(jl, tl, in_shape, seed=0):
    """Forward and gradients of sum(out * cot) w.r.t. the input and every
    parameter, port against JAX, on one numpy draw."""
    rng = np.random.default_rng(seed)
    params, _ = jl.init(jax.random.PRNGKey(seed), (None,) + in_shape)
    params = {k: (np.asarray(v) + rng.normal(0, 0.1, np.shape(v))).astype(
        np.float32) for k, v in params.items()}
    tl.build((None,) + in_shape, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in params.items()} == \
        {k: tuple(p.shape) for k, p in tl.params().items()}
    with torch.no_grad():
        for k, p in tl.params().items():
            p.copy_(torch.from_numpy(params[k]))
    x = rng.normal(size=(2,) + in_shape).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jfwd(p, xx):
        return jl.apply(p, {}, xx)[0]

    ref = np.asarray(jfwd(jp, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    assert tuple(out.shape) == ref.shape
    assert tuple(tl.compute_output_shape((None,) + in_shape))[1:] == \
        ref.shape[1:] == tuple(jl.compute_output_shape(
            (None,) + in_shape))[1:]
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * cot), argnums=(0, 1))(
        jp, jnp.asarray(x))
    names = list(tl.params())
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                             [xt] + [tl.params()[k] for k in names])
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[1]), **TOL)
    for k, g in zip(names, tg[1:]):
        # a weight's gradient sums over the batch and the image: its
        # rounding scales with the largest entry, not with each
        ref_g = np.asarray(jg[0][k])
        np.testing.assert_allclose(g.numpy(), ref_g, err_msg=k, rtol=0,
                                   atol=1e-6 * max(np.abs(ref_g).max(), 1))
    assert tl.get_config() == {**jl.get_config(), "name": tl.name}


@pytest.mark.parametrize("padding,ordering", list(itertools.product(
    [(1, 1), (3, 2), (2, 1, 2, 1), (0, 3, 1, 0)], ("tf", "th"))))
def test_zero_padding2d_matches_jax(padding, ordering):
    in_shape = (5, 6, 3) if ordering == "tf" else (3, 5, 6)
    _check(jlayers.ZeroPadding2D(padding, dim_ordering=ordering,
                                 name="t_pad"),
           tlayers.ZeroPadding2D(padding, dim_ordering=ordering,
                                 name="t_pad"), in_shape)


SEP_CASES = list(itertools.product(("valid", "same"), (1, 2), (1, 2),
                                   ("tf", "th")))


@pytest.mark.parametrize("border,stride,multiplier,ordering", SEP_CASES)
def test_separable_conv2d_matches_jax(border, stride, multiplier, ordering):
    """A 3x3 depthwise (``depth_multiplier`` filters a channel) then a 1x1
    pointwise convolution over a 9 x 10 image of 4 channels, with XLA's
    SAME padding at strides 1 and 2."""
    in_shape = (9, 10, 4) if ordering == "tf" else (4, 9, 10)
    kw = dict(border_mode=border, subsample=(stride, stride),
              depth_multiplier=multiplier, dim_ordering=ordering,
              activation="relu")
    _check(jlayers.SeparableConvolution2D(5, 3, 3, name="t_sep", **kw),
           tlayers.SeparableConvolution2D(5, 3, 3, name="t_sep", **kw),
           in_shape)


def test_separable_conv2d_layouts_are_jax():
    layer = tlayers.SeparableConvolution2D(
        8, 3, 3, depth_multiplier=2, bias=False, input_shape=(6, 6, 3),
        device="cpu")
    assert {k: tuple(v.shape) for k, v in layer.params().items()} == {
        "depthwise": (3, 3, 1, 6), "pointwise": (1, 1, 6, 8)}


@pytest.mark.parametrize("block,ordering", [(2, "tf"), (2, "th"),
                                            (3, "tf")])
def test_space_to_depth2d_matches_jax(block, ordering):
    in_shape = (6, 12, 3) if ordering == "tf" else (3, 6, 12)
    _check(jlayers.SpaceToDepth2D(block, dim_ordering=ordering,
                                  name="t_s2d"),
           tlayers.SpaceToDepth2D(block, dim_ordering=ordering,
                                  name="t_s2d"), in_shape)


def test_space_to_depth2d_packing_order_and_indivisible():
    """Packed channel (r*2 + s)*C + c holds X[2u + r, 2v + s, c]; an
    indivisible image fails when the model is built."""
    x = np.arange(4 * 4 * 3, dtype=np.float32).reshape(1, 4, 4, 3)
    m = Sequential(device="cpu")
    m.add(tlayers.SpaceToDepth2D(block_size=2, input_shape=(4, 4, 3)))
    y = m.predict(x, batch_size=1)
    assert y.shape == (1, 2, 2, 12)
    for u, v, r, s, c in itertools.product(*[range(n) for n in
                                             (2, 2, 2, 2, 3)]):
        assert y[0, u, v, (r * 2 + s) * 3 + c] == x[0, 2 * u + r,
                                                    2 * v + s, c]
    with pytest.raises(ValueError, match="not divisible"):
        Sequential(device="cpu").add(
            tlayers.SpaceToDepth2D(block_size=2, input_shape=(5, 4, 3)))


@pytest.mark.parametrize("border,pool,stride,n,ordering", list(
    itertools.product(("valid", "same"), (2, 3), (1, 2), (7, 8),
                      ("tf", "th"))))
def test_average_pooling2d_matches_jax(border, pool, stride, n, ordering):
    """Windows of 2 and 3 at strides 1 and 2 over an n x (n + 1) image:
    under SAME the edge windows divide by their count of real elements
    (the odd padding on the high side), under VALID by the window."""
    in_shape = (n, n + 1, 3) if ordering == "tf" else (3, n, n + 1)
    kw = dict(pool_size=pool, strides=stride, border_mode=border,
              dim_ordering=ordering)
    _check(jlayers.AveragePooling2D(name="t_avg", **kw),
           tlayers.AveragePooling2D(name="t_avg", **kw), in_shape)


GLOBAL = ["GlobalMaxPooling1D", "GlobalAveragePooling1D",
          "GlobalMaxPooling2D", "GlobalAveragePooling2D",
          "GlobalMaxPooling3D", "GlobalAveragePooling3D"]


@pytest.mark.parametrize("cls,ordering", list(itertools.product(
    GLOBAL, ("tf", "th"))))
def test_global_pooling_matches_jax(cls, ordering):
    rank = int(cls[-2])
    spatial = (5, 4, 3)[:rank]
    in_shape = spatial + (6,) if ordering == "tf" else (6,) + spatial
    _check(getattr(jlayers, cls)(dim_ordering=ordering, name="t_gp"),
           getattr(tlayers, cls)(dim_ordering=ordering, name="t_gp"),
           in_shape)
