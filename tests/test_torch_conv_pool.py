"""The port's Convolution2D, Convolution1D, MaxPooling2D and Flatten
against the JAX package's layers on the same parameters and inputs (made
from a numpy seed): the forward and the gradients of a random projection
of the output (input, W and b), all within 1e-5.  Both run on the CPU;
the JAX layers call ``lax.conv_general_dilated`` and
``lax.reduce_window``, the port's ``F.conv2d`` and ``F.max_pool2d`` with
XLA's SAME padding made explicit.
"""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import activations as jact
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    Convolution1D as JConv1D, Convolution2D as JConv2D, Flatten as JFlatten,
    MaxPooling2D as JMaxPool)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution1D, Convolution2D, Flatten, MaxPooling2D)

TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed(params, rng):
    """The JAX layer's params as f32 numpy, biases moved off zero."""
    return {k: (np.asarray(v) + rng.normal(0, 0.1, np.shape(v))).astype(
        np.float32) for k, v in params.items()}


def _check(jl, tl, in_shape, seed=0):
    """Forward and gradients of sum(out * cot) w.r.t. the input and every
    parameter, port against JAX, on one numpy draw."""
    rng = np.random.default_rng(seed)
    params, _ = jl.init(jax.random.PRNGKey(seed), (None,) + in_shape)
    params = _perturbed(params, rng)
    assert {k: v.shape for k, v in params.items()} == \
        {k: tuple(p.shape) for k, p in tl.params().items()}
    with torch.no_grad():
        for k, p in tl.params().items():
            p.copy_(torch.from_numpy(params[k]))
    x = rng.normal(size=(2,) + in_shape).astype(np.float32)

    def jfwd(p, xx):
        return jl.apply(p, {}, xx)[0]

    ref = np.asarray(jfwd({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    assert tuple(out.shape) == ref.shape
    assert tuple(tl.compute_output_shape((None,) + in_shape))[1:] == \
        ref.shape[1:]
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * cot), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    names = list(tl.params())
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                             [xt] + [tl.params()[k] for k in names])
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[1]), **TOL)
    for k, g in zip(names, tg[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]), **TOL,
                                   err_msg=k)


CONV_CASES = list(itertools.product(
    ("valid", "same"), (1, 2), (1, 2), (10, 11), ("tf", "th")))


@pytest.mark.parametrize("border,stride,dilation,n,ordering", CONV_CASES)
def test_conv2d_matches_jax(border, stride, dilation, n, ordering):
    """A 3x2 kernel over an n x (n + 1) image with 3 channels."""
    in_shape = (n, n + 1, 3) if ordering == "tf" else (3, n, n + 1)
    kw = dict(border_mode=border, subsample=stride, dilation=dilation,
              dim_ordering=ordering)
    jl = JConv2D(4, 3, 2, name="t_conv", **kw)
    tl = Convolution2D(4, 3, 2, input_shape=in_shape, device="cpu", **kw)
    _check(jl, tl, in_shape)


@pytest.mark.parametrize("border,stride", list(itertools.product(
    ("valid", "same", "causal"), (1, 2))))
def test_conv1d_matches_jax(border, stride):
    kw = dict(border_mode=border, subsample=stride, dilation=2)
    jl = JConv1D(5, 3, name="t_conv1d", **kw)
    tl = Convolution1D(5, 3, input_shape=(13, 3), device="cpu", **kw)
    _check(jl, tl, (13, 3))


@pytest.mark.parametrize("border,stride,n,ordering", list(itertools.product(
    ("valid", "same"), (1, 2), (10, 11), ("tf", "th"))))
def test_maxpool2d_matches_jax(border, stride, n, ordering):
    """3x3 windows: overlapping at stride 1 and 2, and with an odd SAME
    padding at stride 2 (-inf, so a pad never wins)."""
    in_shape = (n, n + 1, 3) if ordering == "tf" else (3, n, n + 1)
    kw = dict(pool_size=3, strides=stride, border_mode=border,
              dim_ordering=ordering)
    _check(JMaxPool(name="t_pool", **kw),
           MaxPooling2D(input_shape=in_shape, **kw), in_shape)


def test_maxpool2d_defaults_match_jax():
    _check(JMaxPool(name="t_pool"), MaxPooling2D(), (8, 9, 2))


@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_flatten_order_matches_jax(ordering):
    """Flatten keeps the axes' order: (h, w, c) for an NHWC conv output,
    (c, h, w) for NCHW, as the JAX package's does; so a Dense after it
    reads the JAX package's weights correctly."""
    in_shape = (6, 7, 3) if ordering == "tf" else (3, 6, 7)
    x = np.random.default_rng(1).normal(size=(2,) + in_shape).astype(
        np.float32)
    out = Flatten()(torch.from_numpy(x)).numpy()
    jl = JFlatten(name="t_flat")
    ref = np.asarray(jl.apply({}, {}, jnp.asarray(x))[0])
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, x.reshape(2, -1))
    assert Flatten().compute_output_shape((None,) + in_shape) == (None, 126)


@pytest.mark.parametrize("activation", sorted(jact._ACTIVATIONS))
def test_conv_activation_matches_jax(activation):
    """Every activation name inside a channels-first conv: the JAX package
    applies it on the channels-last result, so softmax runs over the
    channels."""
    kw = dict(activation=activation, border_mode="same",
              dim_ordering="th")
    _check(JConv2D(4, 3, 3, name="t_conv_act", **kw),
           Convolution2D(4, 3, 3, input_shape=(3, 6, 5), device="cpu", **kw),
           (3, 6, 5), seed=2)


def test_conv_weight_layout_is_hwio():
    """W keeps the JAX package's HWIO layout, so weights cross unchanged."""
    conv = Convolution2D(6, 5, 3, input_shape=(28, 28, 1), device="cpu")
    assert tuple(conv.W.shape) == (5, 3, 1, 6)
    assert tuple(conv.b.shape) == (6,)
    with pytest.raises(ValueError, match="border_mode"):
        Convolution2D(6, 5, 5, border_mode="full")
