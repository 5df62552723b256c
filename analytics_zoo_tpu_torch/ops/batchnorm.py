"""Train-mode BatchNorm with the closed-form backward.

Counterpart of ``analytics_zoo_tpu/ops/batchnorm.py``, as a
``torch.autograd.Function`` over torch ops (the JAX module is ``jnp``
code that XLA compiles, not a Pallas kernel):

- **forward**: ``sum(x)`` and ``sum(x*x)`` accumulate in f32 for any
  input dtype, then ``var = max(E[x^2] - E[x]^2, 0)`` (the biased
  variance) and ``inv = rsqrt(var + eps)``; ``xhat`` and the output are
  computed in the input's dtype.
- **saved for backward**: ``xhat`` in the compute dtype (bf16 under mixed
  precision) and the per-channel ``inv`` and ``gamma``.
- **backward**: the closed form, whose only reductions are ``sum(dy)``
  and ``sum(dy*xhat)`` (which are also ``dbeta`` and ``dgamma``):
  ``dx = inv*gamma*(dy - mean(dy) - xhat*mean(dy*xhat))``.

The returned batch ``mean`` and ``var`` (f32) feed the moving-statistics
update and get no gradient.  Neither ``F.batch_norm`` nor
``nn.BatchNorm2d`` computes this function: their running variance is the
unbiased one and their momentum weighs the batch, not the average.
"""

from __future__ import annotations

import torch


def _axes_and_count(x, ch_axis: int):
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    n = 1
    for a in axes:
        n *= x.shape[a]
    return axes, n


def _bshape(x, ch_axis: int):
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    return shape


def _bn_forward(x, gamma, beta, eps: float, ch_axis: int):
    axes, n = _axes_and_count(x, ch_axis)
    x32 = x.float()
    s1 = torch.sum(x32, dim=axes)
    s2 = torch.sum(x32 * x32, dim=axes)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    dt, bshape = x.dtype, _bshape(x, ch_axis)
    xhat = (x - mean.to(dt).reshape(bshape)) * inv.to(dt).reshape(bshape)
    out = xhat * gamma.to(dt).reshape(bshape) + beta.to(dt).reshape(bshape)
    return out, mean, var, xhat, inv


class BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, ch_axis):
        out, mean, var, xhat, inv = _bn_forward(x, gamma, beta, eps, ch_axis)
        ctx.save_for_backward(xhat, inv, gamma)
        ctx.ch_axis = ch_axis
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, inv, gamma = ctx.saved_tensors
        ch_axis = ctx.ch_axis
        axes, n = _axes_and_count(xhat, ch_axis)
        dy32 = dy.float()
        s_dy = torch.sum(dy32, dim=axes)
        s_dyx = torch.sum(dy32 * xhat.float(), dim=axes)
        dt, bshape = dy.dtype, _bshape(dy, ch_axis)
        mean_dy = (s_dy / n).to(dt).reshape(bshape)
        mean_dyx = (s_dyx / n).to(dt).reshape(bshape)
        scale = (inv.to(dt).reshape(bshape)
                 * gamma.to(dt).reshape(bshape))
        dx = scale * (dy - mean_dy - xhat * mean_dyx)
        return dx, s_dyx.to(gamma.dtype), s_dy.to(gamma.dtype), None, None


def batch_norm_train(x, gamma, beta, eps: float, ch_axis: int):
    """Train-mode batch norm over every axis but ``ch_axis`` (a
    non-negative int).  Returns ``(out, mean, var)``: ``mean`` and
    ``var`` are the f32 per-channel batch statistics, without
    gradient."""
    return BatchNormTrain.apply(x, gamma, beta, float(eps), int(ch_axis))


#: the A/B switch of the profile script: when True, BatchNormalization
#: takes :func:`batch_norm_train_naive` instead of the closed form; it is
#: read at every call
USE_NAIVE = False


def set_naive_bn(flag: bool):
    global USE_NAIVE
    USE_NAIVE = bool(flag)


def batch_norm_train_naive(x, gamma, beta, eps: float, ch_axis: int):
    """The plain formulation (mean and variance of an f32 copy, autograd
    backward): the reference the closed form is held to."""
    axes, _ = _axes_and_count(x, ch_axis)
    bshape = _bshape(x, ch_axis)
    x32 = x.float()
    mean = torch.mean(x32, dim=axes)
    var = torch.var(x32, dim=axes, unbiased=False)
    dt = x.dtype
    inv = gamma.to(dt).reshape(bshape) * (
        1.0 / torch.sqrt(var.to(dt).reshape(bshape) + eps))
    out = (x - mean.to(dt).reshape(bshape)) * inv \
        + beta.to(dt).reshape(bshape)
    return out, mean.detach(), var.detach()


def batch_norm_inference(x, gamma, beta, mean, var, eps: float,
                         ch_axis: int):
    """Eval-mode batch norm with given (moving) statistics.  The inverse
    standard deviation is taken in f64 and rounded once to f32: the f32
    ``rsqrt`` of CUDA and of the CPU each miss the correctly rounded
    value for some inputs, and not for the same ones, so the card would
    not give the CPU's bits (an int8 net downstream then rounds its
    activations otherwise, and the difference grows layer by layer)."""
    dt, bshape = x.dtype, _bshape(x, ch_axis)
    inv = torch.rsqrt((var.float() + eps).double()).to(dt)
    return (x - mean.to(dt).reshape(bshape)) \
        * (inv.reshape(bshape) * gamma.to(dt).reshape(bshape)) \
        + beta.to(dt).reshape(bshape)
