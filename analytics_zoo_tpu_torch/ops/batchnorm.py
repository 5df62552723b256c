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
update and get no gradient.

``group`` (a process group, passed while the Trainer's plan splits the
batch over the data axes; ``parallel.mesh.batch_group``): the statistics
are the global batch's, as the JAX package's are under ``jit`` over a
sharded batch.  The forward all-reduces ``sum(x)``, ``sum(x*x)`` and the
row count, the backward ``sum(dy)`` and ``sum(dy*xhat)`` before they are
divided by the global count; ``dgamma`` and ``dbeta`` stay this rank's
sums, which the trainer's gradient mean over the ranks completes.
Every rank then holds the same moving statistics.  Without a group no
collective runs.  Neither ``F.batch_norm`` nor
``nn.BatchNorm2d`` computes this function: their running variance is the
unbiased one and their momentum weighs the batch, not the average.
"""

from __future__ import annotations

import torch

from ..parallel._compat import group_sum


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


def _bn_forward(x, gamma, beta, eps: float, ch_axis: int, group=None):
    axes, n = _axes_and_count(x, ch_axis)
    x32 = x.float()
    s1 = torch.sum(x32, dim=axes)
    s2 = torch.sum(x32 * x32, dim=axes)
    if group is not None:
        # one all-reduce of both sums and the row count
        c = s1.numel()
        s1, s2, n = group_sum(torch.cat(
            [s1, s2, s1.new_full((1,), float(n))]), group).split([c, c, 1])
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    dt, bshape = x.dtype, _bshape(x, ch_axis)
    xhat = (x - mean.to(dt).reshape(bshape)) * inv.to(dt).reshape(bshape)
    out = xhat * gamma.to(dt).reshape(bshape) + beta.to(dt).reshape(bshape)
    return out, mean, var, xhat, inv, n


class BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, ch_axis, group=None):
        out, mean, var, xhat, inv, n = _bn_forward(x, gamma, beta, eps,
                                                   ch_axis, group)
        ctx.save_for_backward(xhat, inv, gamma)
        ctx.ch_axis = ch_axis
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, inv, gamma = ctx.saved_tensors
        ch_axis = ctx.ch_axis
        axes, _ = _axes_and_count(xhat, ch_axis)
        dy32 = dy.float()
        s_dy = torch.sum(dy32, dim=axes)
        s_dyx = torch.sum(dy32 * xhat.float(), dim=axes)
        g_dy, g_dyx = ((s_dy, s_dyx) if ctx.group is None else
                       group_sum(torch.stack([s_dy, s_dyx]),
                                 ctx.group).unbind(0))
        dt, bshape = dy.dtype, _bshape(dy, ch_axis)
        mean_dy = (g_dy / ctx.n).to(dt).reshape(bshape)
        mean_dyx = (g_dyx / ctx.n).to(dt).reshape(bshape)
        scale = (inv.to(dt).reshape(bshape)
                 * gamma.to(dt).reshape(bshape))
        dx = scale * (dy - mean_dy - xhat * mean_dyx)
        return (dx, s_dyx.to(gamma.dtype), s_dy.to(gamma.dtype), None, None,
                None)


def batch_norm_train(x, gamma, beta, eps: float, ch_axis: int, group=None):
    """Train-mode batch norm over every axis but ``ch_axis`` (a
    non-negative int), with the statistics of the global batch when
    ``group`` is given (module docstring).  Returns ``(out, mean,
    var)``: ``mean`` and ``var`` are the f32 per-channel batch
    statistics, without gradient."""
    return BatchNormTrain.apply(x, gamma, beta, float(eps), int(ch_axis),
                                group)


#: the A/B switch of the profile script: when True, BatchNormalization
#: takes :func:`batch_norm_train_naive` instead of the closed form; it is
#: read at every call
USE_NAIVE = False


def set_naive_bn(flag: bool):
    global USE_NAIVE
    USE_NAIVE = bool(flag)


def batch_norm_train_naive(x, gamma, beta, eps: float, ch_axis: int,
                           group=None):
    """The plain formulation (mean and variance of an f32 copy, autograd
    backward): the reference the closed form is held to.  With a
    ``group``, the two-pass sums are added over its ranks."""
    axes, n = _axes_and_count(x, ch_axis)
    bshape = _bshape(x, ch_axis)
    x32 = x.float()
    if group is None:
        mean = torch.mean(x32, dim=axes)
        var = torch.var(x32, dim=axes, unbiased=False)
    else:
        n = group_sum(x32.new_full((1,), float(n)), group)
        mean = group_sum(torch.sum(x32, dim=axes), group) / n
        centred = x32 - mean.reshape(bshape)
        var = group_sum(torch.sum(centred * centred, dim=axes), group) / n
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
