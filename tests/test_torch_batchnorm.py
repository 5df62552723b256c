"""The port's BatchNorm (``ops/batchnorm.py`` and the BatchNormalization
layer) against the JAX package's on the same numpy inputs: the
counterpart of every test of ``tests/test_batchnorm_vjp.py``, each held
to the JAX function itself.

At f32 the forward, the batch statistics, the closed-form backward (held
to ``jax.vjp`` of the JAX custom VJP and of its naive form) and the
layer's moving statistics agree within 1e-5; at bf16 the output within
one bf16 rounding step of the JAX output's magnitude (2**-7 relative)
and the f32 statistics within 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops import batchnorm as jbn
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    BatchNormalization as JBatchNorm, Dense as JDense)
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.ops import batchnorm as tbn
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    BatchNormalization, Dense)
from analytics_zoo_tpu.core.module import name_scope as jname_scope

TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-3


def _inputs(shape, ch_axis, seed, loc=2.0, scale=3.0):
    rng = np.random.default_rng(seed)
    c = shape[ch_axis]
    return (rng.normal(loc, scale, shape).astype(np.float32),
            rng.normal(1.0, 0.2, c).astype(np.float32),
            rng.normal(0.0, 0.2, c).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("shape,ch_axis", [
    ((8, 6, 6, 16), 3),     # NHWC conv activation
    ((8, 16, 6, 6), 1),     # NCHW
    ((32, 24), 1),          # dense activation
])
def test_forward_matches_jax(shape, ch_axis):
    x, g, b, _ = _inputs(shape, ch_axis, 0)
    ref = jbn.batch_norm_train(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), EPS, ch_axis)
    got = tbn.batch_norm_train(*_t(x, g, b), EPS, ch_axis)
    for r, o, name in zip(ref, got, ["out", "mean", "var"]):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   err_msg=name, **TOL)
    # the plain version computes the same function
    naive = tbn.batch_norm_train_naive(*_t(x, g, b), EPS, ch_axis)
    for r, o in zip(ref, naive):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,ch_axis", [((8, 5, 5, 12), 3),
                                           ((6, 12, 4, 4), 1),
                                           ((16, 10), 1)])
def test_gradients_match_jax_vjp(shape, ch_axis):
    """dx, dgamma, dbeta of the closed form against jax.vjp of the JAX
    custom VJP (1e-5) and of the JAX naive form (autodiff), and the
    port's naive form (autograd) against the same."""
    x, g, b, cot = _inputs(shape, ch_axis, 1, loc=0.5, scale=2.0)
    args = (jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))

    def jvjp(fn):
        out, pull = jax.vjp(lambda *a: fn(*a, EPS, ch_axis)[0], *args)
        return [np.asarray(v) for v in pull(jnp.asarray(cot))]

    ref_custom = jvjp(jbn.batch_norm_train)
    ref_naive = jvjp(jbn.batch_norm_train_naive)
    for fn in (tbn.batch_norm_train, tbn.batch_norm_train_naive):
        xt, gt, bt = _t(x, g, b, grad=True)
        out, _, _ = fn(xt, gt, bt, EPS, ch_axis)
        got = torch.autograd.grad(out, (xt, gt, bt), torch.from_numpy(cot))
        for o, rc, rn, name in zip(got, ref_custom, ref_naive,
                                   ["dx", "dgamma", "dbeta"]):
            np.testing.assert_allclose(o.numpy(), rc, err_msg=name,
                                       **TOL)
            np.testing.assert_allclose(o.numpy(), rn, err_msg=name,
                                       rtol=2e-3, atol=2e-3)


def test_moving_stats_are_stop_gradient():
    """mean and var carry no gradient: a loss on them alone sees none,
    as JAX's (whose gradient is exactly 0)."""
    x = np.random.default_rng(2).normal(size=(16, 8)).astype(np.float32)
    gamma, beta = np.ones(8, np.float32), np.zeros(8, np.float32)
    jg = jax.grad(lambda xx: jnp.sum(sum(
        jbn.batch_norm_train(xx, gamma, beta, EPS, 1)[1:])))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jg), 0.0)
    xt, gt, bt = _t(x, gamma, beta, grad=True)
    out, mean, var = tbn.batch_norm_train(xt, gt, bt, EPS, 1)
    assert not mean.requires_grad and not var.requires_grad
    assert out.requires_grad


def test_bf16_input_f32_stats():
    """bf16 activations with mean >> std: the statistics accumulate in
    f32 (a bf16 sum would not survive), the output and the saved xhat are
    bf16; all against JAX's bf16 run on the same input, and the
    gradients finite and near the f32 ones."""
    rng = np.random.default_rng(3)
    shape, ch_axis = (16, 4, 4, 8), 3
    xf = rng.normal(10.0, 1.0, shape).astype(np.float32)
    xb = jnp.asarray(xf, jnp.bfloat16)
    gamma, beta = np.ones(8, np.float32), np.zeros(8, np.float32)
    jout, jmean, jvar = jbn.batch_norm_train(xb, gamma, beta, EPS, ch_axis)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    gt, bt = _t(gamma, beta, grad=True)
    out, mean, var = tbn.batch_norm_train(xt, gt, bt, EPS, ch_axis)
    assert out.dtype == torch.bfloat16
    assert mean.dtype == torch.float32 and var.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **TOL)
    ref = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * np.abs(ref).max())
    np.testing.assert_allclose(mean.numpy(), xf.mean(axis=(0, 1, 2)),
                               rtol=2e-2)
    out.float().pow(2).sum().backward()
    assert torch.isfinite(xt.grad.float()).all()
    assert torch.isfinite(gt.grad).all() and torch.isfinite(bt.grad).all()


def test_inference_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    gamma = rng.normal(1, 0.1, 6).astype(np.float32)
    beta = rng.normal(size=6).astype(np.float32)
    mean = rng.normal(size=6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    ref = jbn.batch_norm_inference(*map(jnp.asarray, (x, gamma, beta, mean,
                                                      var)), EPS, 1)
    got = tbn.batch_norm_inference(*_t(x, gamma, beta, mean, var), EPS, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = (x - mean) / np.sqrt(var + EPS) * gamma + beta
    np.testing.assert_allclose(got.numpy(), plain, **TOL)


def _layers(in_shape, dim_ordering=None, momentum=0.99):
    """The JAX layer with its params and state, and the port's built on
    the CPU with the same gamma and beta (off their init)."""
    jl = JBatchNorm(momentum=momentum, dim_ordering=dim_ordering,
                    input_shape=in_shape)
    tl = BatchNormalization(momentum=momentum, dim_ordering=dim_ordering,
                            input_shape=in_shape, device="cpu")
    params = jl.init_params(jax.random.PRNGKey(0), (None,) + in_shape)
    rng = np.random.default_rng(9)
    params = {k: (np.asarray(v) + rng.normal(0, 0.2, np.shape(v))).astype(
        np.float32) for k, v in params.items()}
    with torch.no_grad():
        for k, p in tl.params().items():
            p.copy_(torch.from_numpy(params[k]))
    return jl, tl, params, jl.init_state((None,) + in_shape)


@pytest.mark.parametrize("in_shape,dim_ordering", [
    ((5,), None), ((6, 6, 4), None), ((4, 6, 6), "th")])
def test_layer_state_update_matches_jax_apply(in_shape, dim_ordering):
    """Five training-mode calls on different batches: every output and
    the moving statistics and count after each against JAX ``apply``
    threading its state (a single step from the init would not tell the
    momentum conventions apart; five do); then eval mode on the
    debiased statistics."""
    jl, tl, params, jstate = _layers(in_shape, dim_ordering)
    assert tl.stateful and set(tl.state()) == set(jstate)
    assert tl.count.dtype == torch.float32 and tl.count.shape == ()
    rng = np.random.default_rng(5)
    tl.train()
    for step in range(5):
        x = rng.normal(step, 1.0 + step, (16,) + in_shape).astype(np.float32)
        jout, jstate = jl.apply(params, jstate, jnp.asarray(x),
                                training=True)
        out = tl(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   **TOL)
        for k, v in tl.state().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]),
                                       err_msg=k, **TOL)
    assert float(tl.count) == 5.0
    tl.eval()
    x = rng.normal(size=(8,) + in_shape).astype(np.float32)
    jout, same = jl.apply(params, jstate, jnp.asarray(x), training=False)
    assert same is jstate
    before = {k: v.clone() for k, v in tl.state().items()}
    with torch.no_grad():
        out = tl(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for k, v in tl.state().items():
        assert torch.equal(v, before[k]), k  # eval leaves the state


def test_inference_stats_are_debiased():
    """After one step eval normalizes with ~ the batch statistics (the
    debias), count = inf passes imported statistics through exactly and
    count = 0 falls back to the (0, 1) init: each against JAX."""
    rng = np.random.default_rng(6)
    x = rng.normal(3.0, 2.0, (512, 4)).astype(np.float32)
    jl, tl, params, jstate = _layers((4,))
    _, st1 = jl.apply(params, jstate, jnp.asarray(x), training=True)
    tl.train()
    tl(torch.from_numpy(x))
    assert float(tl.count) == 1.0 == float(st1["count"])
    tl.eval()
    xt = torch.from_numpy(x)
    cases = [st1,
             {"moving_mean": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
              "moving_var": np.array([1.0, 4.0, 9.0, 16.0], np.float32),
              "count": np.asarray(np.inf, np.float32)},
             jl.init_state((None, 4))]
    for state in cases:
        with torch.no_grad():
            for k, v in tl.state().items():
                v.copy_(torch.from_numpy(np.array(state[k])))
            out = tl(xt).numpy()
        ref = np.asarray(jl.apply(params, state, jnp.asarray(x),
                                  training=False)[0])
        np.testing.assert_allclose(out, ref, **TOL)
    # the inf case is the exact pass-through of the imported statistics
    mean, var = tl.debiased_statistics()
    assert torch.equal(mean, torch.zeros(4)) and torch.equal(
        var, torch.ones(4))  # the last case: count 0, the init
    with torch.no_grad():
        tl.count.fill_(float("inf"))
        tl.moving_mean.copy_(torch.tensor([1.0, 2.0, 3.0, 4.0]))
        tl.moving_var.copy_(torch.tensor([1.0, 4.0, 9.0, 16.0]))
    mean, var = tl.debiased_statistics()
    assert torch.equal(mean, tl.moving_mean)
    assert torch.equal(var, tl.moving_var)


def test_naive_switch_computes_the_same_layer():
    """``set_naive_bn(True)`` (the profile script's A/B) swaps the layer's
    training core for the plain version: the same outputs, gradients and
    state within 1e-5."""
    x = np.random.default_rng(7).normal(1.0, 2.0, (32, 6, 6, 8)).astype(
        np.float32)
    runs = []
    for naive in (False, True):
        tbn.set_naive_bn(naive)
        try:
            _, tl, _, _ = _layers((6, 6, 8))
            tl.train()
            xt = torch.from_numpy(x).requires_grad_()
            out = tl(xt)
            out.pow(2).sum().backward()
            runs.append([out.detach(), xt.grad, tl.gamma.grad,
                         tl.moving_var.clone()])
        finally:
            tbn.set_naive_bn(False)
    assert not tbn.USE_NAIVE
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _deep_bn_stack(seq, layers):
    seq.add(layers[1](32, activation="relu", input_shape=(16,)))
    for _ in range(6):
        seq.add(layers[0]())
        seq.add(layers[1](32, activation="relu"))
    seq.add(layers[1](4, activation="softmax"))
    return seq


def _blobs():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 3.0, (4, 16))
    y = rng.integers(0, 4, 512).astype(np.int32)
    x = (centers[y] + rng.normal(0, 0.5, (512, 16))).astype(np.float32)
    return x, y


def test_deep_bn_stack_short_training_evaluates_sanely():
    """tests/test_batchnorm_vjp.py's deep stack (6 BatchNormalization
    layers) on the port: ~96 adam steps must evaluate near their training
    accuracy, which needs the debiased moving statistics."""
    x, y = _blobs()
    m = _deep_bn_stack(Sequential(device="cpu"), (BatchNormalization, Dense))
    m.compile({"name": "adam", "lr": 2e-3},
              "sparse_categorical_crossentropy", metrics=["accuracy"])
    hist = m.fit(x, y, batch_size=64, nb_epoch=12)
    assert hist["loss"][-1] < 0.2, hist["loss"][-1]
    acc = m.evaluate(x, y, batch_size=128)["accuracy"]
    assert acc > 0.9, f"deep-BN eval collapsed: {acc}"
    counts = {float(l.count) for l in m.layers
              if isinstance(l, BatchNormalization)}
    assert counts == {96.0}


def test_deep_bn_stack_follows_jax():
    """The same stack from the same weights: 8 sgd-momentum steps (no
    shuffle) give per-step losses, weights and every BN's moving
    statistics within 1e-5 of the JAX package's fit, and evaluate within
    1e-5."""
    x, y = _blobs()
    with jname_scope("bnstack"):
        jm = _deep_bn_stack(JSequential(), (JBatchNorm, JDense))
    with name_scope("bnstack"):
        tm = _deep_bn_stack(Sequential(device="cpu"),
                            (BatchNormalization, Dense))
    opt = {"name": "sgd", "lr": 0.05, "momentum": 0.9}
    jm.compile(opt, "sparse_categorical_crossentropy")
    tm.compile(opt, "sparse_categorical_crossentropy")
    tm.set_weights(jm.get_weights())
    jh = jm.fit(x, y, batch_size=64, nb_epoch=1, shuffle=False)
    th = tm.fit(x, y, batch_size=64, nb_epoch=1, shuffle=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], **TOL)
    jstate = jax.device_get(jm.trainer.state.model_state)
    from analytics_zoo_tpu_torch.models import to_jax_state
    tstate = to_jax_state(tm)
    assert set(tstate) == set(jstate) and len(tstate) == 6
    for name, leaves in jstate.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tstate[name][k], np.asarray(v),
                                       err_msg=f"{name}/{k}", **TOL)
    for name, leaves in jm.get_weights().items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tm.get_weights()[name][k],
                                       np.asarray(v), **TOL)
    np.testing.assert_allclose(tm.evaluate(x, y, batch_size=128)["loss"],
                               jm.evaluate(x, y, batch_size=128)["loss"],
                               **TOL)
