"""The port's autograd DSL against the JAX package's, on the CPU.

Counterpart of ``tests/test_autograd.py``.  Every op of
``ops/elementwise.py`` (through a Variable operator or the ``A.*``
namespace) builds one graph in each package from the same expression;
both run on the same numpy inputs: the Variable shapes are equal, the
values within 1e-6 (atol and rtol; NaN where ``jnp.take`` fills), and
the input gradients of ``sum(out * cotangent)`` within 1e-5 of
``jax.grad``, also where inputs tie (small integers).  ``Parameter`` models train 5 sgd and adam steps from the
JAX package's weights with losses and weights within 1e-5; a ``Lambda``
in a ``Sequential`` and both ``CustomLoss`` forms in ``fit`` give the
JAX package's predictions (1e-6) and losses (1e-5); ``CustomLoss``'s
forward and backward its values (1e-6).  Weight sharing, a frozen
``Parameter``, and ``save_model``/``load_model`` of a graph with op,
constant and Parameter nodes (predict within 1e-6) close the file.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.core.graph import GraphModule as JGraphModule
from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.pipeline.api import autograd as JA
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu_torch.core.graph import GraphModule
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.ops import elementwise as E
from analytics_zoo_tpu_torch.pipeline.api import autograd as A
from analytics_zoo_tpu_torch.pipeline.api.keras import (Model, Sequential,
                                                        load_model)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

VALUE_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)

SHAPES = {"x": (3, 4), "y": (3, 4), "a": (5, 4), "b": (4, 6),
          "s": (1, 4), "z": (3, 4)}


def _feeds(names, batch=2):
    rng = np.random.default_rng(0)
    out = []
    for n in names:
        shape = (batch,) + SHAPES[n]
        out.append((rng.uniform(0.5, 2.0, shape) if n == "y"
                    # small integers: ties and exact zeros
                    else rng.integers(-2, 3, shape) if n == "z"
                    else rng.normal(size=shape)).astype(np.float32))
    return out


# (case id, input names, expression over (A, *inputs))
CASES = [
    ("add", "xy", lambda A, x, y: x + y),
    ("sub", "xy", lambda A, x, y: x - y),
    ("mul", "xy", lambda A, x, y: x * y),
    ("div", "xy", lambda A, x, y: x / y),
    ("radd_const", "x", lambda A, x: 2.0 + x),
    ("rsub_const", "x", lambda A, x: 3.0 - x),
    ("rmul_const", "x", lambda A, x: 0.5 * x),
    ("rtruediv_const", "y", lambda A, y: 1.0 / y),
    ("neg", "x", lambda A, x: -x),
    ("pow_operator", "y", lambda A, y: y ** 3),
    ("maximum", "xy", lambda A, x, y: A.maximum(x, y)),
    ("minimum", "xy", lambda A, x, y: A.minimum(x, y)),
    ("broadcast_const", "x",
     lambda A, x: x * A.constant(np.arange(4, dtype=np.float32))),
    ("abs", "x", lambda A, x: A.abs(x)),
    ("square", "x", lambda A, x: A.square(x)),
    ("sqrt", "y", lambda A, y: A.sqrt(y)),
    ("log", "y", lambda A, y: A.log(y)),
    ("exp", "x", lambda A, x: A.exp(x)),
    ("pow", "y", lambda A, y: A.pow(y, 2.5)),
    ("softsign", "x", lambda A, x: A.softsign(x)),
    ("softplus", "x", lambda A, x: A.softplus(x)),
    ("clip", "x", lambda A, x: A.clip(x, -0.5, 0.5)),
    ("clip_min_only", "x", lambda A, x: A.clip(x, min=0.0)),
    ("contiguous", "x", lambda A, x: A.contiguous(x)),
    ("relu", "x", lambda A, x: A.relu(x)),
    ("sigmoid", "x", lambda A, x: A.sigmoid(x)),
    ("tanh", "x", lambda A, x: A.tanh(x)),
    ("epsilon", "x", lambda A, x: x + A.epsilon()),
    ("sum_axis", "x", lambda A, x: A.sum(x, axis=1)),
    ("sum_all", "x", lambda A, x: A.sum(x)),
    ("sum_keepdims", "x", lambda A, x: A.sum(x, axis=2, keepdims=True)),
    ("sum_axes", "x", lambda A, x: A.sum(x, axis=(1, 2))),
    ("mean_axis", "x", lambda A, x: A.mean(x, axis=1)),
    ("mean_negative_axis", "x",
     lambda A, x: A.mean(x, axis=-1, keepdims=True)),
    ("max_axis", "x", lambda A, x: A.max(x, axis=1)),
    ("max_all", "x", lambda A, x: A.max(x)),
    ("min_keepdims", "x", lambda A, x: A.min(x, axis=2, keepdims=True)),
    ("expand_dims", "x", lambda A, x: A.expand_dims(x, 1)),
    ("expand_dims_last", "x", lambda A, x: A.expand_dims(x, -1)),
    ("squeeze", "s", lambda A, s: A.squeeze(s, 1)),
    ("squeeze_method", "s", lambda A, s: s.squeeze(1)),
    ("stack", "xy", lambda A, x, y: A.stack([x, y], axis=1)),
    ("stack_last", "xy", lambda A, x, y: A.stack([x, y], axis=-1)),
    ("concat", "xy", lambda A, x, y: A.concat([x, y], axis=-1)),
    ("concat_axis1", "xy", lambda A, x, y: A.concat([x, y], axis=1)),
    ("slice", "x", lambda A, x: x.slice(2, 1, 2)),
    ("slice_fn", "x", lambda A, x: A.slice(x, 1, 0, 2)),
    ("slice_past_end", "x", lambda A, x: x.slice(2, 3, 3)),
    ("index_select", "x", lambda A, x: x.index_select(2, 3)),
    ("index_select_negative", "x", lambda A, x: A.index_select(x, 1, -1)),
    ("index_select_out_of_range", "x", lambda A, x: x.index_select(2, 7)),
    ("getitem_int", "x", lambda A, x: x[:, 0]),
    ("getitem_slice", "x", lambda A, x: x[:, 1:3]),
    ("getitem_step", "x", lambda A, x: x[:, :, ::2]),
    ("getitem_reversed", "x", lambda A, x: x[:, ::-1]),
    ("getitem_int_pair", "x", lambda A, x: x[:, 1, -1]),
    ("mm", "ab", lambda A, a, b: A.mm(a, b)),
    ("batch_dot", "ab", lambda A, a, b: A.batch_dot(a, b)),
    ("l2_normalize", "x", lambda A, x: A.l2_normalize(x, axis=-1)),
    ("l2_normalize_axis1", "x", lambda A, x: A.l2_normalize(x, axis=1)),
    # ties take jnp's gradient split (maximum, clip and max share it)
    ("relu_ties", "z", lambda A, z: A.relu(z)),
    ("clip_ties", "z", lambda A, z: A.clip(z, -1.0, 1.0)),
    ("maximum_ties", "zx", lambda A, z, x: A.maximum(z, A.abs(x) * 0.0)),
    ("max_ties", "z", lambda A, z: A.max(z, axis=2)),
    ("min_ties_all", "z", lambda A, z: A.min(z)),
    ("expression", "xy",
     lambda A, x, y: A.mean(A.square(A.log(y) - A.softplus(x)), axis=2)
     + A.sum(A.abs(x[:, 0]), axis=1, keepdims=True)),
]


def _jax_run(build, names, feeds):
    ins = [JA.Input(SHAPES[n]) for n in names]
    out = build(JA, *ins)
    g = JGraphModule(ins, out)
    params, state = g.init(jax.random.PRNGKey(0))

    def f(*xs):
        return g.apply(params, state, list(xs))[0]

    val = np.asarray(f(*feeds))
    ct = np.random.default_rng(1).normal(size=val.shape).astype(np.float32)
    ct = np.where(np.isnan(val), 0.0, ct).astype(np.float32)
    grads = jax.grad(lambda *xs: jnp.sum(jnp.where(
        jnp.isnan(f(*xs)), 0.0, f(*xs) * ct)),
        argnums=tuple(range(len(feeds))))(*feeds)
    return out.shape, val, ct, [np.asarray(g_) for g_ in grads]


def _torch_run(build, names, feeds, ct):
    ins = [A.Input(SHAPES[n]) for n in names]
    out = build(A, *ins)
    g = GraphModule(ins, out)
    g.build(None, torch.Generator("cpu").manual_seed(0))
    xs = [torch.from_numpy(f).requires_grad_() for f in feeds]
    val = g(xs)
    ct_t = torch.from_numpy(ct)
    loss = torch.sum(torch.where(torch.isnan(val), 0.0, val * ct_t))
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    return out.shape, val.detach().numpy(), [
        np.zeros_like(f) if g_ is None else g_.numpy()
        for f, g_ in zip(feeds, grads)]


@pytest.mark.parametrize("build,names", [(c[2], c[1]) for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_value_and_gradient_match_jax(build, names):
    feeds = _feeds(names)
    jshape, jval, ct, jgrads = _jax_run(build, names, feeds)
    tshape, tval, tgrads = _torch_run(build, names, feeds, ct)
    assert tshape == jshape
    assert tval.shape == jval.shape and tval.dtype == jval.dtype
    np.testing.assert_allclose(tval, jval, equal_nan=True, **VALUE_TOL)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg, jg, **GRAD_TOL)


def test_ops_run_eagerly_on_tensors_and_numbers():
    """On tensors (and numbers beside them) an op runs now, as the JAX
    package's ops run on arrays: what Lambda and CustomLoss functions
    see."""
    x, y = _feeds("xy")
    got = A.mean(A.abs(torch.from_numpy(x) - torch.from_numpy(y)), axis=1)
    ref = JA.mean(JA.abs(jnp.asarray(x) - jnp.asarray(y)), axis=1)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VALUE_TOL)
    np.testing.assert_allclose(
        A.maximum(torch.from_numpy(x), 0.25).numpy(),
        np.asarray(JA.maximum(jnp.asarray(x), 0.25)), **VALUE_TOL)
    assert A.epsilon() == JA.epsilon() == 1e-7
    assert sorted(A.__all__) == sorted(JA.__all__)
    assert all(hasattr(A, n) for n in JA.__all__ + ["LambdaLayer"])


def test_getitem_config_is_json_and_round_trips():
    item = (slice(None), 1, slice(0, None, -1))
    enc = E._encode_item(item)
    assert enc == [["slice", None, None, None], 1, ["slice", 0, None, -1]]
    assert E._decode_item(enc) == item
    from analytics_zoo_tpu.ops import elementwise as JE
    assert enc == JE._encode_item(item)


def _both(build, scope):
    """``build(A, Dense, Model)`` in each package under ``scope``; the
    port's model gets the JAX model's weights."""
    with jname_scope(scope):
        jm = build(JA, JDense, JModel)
    with name_scope(scope):
        tm = build(A, Dense, lambda **k: Model(**k, device="cpu"))
    tm.set_weights(jax.device_get(jm.get_weights()))
    return jm, tm


def _param_model(A, D, M):
    x = A.Input((4,), name="px")
    w = A.Parameter((4, 2), name="pw")
    bias = A.Parameter((2,), init_method="zero", name="pb")
    h = D(3, activation="tanh")(x)
    return M(input=x, output=A.mm(x, w) + bias + A.sum(h, axis=1,
                                                       keepdims=True))


@pytest.mark.parametrize("optimizer", [{"name": "sgd", "lr": 0.5},
                                       {"name": "adam", "lr": 0.05}],
                         ids=["sgd", "adam"])
def test_parameter_trains_like_jax(optimizer):
    """y = x @ W + b + sum(dense(x)) with W, b Parameters: 5 steps from
    the same weights give the JAX package's losses and weights."""
    jm, tm = _both(_param_model, "param")
    init = tm.get_weights()
    assert set(init) == {"pw", "pb", "param/dense_1"}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    y = (x @ rng.normal(size=(4, 2))).astype(np.float32)
    for m in (jm, tm):
        m.compile(optimizer=optimizer, loss="mse")
    ref = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    assert len(out) == 5
    np.testing.assert_allclose(out, ref, **TRAIN_TOL)
    assert not np.array_equal(tm.get_weights()["pw"]["weight"],
                              init["pw"]["weight"])
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for k, v in leaves.items():
            np.testing.assert_allclose(v, jw[layer][k], **TRAIN_TOL)


def test_parameter_recovers_a_linear_map():
    """The reference's KerasParameter use: W of y = x @ W learned by sgd
    (the JAX test's plan)."""
    x = A.Input((4,), name="lx")
    model = Model(input=x, output=A.mm(x, A.Parameter((4, 2), name="lw")),
                  device="cpu")
    model.compile(optimizer={"name": "sgd", "lr": 0.5}, loss="mse")
    rng = np.random.default_rng(0)
    xv = rng.normal(size=(256, 4)).astype(np.float32)
    true_w = rng.normal(size=(4, 2)).astype(np.float32)
    hist = model.fit(xv, xv @ true_w, batch_size=64, nb_epoch=30)
    assert hist["loss"][-1] < 1e-3
    np.testing.assert_allclose(model.get_weights()["lw"]["weight"], true_w,
                               atol=0.05)


def test_lambda_in_sequential_matches_jax():
    """The same function (A ops run eagerly on each package's arrays)
    in a Sequential: predictions within 1e-6, the shape inferred."""
    fn = lambda t: A.tanh(t) * 2.0  # noqa: E731
    jfn = lambda t: JA.tanh(t) * 2.0  # noqa: E731
    with jname_scope("lam"):
        jm = JSequential()
        jm.add(JDense(8, input_shape=(4,)))
        jm.add(JA.Lambda(jfn))
    with name_scope("lam"):
        tm = Sequential(device="cpu")
        tm.add(Dense(8, input_shape=(4,)))
        tm.add(A.LambdaLayer(fn))
    tm.set_weights(jax.device_get(jm.get_weights()))
    assert tm.to_graph().output_shapes == [(None, 8)]
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    out = tm.predict(x, batch_size=8)
    np.testing.assert_allclose(out, np.asarray(jm.predict(x, batch_size=8)),
                               **VALUE_TOL)
    assert np.all(np.abs(out) <= 2.0)
    with pytest.raises(ValueError, match="function"):
        A.Lambda()


def _loss_forms():
    def expr(A):
        yt, yp = A.Input((1,), name="yt"), A.Input((1,), name="yp")
        return A.CustomLoss.from_variables(
            yt, yp, A.mean(A.square(yp - yt), axis=1))

    return {
        "lambda": (A.CustomLoss(lambda t, p: A.mean(A.abs(p - t), axis=1)),
                   JA.CustomLoss(lambda t, p: JA.mean(JA.abs(p - t),
                                                      axis=1))),
        "scalar": (A.CustomLoss(lambda t, p: A.mean(A.abs(p - t))),
                   JA.CustomLoss(lambda t, p: JA.mean(JA.abs(p - t)))),
        "from_variables": (expr(A), expr(JA)),
    }


@pytest.mark.parametrize("form", ["lambda", "scalar", "from_variables"])
def test_custom_loss_in_fit_matches_jax(form):
    tloss, jloss = _loss_forms()[form]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = x.sum(axis=1, keepdims=True).astype(np.float32)
    with jname_scope("closs"):
        jm = JSequential()
        jm.add(JDense(1, input_shape=(3,)))
    with name_scope("closs"):
        tm = Sequential(device="cpu")
        tm.add(Dense(1, input_shape=(3,)))
    tm.set_weights(jax.device_get(jm.get_weights()))
    jm.compile(optimizer={"name": "sgd", "lr": 0.1}, loss=jloss)
    tm.compile(optimizer={"name": "sgd", "lr": 0.1}, loss=tloss)
    ref = jm.fit(x, y, batch_size=16, nb_epoch=3, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=16, nb_epoch=3, shuffle=False)["loss"]
    np.testing.assert_allclose(out, ref, **TRAIN_TOL)
    assert out[-1] < out[0]


def test_custom_loss_forward_and_backward_match_jax():
    rng = np.random.default_rng(2)
    yt = rng.normal(size=(4, 1)).astype(np.float32)
    yp = rng.normal(size=(4, 1)).astype(np.float32)
    for form, (tloss, jloss) in _loss_forms().items():
        assert tloss.forward(yt, yp) == pytest.approx(
            jloss.forward(yt, yp), rel=1e-6), form
        np.testing.assert_allclose(tloss.backward(yt, yp),
                                   jloss.backward(yt, yp), **VALUE_TOL)
    # the JAX test's closed form: d mean((yp - yt)^2) = 2 (yp - yt) / n
    y_true = A.Input((4,), name="yt")
    y_pred = A.Input((4,), name="yp")
    loss = A.CustomLoss.from_variables(
        y_true, y_pred, A.mean(A.square(y_pred - y_true), axis=1))
    ones, zeros = np.ones((2, 4), np.float32), np.zeros((2, 4), np.float32)
    assert loss.forward(ones, zeros) == pytest.approx(1.0)
    np.testing.assert_allclose(loss.backward(ones, zeros),
                               2 * (zeros - ones) / 8, rtol=1e-6)


def test_custom_loss_graph_runs_at_inference_like_jax():
    """A Dropout inside a ``from_variables`` loss drops nothing: the JAX
    package applies the loss graph with ``training=False``, and the
    port's forward and backward give its values (1e-6)."""
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        Dropout as JDropout)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dropout

    def expr(A, drop):
        yt, yp = A.Input((4,), name="yt"), A.Input((4,), name="yp")
        return A.CustomLoss.from_variables(
            yt, yp, A.mean(A.square(drop(0.5)(yp - yt)), axis=1))

    rng = np.random.default_rng(3)
    yt = rng.normal(size=(8, 4)).astype(np.float32)
    yp = rng.normal(size=(8, 4)).astype(np.float32)
    tloss, jloss = expr(A, Dropout), expr(JA, JDropout)
    assert tloss.forward(yt, yp) == pytest.approx(jloss.forward(yt, yp),
                                                  rel=1e-6)
    assert tloss.forward(yt, yp) == pytest.approx(
        float(np.mean((yp - yt) ** 2)), rel=1e-6)
    np.testing.assert_allclose(tloss.backward(yt, yp),
                               jloss.backward(yt, yp), **VALUE_TOL)


def test_weight_sharing_two_calls_one_param():
    shared = Dense(4, name="shared_dense")
    a = A.Input((4,), name="in_a")
    model = Model(input=a, output=shared(shared(a)), device="cpu")
    g = model.to_graph()
    assert sum(1 for layer in g.layers if layer.name == "shared_dense") == 1
    assert list(model.get_weights()) == ["shared_dense"]


def test_frozen_parameter_not_updated():
    """trainable=False keeps a Parameter where it is through fit, and
    freeze()/unfreeze() by name apply to a Parameter as to a layer."""
    x = A.Input((4,), name="fx")
    w_frozen = A.ParameterLayer(shape=(4, 2), init_method="one",
                                trainable=False, name="w_frozen")
    w_live = A.Parameter((4, 2), init_method="one", name="w_live")
    wv = A.Variable(w_frozen, (), (4, 2), name=w_frozen.name)
    model = Model(input=x, output=A.mm(x, wv) + A.mm(x, w_live),
                  device="cpu")
    model.compile(optimizer={"name": "sgd", "lr": 0.5}, loss="mse")
    xv = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    yv = np.zeros((64, 2), dtype=np.float32)
    model.fit(xv, yv, batch_size=32, nb_epoch=3)
    w = model.get_weights()
    np.testing.assert_array_equal(w["w_frozen"]["weight"], np.ones((4, 2)))
    assert not np.array_equal(w["w_live"]["weight"], np.ones((4, 2)))
    assert model.frozen_layer_names() == ["w_frozen"]
    model.freeze("w_live")
    before = model.get_weights()["w_live"]["weight"]
    model.fit(xv, yv, batch_size=32, nb_epoch=1)
    np.testing.assert_array_equal(model.get_weights()["w_live"]["weight"],
                                  before)


def _op_graph(A, D, M):
    x, y = A.Input((3, 4), name="gx"), A.Input((3, 4), name="gy")
    p = A.Parameter((4,), name="gp")
    h = D(4, activation="tanh")(A.exp(x) * 0.5 + y[:, ::-1])
    out = A.concat([A.sum(h * p, axis=1), x.index_select(1, 2),
                    A.l2_normalize(y.slice(1, 0, 1).squeeze(1))], axis=-1)
    return M(input=[x, y], output=A.clip(out, -5.0, 5.0) - A.constant(
        np.full((12,), 0.25, np.float32)))


def test_op_graph_save_load_and_config(tmp_path):
    """A graph of op, constant and Parameter nodes: predictions of the
    JAX package's within 1e-6, and after save_model/load_model within
    1e-6 of the saved model's; the config holds each op's name and
    JSON arguments; the summary lists the op nodes."""
    jm, tm = _both(_op_graph, "opg")
    x, y = _feeds("xy", batch=8)
    ref = np.asarray(jm.predict([x, y], batch_size=8))
    out = tm.predict([x, y], batch_size=8)
    np.testing.assert_allclose(out, ref, **VALUE_TOL)
    ops = [n["layer"]["config"]["op"] for n in tm.get_config()["nodes"]
           if n["layer"]["class_name"] == "OpLayer"]
    assert {"exp", "mul", "getitem", "concat", "index_select", "slice",
            "squeeze", "l2_normalize", "clip", "sub"} <= set(ops)
    tm.compile(optimizer="sgd", loss="mse")
    tm.save_model(str(tmp_path / "opg"))
    loaded = load_model(str(tmp_path / "opg"), device="cpu")
    np.testing.assert_allclose(loaded.predict([x, y], batch_size=8), out,
                               **VALUE_TOL)
    np.testing.assert_array_equal(loaded.get_weights()["gp"]["weight"],
                                  tm.get_weights()["gp"]["weight"])
    assert "OpLayer" in tm.summary() and "ParameterLayer" in tm.summary()
