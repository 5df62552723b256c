"""The port's recurrent layers against the JAX package's, on the CPU.

SimpleRNN, LSTM and GRU over every ``go_backwards`` x
``return_sequences`` pair and both the default ``hard_sigmoid`` and the
``sigmoid`` inner activation; ConvLSTM2D over the same pairs; and
Bidirectional in all four merge modes.  Each layer takes the JAX layer's
initial weights (the Bidirectional's nested ``forward``/``backward``
trees included) and the same numpy input: outputs within 1e-5 (atol and
rtol), and the gradients of ``sum(out * w)`` for a random ``w`` with
respect to every parameter and to the input within 1e-5 of
``jax.grad``'s.  An LSTM whose pre-activations sit exactly on the
hard-sigmoid's bounds (+-2.5) pins the tie gradient (half of the slope,
as ``jnp.clip`` gives it).  Configs round-trip (``get_config`` /
``from_config``), and a Sequential of recurrent layers moves its weights
with ``from_jax_params``/``to_jax_params`` and keeps them through
``save_model``/``load_model``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.models import from_jax_params, to_jax_params
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential, load_model
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)
B = 3


def _assign(layer_params, tree):
    """Copy a JAX param tree into a layer's (possibly nested) params."""
    with torch.no_grad():
        for key, t in layer_params.items():
            if isinstance(t, dict):
                _assign(t, tree[key])
            else:
                t.copy_(torch.from_numpy(np.array(tree[key])))


def _check(jlayer, tlayer, shape, seed=0, params=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B,) + shape).astype(np.float32)
    jp, js = jlayer.init(jax.random.PRNGKey(seed), (B,) + shape)
    if params is not None:
        jp = params
    _assign(tlayer.params(), jax.device_get(jp))
    jout, _ = jlayer.apply(jp, js, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = tlayer(xt)
    assert tuple(tout.shape) == jout.shape
    assert tuple(tlayer.compute_output_shape((B,) + shape)) == jout.shape
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    w = rng.normal(size=jout.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jlayer.apply(p, js, xx)[0] * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    names = [n for n, _ in tlayer.named_parameters()]
    grads = torch.autograd.grad(torch.sum(tout * torch.from_numpy(w)),
                                [xt] + list(tlayer.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    flat = dict(zip(names, grads[1:]))
    jflat = {"/".join(str(k.key) for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jgp))[0]}
    renamed = {n.replace("backward_layer.", "backward/").replace(
        "layer.", "forward/"): g for n, g in flat.items()}
    assert set(renamed) == set(jflat)
    for name, g in renamed.items():
        np.testing.assert_allclose(g.numpy(), jflat[name], **TOL,
                                   err_msg=name)
    return tout


RNN_CASES = [(cls, inner, back, seq)
             for cls in ("SimpleRNN", "LSTM", "GRU")
             for inner in (("hard_sigmoid", "sigmoid")
                           if cls != "SimpleRNN" else ("hard_sigmoid",))
             for back in (False, True) for seq in (False, True)]


@pytest.mark.parametrize("cls,inner,back,seq", RNN_CASES)
def test_rnn_forward_and_gradients_match_jax(cls, inner, back, seq):
    kw = dict(return_sequences=seq, go_backwards=back)
    if cls != "SimpleRNN":
        kw["inner_activation"] = inner
    _check(getattr(JL, cls)(5, **kw),
           getattr(TL, cls)(5, input_shape=(7, 4), device="cpu", **kw),
           (7, 4))


@pytest.mark.parametrize("back,seq", [(False, False), (False, True),
                                      (True, False), (True, True)])
def test_convlstm2d_forward_and_gradients_match_jax(back, seq):
    kw = dict(return_sequences=seq, go_backwards=back)
    _check(JL.ConvLSTM2D(3, 3, **kw),
           TL.ConvLSTM2D(3, 3, input_shape=(4, 5, 5, 2), device="cpu",
                         **kw), (4, 5, 5, 2))


def test_convlstm2d_strided_input_matches_jax():
    _check(JL.ConvLSTM2D(2, 3, subsample=2, inner_activation="sigmoid"),
           TL.ConvLSTM2D(2, 3, subsample=2, inner_activation="sigmoid",
                         input_shape=(3, 6, 6, 2), device="cpu"),
           (3, 6, 6, 2))


@pytest.mark.parametrize("merge", ["concat", "sum", "mul", "ave"])
def test_bidirectional_merge_modes_match_jax(merge):
    jl = JL.Bidirectional(JL.LSTM(4, return_sequences=True),
                          merge_mode=merge)
    tl = TL.Bidirectional(TL.LSTM(4, return_sequences=True),
                          merge_mode=merge, input_shape=(6, 3),
                          device="cpu")
    assert tl.backward_layer.go_backwards and not tl.layer.go_backwards
    _check(jl, tl, (6, 3))


def test_bidirectional_gru_last_step_matches_jax():
    _check(JL.Bidirectional(JL.GRU(4, go_backwards=True)),
           TL.Bidirectional(TL.GRU(4, go_backwards=True), input_shape=(6, 3),
                            device="cpu"), (6, 3))


def test_lstm_gradient_at_hard_sigmoid_ties_matches_jax():
    """W = U = 0 keeps every pre-activation exactly at b, which puts
    gates on the hard sigmoid's bounds (+-2.5), where ``jnp.clip`` passes
    half the slope (0.1; ``torch.clamp`` passes 0.2).  The JAX side runs
    op by op (``jax.disable_jit``): compiled, XLA on the CPU contracts
    ``0.2*x + 0.5`` into one fused multiply-add, which lands 7.5e-9 off
    the bound, so there is no tie to compare there."""
    n, d = 3, 2
    # gates [i, f, c, o] of 3 units; c nonzero so every gate matters
    b = np.array([2.5, -2.5, 0.7, 2.5, 2.5, -2.5, 0.4, -0.3, 0.6, 0.3, 2.5,
                  -2.5], np.float32)
    params = {"W": jnp.zeros((d, 4 * n)), "U": jnp.zeros((n, 4 * n)),
              "b": jnp.asarray(b)}
    with jax.disable_jit():
        out = _check(JL.LSTM(n, return_sequences=True),
                     TL.LSTM(n, return_sequences=True, input_shape=(5, d),
                             device="cpu"), (5, d), params=params)
    assert out.shape == (B, 5, n)
    # the half slope at a tie: one gate alone at a bound
    x = torch.tensor([-2.5, 2.5, 0.0], requires_grad=True)
    TL.LSTM(1, device="cpu", input_shape=(1, 1)).inner_activation(x).sum(
    ).backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.1, 0.1, 0.2], rtol=1e-6)


@pytest.mark.parametrize("layer", [
    lambda: TL.SimpleRNN(3, go_backwards=True),
    lambda: TL.LSTM(3, inner_activation="sigmoid", return_sequences=True),
    lambda: TL.GRU(3, activation="relu"),
    lambda: TL.ConvLSTM2D(2, 3, border_mode="same", subsample=1),
    lambda: TL.Bidirectional(TL.GRU(3, return_sequences=True),
                             merge_mode="ave")])
def test_recurrent_configs_round_trip(layer):
    a = layer()
    cfg = a.get_config()
    b = type(a).from_config(cfg)
    assert b.get_config() == cfg
    if isinstance(a, TL.SimpleRNN):
        assert "inner_activation" not in cfg


def test_recurrent_sequential_moves_weights_and_saves(tmp_path):
    def build(pkg, seq_cls, **kw):
        m = seq_cls(**kw)
        m.add(pkg.Bidirectional(pkg.LSTM(4, return_sequences=True),
                                input_shape=(6, 3), name="bi"))
        m.add(pkg.GRU(5, name="gru"))
        m.add(pkg.Dense(2, name="out"))
        return m

    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    jm = build(JL, JSeq)
    tm = build(TL, Sequential, device="cpu")
    jw = jax.device_get(jm.get_weights())
    from_jax_params(tm, jw)
    back = to_jax_params(tm)
    assert back["bi"]["forward"]["U"].shape == (4, 16)
    for path, v in jax.tree_util.tree_flatten_with_path(jw)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, v)
    x = np.random.default_rng(1).normal(size=(4, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.predict(x, batch_size=4),
                               np.asarray(jm.predict(x, batch_size=4)),
                               **TOL)
    tm.save_model(str(tmp_path / "m"))
    loaded = load_model(str(tmp_path / "m"), device="cpu")
    np.testing.assert_allclose(loaded.predict(x, batch_size=4),
                               tm.predict(x, batch_size=4), rtol=0, atol=0)
