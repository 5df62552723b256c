"""The port's Switch mixture of experts against the JAX package's, on the
CPU.

Counterparts of the single-device cases of ``tests/test_expert_parallel.py``
(the dense reference, capacity drops, capacity rounding, bf16 routing
exact beyond 256 tokens, the Keras layer, the aux loss in the training
loss); then ``switch_moe`` against the JAX package's on the same numpy
weights and tokens, with and without drops (values and the gradients of
every weight, the router's included, and of the tokens, within 1e-5),
and the index dispatch against the dense one-hot formulation
(``switch_moe_plain``: values and gradients within 1e-6 at f32, equal
at bf16).  Then
``TransformerLM(moe_every=2, n_experts=4)``: gradients of one batch and
a 2-epoch adam trajectory against the JAX model on the same weights
(losses within 1e-5 relative, weights 1e-4, evaluate 1e-5), greedy
``generate`` token for token against the JAX package's, and a
``DecodeEngine`` stream equal to ``generate``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.models import TransformerLM as JaxLM
from analytics_zoo_tpu.parallel import expert as jexpert
from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
from analytics_zoo_tpu_torch.parallel import expert
from analytics_zoo_tpu_torch.parallel.expert import (
    MoEParams, expert_capacity, init_moe_params, switch_moe,
    switch_moe_plain)
from analytics_zoo_tpu_torch.pipeline.api.keras import (Sequential,
                                                        load_model,
                                                        objectives,
                                                        optimizers)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (Dense,
                                                               SwitchMoE)
from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine
from analytics_zoo_tpu_torch.train.trainer import TrainState, build_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
D, H, E, T = 8, 16, 8, 64


def _dense_reference(x, p: MoEParams):
    """Every token through its argmax expert, no capacity limit."""
    probs = torch.softmax(x @ p.gate, dim=-1)
    idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    h = torch.relu(torch.einsum("td,tdh->th", x, p.w1[idx]) + p.b1[idx])
    return (torch.einsum("th,thd->td", h, p.w2[idx]) + p.b2[idx]) \
        * gate[:, None]


@pytest.fixture(scope="module")
def setup():
    g = torch.Generator("cpu").manual_seed(0)
    params = init_moe_params(g, D, H, E)
    x = torch.randn((T, D), generator=torch.Generator().manual_seed(1))
    return params, x


def test_torch_switch_moe_matches_dense_reference(setup):
    params, x = setup
    out, aux = switch_moe(x, params, capacity=T)
    np.testing.assert_allclose(out.numpy(),
                               _dense_reference(x, params).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(aux) > 0


def test_capacity_drops_tokens(setup):
    params, x = setup
    full, _ = switch_moe(x, params, capacity=T)
    tight, _ = switch_moe(x, params, capacity=1)
    dropped = (tight == 0).all(dim=1)
    assert int(dropped.sum()) >= T - E
    np.testing.assert_allclose(tight[~dropped].numpy(),
                               full[~dropped].numpy(), rtol=1e-5, atol=1e-6)


def test_expert_capacity_rounding():
    assert expert_capacity(64, 8, 1.0) == 8
    assert expert_capacity(64, 8, 1.25) == 10
    assert expert_capacity(3, 8, 1.0) == 1


def test_torch_routing_exact_in_bf16_beyond_256_tokens():
    """Queue positions come from an integer cumsum: at bf16 and 2048
    tokens on 2 experts every (expert, slot) holds at most one token and
    every token is dispatched once."""
    g = torch.Generator().manual_seed(3)
    params = init_moe_params(g, 4, 8, 2, dtype=torch.bfloat16)
    x = torch.randn((2048, 4), generator=g).to(torch.bfloat16)
    r = expert._route(x, params.gate, 2, capacity=2048)
    assert bool(r.keep.all())
    slots = (r.expert * 2048 + r.position).numpy()
    assert len(np.unique(slots)) == 2048
    assert int(r.position.max()) > 256
    out, _ = switch_moe(x, params, capacity=2048)
    ref, _ = switch_moe_plain(x, params, capacity=2048)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref.float().numpy())


def _jax_params(p: MoEParams):
    return jexpert.MoEParams(*(jnp.asarray(t.detach().numpy()) for t in p))


@pytest.mark.parametrize("capacity", [None, T, 3])
def test_switch_moe_values_and_gradients_match_jax(setup, capacity):
    params, x = setup
    w = np.random.default_rng(2).normal(size=(T, D)).astype(np.float32)
    jp = _jax_params(params)

    def jloss(p, xx):
        out, aux = jexpert.switch_moe(xx, p, capacity=capacity)
        return jnp.sum(out * w) + 0.3 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x.numpy()))
    tp = MoEParams(*(t.clone().requires_grad_(True) for t in params))
    tx = x.clone().requires_grad_(True)
    out, aux = switch_moe(tx, tp, capacity=capacity)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    grads = torch.autograd.grad(
        torch.sum(out * torch.from_numpy(w)) + 0.3 * aux, [tx, *tp])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for name, g, jg in zip(MoEParams._fields, grads[1:], jgp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)
    assert float(grads[1].abs().sum()) > 0  # the router learns


@pytest.mark.parametrize("capacity", [None, T, 2])
def test_index_dispatch_equals_dense_one_hot(setup, capacity):
    params, x = setup
    tp = MoEParams(*(t.clone().requires_grad_(True) for t in params))
    got = switch_moe(x, tp, capacity=capacity)
    ref = switch_moe_plain(x, tp, capacity=capacity)
    np.testing.assert_allclose(got[0].detach().numpy(),
                               ref[0].detach().numpy(), rtol=1e-6, atol=1e-6)
    assert float(got[1]) == float(ref[1])
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    ga = torch.autograd.grad((got[0] * w).sum() + got[1], list(tp))
    gb = torch.autograd.grad((ref[0] * w).sum() + ref[1], list(tp))
    for name, a, b in zip(MoEParams._fields, ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_moe_sharded_is_not_ported_yet(setup):
    """moe_sharded is ported: its validation errors are the JAX
    package's, and on an expert axis of one it is switch_moe at the
    capacity of the whole token block."""
    params, x = setup
    with pytest.raises(ValueError, match="n_experts .* not divisible"):
        expert.moe_sharded(x, params, {"expert": 3})
    with pytest.raises(ValueError, match="tokens .* not divisible"):
        expert.moe_sharded(x[:-1], params, {"expert": 2})
    got = expert.moe_sharded(x, params, {"expert": 1})
    ref = switch_moe(x, params)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_torch_switch_moe_keras_layer(tmp_path):
    """SwitchMoE in a Sequential: trains, keeps its aux loss in the
    layer state, round-trips through save_model/load_model."""
    m = Sequential(device="cpu")
    m.add(Dense(16, activation="relu", input_shape=(8,)))
    m.add(SwitchMoE(n_experts=4, hidden_dim=32, name="moe"))
    m.add(Dense(1))
    m.compile(optimizer={"name": "adam", "lr": 5e-3}, loss="mse")
    rs = np.random.RandomState(0)
    x = rs.rand(128, 8).astype(np.float32)
    y = x.sum(axis=1, keepdims=True).astype(np.float32)
    hist = m.fit(x, y, batch_size=32, nb_epoch=8)
    assert hist["loss"][-1] < 0.5 * hist["loss"][0]
    aux = m.trainer.state.model_state["moe"]["aux_loss"]
    assert np.isfinite(float(aux)) and float(aux) > 0
    ref = m.predict(x[:16], batch_size=16)
    m.save_model(str(tmp_path / "m"))
    loaded = load_model(str(tmp_path / "m"), device="cpu")
    np.testing.assert_allclose(loaded.predict(x[:16], batch_size=16), ref,
                               rtol=1e-5, atol=1e-6)
    assert loaded.get_layer("moe").get_config() == \
        m.get_layer("moe").get_config()


def test_torch_moe_aux_loss_reaches_training_loss():
    """The reported training loss includes aux_weight * aux, and zeroing
    aux_weight removes exactly that; the JAX package's layer gives the
    same aux on the same weights."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(64, 8).astype(np.float32))
    y = torch.from_numpy(rs.rand(64, 8).astype(np.float32))
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        SwitchMoE as JSwitchMoE)
    jl = JSwitchMoE(n_experts=4, hidden_dim=16, aux_weight=0.5,
                    input_shape=(8,), name="jmoe")
    jp, js = jl.init(jax.random.PRNGKey(0), (None, 8))
    _, jstate = jl.apply(jp, js, jnp.asarray(x.numpy()), training=True)
    losses = {}
    for aux_w in (0.0, 0.5):
        layer = SwitchMoE(n_experts=4, hidden_dim=16, aux_weight=aux_w,
                          input_shape=(8,), device="cpu")
        with torch.no_grad():
            for k, v in jax.device_get(jp).items():
                getattr(layer, k).copy_(torch.from_numpy(np.array(v)))
        opt = optimizers.get({"name": "sgd", "lr": 0.0})
        params = list(layer.parameters())
        state = TrainState(params, {}, opt.init(params))
        step = build_train_step(layer, objectives.get("mse"), opt)
        losses[aux_w] = (float(step(state, x, y)), float(layer.aux_loss))
    (base, aux0), (with_aux, aux_val) = losses[0.0], losses[0.5]
    assert aux0 == 0.0 and aux_val > 0
    np.testing.assert_allclose(with_aux - base, aux_val, rtol=1e-5)
    np.testing.assert_allclose(aux_val, float(jstate["aux_loss"]),
                               rtol=1e-6)


# ---- TransformerLM with Switch-MoE blocks ---------------------------------

VOCAB, SEQ = 12, 16
LM = dict(vocab_size=VOCAB, seq_len=SEQ, n_layers=2, d_model=32, n_heads=2,
          moe_every=2, n_experts=4)


def periodic_tokens(n=96, seed=0):
    rng = np.random.default_rng(seed)
    steps, start = rng.integers(1, 3, n), rng.integers(0, VOCAB, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(SEQ + 1)[None, :]) % VOCAB
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _pair(**kw):
    zoo.reset_nncontext()
    zoo.init_nncontext()
    jm = JaxLM(**LM, **kw)
    tm = TransformerLM(**LM, **kw, device="cpu")
    from_jax_params(tm, jax.device_get(jm.get_weights()))
    return jm, tm


def test_moe_transformer_lm_layout_and_gradients_match_jax():
    jm, tm = _pair()
    assert hasattr(tm, "moe_1") and not hasattr(tm, "moe_0")
    assert hasattr(tm, "mlp_up_0") and not hasattr(tm, "mlp_up_1")
    x, y = periodic_tokens(8)
    jm.compile(optimizer="sgd", loss="class_nll")
    jm.trainer.ensure_initialized()
    jst = jm.trainer.state
    from analytics_zoo_tpu.train.trainer import _collect_aux
    from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj

    def jloss(p):
        out, st = jm.model.apply(p, jst.model_state, jnp.asarray(x),
                                 training=True)
        return jnp.mean(jobj.class_nll(jnp.asarray(y), out)) \
            + _collect_aux(st)

    jval, jgrads = jax.value_and_grad(jloss)(jst.params)
    from analytics_zoo_tpu_torch.pipeline.api.keras.regularizers import \
        collect_penalties
    with collect_penalties() as pen:
        out = tm(torch.from_numpy(x))
        loss = objectives.class_nll(torch.from_numpy(y), out).mean()
    aux = pen.total()
    assert aux is not None and float(aux) > 0
    loss = loss + aux
    np.testing.assert_allclose(float(loss), float(jval), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    jg = jax.device_get(jgrads)
    for name, g in zip(names, grads):
        layer, key = name.split(".")
        np.testing.assert_allclose(g.numpy(), jg[layer][key], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_moe_transformer_lm_trains_like_jax():
    """Counterpart of test_transformer_lm_moe_variant_trains: adam 3e-3,
    2 shuffled epochs, the router's drops and aux loss included."""
    jm, tm = _pair()
    x, y = periodic_tokens(64)
    for m in (jm, tm):
        m.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
                  metrics=["accuracy"])
    ref = jm.fit(x, y, batch_size=32, nb_epoch=2)
    out = tm.fit(x, y, batch_size=32, nb_epoch=2)
    assert len(out["loss"]) == len(ref["loss"]) == 4
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5, atol=0)
    assert np.isfinite(out["loss"]).all() and out["loss"][-1] < out["loss"][0]
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for key, a in leaves.items():
            np.testing.assert_allclose(a, jw[layer][key], rtol=0, atol=1e-4,
                                       err_msg=f"{layer}/{key}")
    aux = tm.trainer.state.model_state["moe_1"]["aux_loss"]
    np.testing.assert_allclose(
        float(aux), float(jm.trainer.state.model_state["moe_1"]["aux_loss"]),
        rtol=1e-5)
    ref_e, out_e = jm.evaluate(x, y, batch_size=40), tm.evaluate(
        x, y, batch_size=40)
    for key in ref_e:
        assert out_e[key] == pytest.approx(ref_e[key], rel=1e-5, abs=1e-5)


@pytest.fixture(scope="module")
def trained_pair():
    """A briefly trained drop-free pair (capacity_factor = n_experts, so
    the full forward, the oracle of the cache path, drops nothing)."""
    jm, tm = _pair(capacity_factor=4.0)
    x, y = periodic_tokens(64)
    jm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll")
    jm.fit(x, y, batch_size=32, nb_epoch=2)
    from_jax_params(tm, jax.device_get(jm.get_weights()))
    return jm, tm.eval()


def test_moe_generate_matches_jax_token_for_token(trained_pair):
    jm, tm = trained_pair
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 8))
    out = tm.generate(prompt, max_new_tokens=6)
    np.testing.assert_array_equal(out, np.asarray(jm.generate(
        prompt, max_new_tokens=6)))
    with torch.no_grad():
        for t in range(6):  # the cache path against the full forward
            full = tm(torch.from_numpy(out[:, :8 + t].astype(np.int64)))
            np.testing.assert_array_equal(
                out[:, 8 + t], full[:, -1].argmax(-1).numpy())
    beams = tm.generate(prompt, max_new_tokens=4, num_beams=2)
    np.testing.assert_array_equal(beams, np.asarray(jm.generate(
        prompt, max_new_tokens=4, num_beams=2)))


def test_moe_decode_engine_streams_equal_generate(trained_pair):
    _, tm = trained_pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, n) for n in (3, 8, 5)]
    news = [7, 4, 6]
    eng = DecodeEngine(tm, capacity=2, max_len=SEQ, prompt_buckets=(8,),
                       step_fuse=4)
    try:
        eng.warmup()
        outs = eng.generate(prompts, news, timeout=60)
    finally:
        eng.close()
    for p, n, o in zip(prompts, news, outs):
        ref = tm.generate(p[None], max_new_tokens=n)[0, len(p):]
        np.testing.assert_array_equal(o, ref)
