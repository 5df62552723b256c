"""Layer rematerialization in the port (``core.module.remat_call``,
``torch.utils.checkpoint`` non-reentrant) against the JAX package's
``remat_apply``, and TransformerLM on the graph engine.

Counterparts of ``tests/test_remat.py``: remat cuts what the backward
keeps (here the bytes autograd saves outside the checkpointed regions,
read by ``saved_tensors_hooks``), a fit under remat gives the losses of
one without (rtol 2e-4, atol 2e-5, the JAX test's tolerance), the flag
round-trips through configs (left out when False) and is honoured
inside TimeDistributed and Bidirectional.  Here also: a remat region
holding Dropout gives the gradients of the same region without remat
(the recompute replays the layer's own generator), BatchNormalization's
moving statistics advance once under remat, eval runs no checkpoint,
and TransformerLM's ``freeze_up_to``/``get_layer``/``to_graph`` freeze
the set of parameter-holding layers the JAX package freezes, and a JAX
TransformerLM config carrying ``remat`` loads.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import TransformerLM as JTransformerLM
from analytics_zoo_tpu_torch.core import module as core_module
from analytics_zoo_tpu_torch.models import TransformerLM
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives


def saved_bytes(fn):
    """Bytes of the tensors autograd keeps for the backward while ``fn``
    runs (outside remat regions, whose own saving is checkpointed)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return total[0], out


CFG = dict(vocab_size=64, seq_len=256, n_layers=4, d_model=64, n_heads=4,
           implementation="naive")


def _lm_saved(remat):
    lm = TransformerLM(remat=remat, device="cpu", **CFG).train()
    x = torch.zeros(2, CFG["seq_len"], dtype=torch.long)
    return saved_bytes(lambda: lm(x).sum())[0]


def test_remat_cuts_saved_activation_memory():
    base, remat = _lm_saved(False), _lm_saved(True)
    assert remat < base / 4, (base, remat)


def test_remat_is_exact():
    """A 2-epoch fit under remat: the losses of the fit without."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 32, (64, 32)).astype(np.int32)
    y = (x + 1) % 32
    hists = []
    for remat in (False, True):
        lm = TransformerLM(vocab_size=32, seq_len=32, n_layers=2,
                           d_model=32, n_heads=2, remat=remat,
                           device="cpu")
        lm.compile({"name": "adam", "lr": 3e-3}, "class_nll", seed=0)
        hists.append(lm.fit(x, y, batch_size=32, nb_epoch=2)["loss"])
    np.testing.assert_allclose(hists[0], hists[1], rtol=2e-4, atol=2e-5)


def test_remat_survives_config_roundtrip():
    d = L.Dense(4, input_shape=(3,))
    d.remat = True
    cfg = d.get_config()
    assert cfg["remat"] is True
    assert L.Dense.from_config(cfg).remat is True
    assert "remat" not in L.Dense(4, input_shape=(3,)).get_config()


def test_wrapper_layers_roundtrip_base_flags():
    td = L.TimeDistributed(L.Dense(4), input_shape=(5, 3))
    td.remat = True
    td.trainable = False
    td2 = L.TimeDistributed.from_config(td.get_config())
    assert td2.remat is True and td2.trainable is False
    bi = L.Bidirectional(L.LSTM(4, return_sequences=True),
                         input_shape=(5, 3))
    bi.remat = True
    assert L.Bidirectional.from_config(bi.get_config()).remat is True


def _model_saved(build, x):
    m = build()
    m.train()
    return saved_bytes(lambda: m(torch.from_numpy(x)).sum())[0]


def _time_distributed(inner_remat):
    def build():
        inner = L.Dense(256, activation="relu")
        inner.remat = inner_remat
        m = Sequential(device="cpu")
        m.add(L.TimeDistributed(inner, input_shape=(16, 64)))
        m.add(L.TimeDistributed(L.Dense(8)))
        return m
    return build


def test_inner_layer_remat_honored_through_wrapper():
    x = np.zeros((4, 16, 64), np.float32)
    base = _model_saved(_time_distributed(False), x)
    remat = _model_saved(_time_distributed(True), x)
    assert remat < base, (base, remat)


def _bidirectional(inner_remat):
    def build():
        inner = L.LSTM(64, return_sequences=True)
        m = Sequential(device="cpu")
        m.add(L.Bidirectional(inner, input_shape=(16, 32)))
        m.add(L.Dense(4))
        inner.remat = inner_remat  # after wrapping: the clone follows
        return m
    return build


def test_inner_layer_remat_honored_through_bidirectional():
    x = np.zeros((4, 16, 32), np.float32)
    base = _model_saved(_bidirectional(False), x)
    remat = _model_saved(_bidirectional(True), x)
    # both directions recompute: less than half of what was kept
    assert remat < base / 2, (base, remat)


def _dropout_block(remat):
    """Dense -> Dropout -> Dense as one nested model (one remat region),
    then a head, from seed 0."""
    inner = Sequential(device="cpu", seed=1)
    inner.add(L.Dense(32, activation="relu", input_shape=(16,)))
    inner.add(L.Dropout(0.3))
    inner.add(L.BatchNormalization())
    inner.add(L.Dense(16))
    inner.remat = remat
    m = Sequential(device="cpu", seed=0)
    m.add(inner)
    m.add(L.Dense(3))
    return m


def test_remat_gradient_with_dropout_equals_the_one_without():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 16)).astype(np.float32))
    y = torch.from_numpy(np.arange(8) % 3)
    results = []
    for remat in (False, True):
        m = _dropout_block(remat).train()
        for layer in m.modules():
            if isinstance(layer, core_module.RandomLayer):
                layer.generator.manual_seed(11)
        loss = objectives.get("sparse_categorical_crossentropy")(
            y, torch.softmax(m(x), -1)).mean()
        grads = torch.autograd.grad(loss, list(m.parameters()))
        bn = next(l for l in m.modules()
                  if isinstance(l, L.BatchNormalization))
        results.append((loss.detach(), grads,
                        [b.clone() for b in bn.buffers()]))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the moving statistics advanced once, not again in the recompute
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)


def test_eval_runs_no_checkpoint(monkeypatch):
    calls = []
    real = core_module.torch_checkpoint.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(core_module.torch_checkpoint, "checkpoint",
                        counting)
    lm = TransformerLM(vocab_size=16, seq_len=8, n_layers=2, d_model=16,
                       n_heads=2, remat=True, device="cpu")
    x = torch.zeros(1, 8, dtype=torch.long)
    lm.eval()
    lm(x).sum()
    assert not calls
    lm.train()
    lm(x).sum().backward()
    assert len(calls) == 2 * 3  # attn, mlp_up, mlp_down a block


LM = dict(vocab_size=24, seq_len=12, n_layers=3, d_model=16, n_heads=2,
          dropout=0.1)


@pytest.mark.parametrize("target", ["attn_1", "mlp_down_0", "ln_final"])
def test_transformer_lm_freeze_up_to_freezes_the_jax_set(target):
    jm = JTransformerLM(**LM)
    jm.freeze_up_to([target])
    tm = TransformerLM(device="cpu", **LM)
    tm.freeze_up_to([target])
    holding = {l.name for l in tm.to_graph().layers if l.params()}
    assert set(tm.frozen_layer_names()) & holding == \
        set(jm.frozen_layer_names()) & holding
    assert all(not p.requires_grad for n in tm.frozen_layer_names()
               for p in tm.get_layer(n).parameters())
    assert [l.name for l in tm.to_graph().layers if l.params()] == [
        l.name for l in jm.to_graph().layers
        if l.name in holding]


def test_jax_transformer_lm_config_with_remat_loads():
    jm = JTransformerLM(remat=True, moe_every=2, n_experts=2, **LM)
    tm = TransformerLM.from_config(jm.get_config(), device="cpu")
    assert tm.hyper == jm.hyper
    flagged = {n for n in ("attn_0", "mlp_up_0", "mlp_down_0", "attn_1",
                           "moe_1", "attn_2", "mlp_up_2", "mlp_down_2")
               if tm.get_layer(n).remat}
    assert len(flagged) == 8
    assert not tm.get_layer("ln_attn_0").remat
    assert TransformerLM.from_config(tm.get_config(),
                                     device="cpu").hyper["remat"] is True
