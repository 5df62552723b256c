"""Port counterpart of ``tests/test_serving_shardgroup.py``: replica
groups over device sub-meshes (``analytics_zoo_tpu_torch.serving.
shardgroup``), carved from ``["cpu"] * 4``, and their parity with the
JAX package.

The pinned contracts:
* a group serves bit-identically to the single-device forward (the port
  gathers each layer's weights on use, so row rules are exact too);
* build once, place everywhere: a whole M-group set pays ONE build a
  signature, and a second set builds exactly as the first (the port
  keeps no per-signature store entry, see ``serving/execstore.py``);
* at rest each member holds only its blocks, and a dispatch gathers
  one layer at a time;
* the pager faults and evicts a group's weights atomically: a rebuild
  whose placement is incomplete is refused, concurrent fault and evict
  churn never serves a wrong result, and undeploy racing a fault
  discards the rebuild;
* the mesh decode engine streams equal the unsplit engine's, greedy and
  sampled, with the JAX package's refusals.

Parity (the last tests): the JAX side runs once, in ONE subprocess for
this file, with the ``jax.lib.xla_client`` shim and four virtual CPU
devices (the shim is never set in the pytest process): canonical specs
and error messages over a table of specs, ``carve_groups`` layouts,
each strategy's spec tree, and a sharded TransformerLM predict held at
1e-6 through ``jax_params``.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as _IM
from analytics_zoo_tpu_torch.pipeline.inference import (
    inference_model as _imod)
from analytics_zoo_tpu_torch.pipeline.inference.serving import (
    available_devices, fetch_rows)
from analytics_zoo_tpu_torch.serving import ModelNotFound
from analytics_zoo_tpu_torch.serving import ModelRegistry as _Registry
from analytics_zoo_tpu_torch.serving import (ShardGroupSet, carve_groups,
                                             execstore, normalize_mesh_spec,
                                             registry_families)
from analytics_zoo_tpu_torch.serving import shardgroup as SG

REPO = Path(__file__).resolve().parents[1]
DEVS = ["cpu"] * 4
D_IN = 16
X = np.arange(4 * D_IN, dtype=np.float32).reshape(4, D_IN) * 0.01


def InferenceModel(*args, **kwargs):
    kwargs.setdefault("device", "cpu")
    return _IM(*args, **kwargs)


def ModelRegistry(*args, **kwargs):
    kwargs.setdefault("device", "cpu")
    return _Registry(*args, **kwargs)


def _mlp_fn():
    def fn(p, x):
        return torch.tanh(x @ p["w0"]) @ p["w1"]
    rng = np.random.default_rng(0)
    params = {"w0": rng.normal(size=(D_IN, D_IN)).astype(np.float32) * 0.3,
              "w1": rng.normal(size=(D_IN, D_IN)).astype(np.float32) * 0.3}
    return fn, params


def _solo(fn, params, x=X):
    with torch.no_grad():
        return fn({k: torch.tensor(v) for k, v in params.items()},
                  torch.tensor(x)).numpy()


@pytest.fixture
def compile_counter(monkeypatch):
    """Every build the serving path reports (``profile.note_compile``)."""
    from analytics_zoo_tpu_torch.observability import profile

    events = []
    real = profile.note_compile

    def note(seconds, key, **kw):
        events.append(key)
        real(seconds, key, **kw)

    monkeypatch.setattr(profile, "note_compile", note)
    return events


# ------------------------------------------------------------ mesh spec
def test_mesh_spec_validation_errors():
    with pytest.raises(ValueError):
        normalize_mesh_spec({"axes": {"bogus_axis": 2}})
    with pytest.raises(ValueError):
        normalize_mesh_spec({"axes": {"tensor": 0}})
    with pytest.raises(ValueError):
        normalize_mesh_spec({"axes": {"tensor": 2},
                             "strategy": "bogus"})
    with pytest.raises(ValueError):
        normalize_mesh_spec({"axes": {"tensor": 2}, "groups": -1})
    with pytest.raises(ValueError):
        normalize_mesh_spec({"axes": {"tensor": 2}, "unknown_key": 1})


def test_carve_groups_shapes():
    devs = ["cpu"] * 8
    spec = normalize_mesh_spec({"axes": {"tensor": 2}})
    groups = carve_groups(devs, spec)
    assert len(groups) == len(devs) // 2
    for gdevs, mesh in groups:
        assert len(gdevs) == 2
        assert mesh.axis_names == ("tensor",)
        assert mesh.shape == {"tensor": 2}
    # explicit group count clamps the carve
    spec2 = normalize_mesh_spec({"axes": {"tensor": 2}, "groups": 2})
    assert len(carve_groups(devs, spec2)) == 2
    # a group bigger than the host is an error, not a silent clamp
    spec3 = normalize_mesh_spec({"axes": {"tensor": len(devs) * 2}})
    with pytest.raises(ValueError):
        carve_groups(devs, spec3)
    # members' coordinates are row-major over the axes
    mesh = carve_groups(devs, normalize_mesh_spec(
        {"axes": {"fsdp": 2, "tensor": 2}}))[0][1]
    assert [mesh.coords(i) for i in range(4)] == [
        {"fsdp": 0, "tensor": 0}, {"fsdp": 0, "tensor": 1},
        {"fsdp": 1, "tensor": 0}, {"fsdp": 1, "tensor": 1}]


# ------------------------------------------- bit-exactness + one build
def test_groups_bitexact_vs_single_device_one_compile(compile_counter):
    fn, params = _mlp_fn()
    expected = _solo(fn, params)
    n0 = len(compile_counter)
    sgs = ShardGroupSet(fn, params, {"axes": {"tensor": 2}}, devices=DEVS)
    sgs.ensure_compiled(X)
    # build on group 0, place on group 1: one build
    assert len(compile_counter) - n0 == 1
    assert len(sgs.groups) == 2
    for g in sgs.groups:
        out = fetch_rows(sgs.dispatch(g, X), len(X))
        assert np.array_equal(out, expected)
    st = sgs.stats()
    assert st["groups"] == 2 and st["group_size"] == 2
    assert st["mesh_axes"] == {"tensor": 2}


def test_placement_complete_tracks_group_placement():
    fn, params = _mlp_fn()
    sgs = ShardGroupSet(fn, params, {"axes": {"tensor": 2}}, devices=DEVS)
    sgs.ensure_compiled(X)
    assert sgs.placement_complete()
    # drop one group's executable: the check must read incomplete
    key = next(iter(sgs._exes))
    sgs._exes[key] = sgs._exes[key][:1]
    assert not sgs.placement_complete()


# --------------------------------------------------------- the store
def test_store_on_second_set_builds_as_the_first(tmp_path,
                                                 compile_counter):
    """The JAX package's warm store loads a second set's executables;
    the port's store holds kernel libraries only, so a second set builds
    exactly as the first (one build a signature) and the store sees no
    traffic, with the same bits."""
    fn, params = _mlp_fn()
    st = execstore.configure(str(tmp_path / "store"))
    try:
        expected = _solo(fn, params)
        outs = []
        for _ in range(2):
            n0 = len(compile_counter)
            s = ShardGroupSet(fn, params, {"axes": {"tensor": 2}},
                              devices=DEVS)
            s.ensure_compiled(X)
            assert len(compile_counter) - n0 == 1
            outs += [fetch_rows(s.dispatch(g, X), len(X)) for g in s.groups]
        assert all(np.array_equal(o, expected) for o in outs)
        s = st.stats()
        assert (s["entries"], s["hit"], s["miss"], s["write"]) == (0,) * 4
    finally:
        execstore.disable()


@pytest.mark.parametrize("spec", [
    {"axes": {"tensor": 2}},                       # column rules
    {"axes": {"tensor": 1}},                       # a mesh-only change
    {"axes": {"tensor": 2}, "rules": {r"w\d+": 0}},  # row rules
    {"axes": {"fsdp": 2}, "strategy": "fsdp", "fsdp_min_size": 16},
    {"axes": {"tensor": 2}, "strategy": "replicate"}])
def test_layouts_differ_and_each_serves_exact(spec):
    """The JAX package's store keys rotate on a mesh-only or rules-only
    change; here every layout places its own blocks (the spec tree picks
    the split dimension) and each gives the single-device bits, row
    rules included (gathered, never partial sums)."""
    fn, params = _mlp_fn()
    s = ShardGroupSet(fn, params, spec, devices=DEVS)
    s.ensure_compiled(X)
    out = fetch_rows(s.dispatch(s.groups[-1], X), len(X))
    assert np.array_equal(out, _solo(fn, params))
    leaf = s.groups[0].params["w0"]
    n = SG.group_size(s.mesh_spec)
    whole = D_IN * D_IN * 4
    if spec.get("strategy") == "replicate" or n == 1:
        assert leaf.whole and s.member_bytes()[0] == [2 * whole] * n
    else:
        assert not leaf.whole
        split = [i for i, e in enumerate(leaf.spec) if e is not None]
        assert split == ([0] if "rules" in spec or "fsdp" in spec["axes"]
                         else [1])
        assert s.member_bytes()[0] == [2 * whole // n] * n


# ------------------------------------------------------ gather on use
def test_dispatch_gathers_one_layer_at_a_time(monkeypatch):
    """A module forward gathers each layer's leaves when the layer runs
    and frees them when it returns: the gathered bytes alive at once
    never pass the largest layer's, far below the whole model."""
    import weakref
    lm = TransformerLM(vocab_size=64, seq_len=16, n_layers=2, d_model=32,
                       n_heads=2, device="cpu").eval()
    ids = np.random.default_rng(0).integers(0, 64, (2, 16))
    want = InferenceModel().load_keras_net(lm).predict(ids)
    im = InferenceModel(mesh={"axes": {"tensor": 2}}, replicas=DEVS)
    im.load_keras_net(lm)
    live = {"bytes": 0, "peak": 0}
    real = SG._ShardedLeaf.gather

    def counted(self, device):
        out = real(self, device)
        if not self.whole:
            n = out.numel() * out.element_size()
            live["bytes"] += n
            live["peak"] = max(live["peak"], live["bytes"])
            weakref.finalize(out, lambda: live.__setitem__(
                "bytes", live["bytes"] - n))
        return out

    monkeypatch.setattr(SG._ShardedLeaf, "gather", counted)
    try:
        got = im.predict(ids)
    finally:
        im.close()
    assert np.array_equal(got, want)
    layer_bytes = {}
    for name, t in list(lm.named_parameters()) + list(lm.named_buffers()):
        layer = name.rsplit(".", 1)[0]
        layer_bytes[layer] = layer_bytes.get(layer, 0) + t.numel() * 4
    total = sum(layer_bytes.values())
    assert 0 < live["peak"] <= max(layer_bytes.values()) < total / 2
    rs = im._cache.replica_set
    for members in rs.member_bytes():
        assert sum(members) >= total and max(members) < total


def test_bare_fn_gathers_its_whole_tree_and_warns(monkeypatch, caplog):
    """A function without ``fn.module`` has no layer to gather at: the
    set warns when it is built, and each dispatch gathers every sharded
    leaf at once (the gathered bytes alive at once are the whole sharded
    tree), still giving the solo bits."""
    import logging
    import weakref
    fn, params = _mlp_fn()
    with caplog.at_level(logging.WARNING, logger="zoo.shardgroup"):
        sgs = ShardGroupSet(fn, params, {"axes": {"tensor": 2}},
                            devices=DEVS)
    assert "shardgroup_whole_tree_gather" in caplog.text
    sgs.ensure_compiled(X)
    live = {"bytes": 0, "peak": 0}
    real = SG._ShardedLeaf.gather

    def counted(self, device):
        out = real(self, device)
        n = out.numel() * out.element_size()
        live["bytes"] += n
        live["peak"] = max(live["peak"], live["bytes"])
        weakref.finalize(out, lambda: live.__setitem__(
            "bytes", live["bytes"] - n))
        return out

    monkeypatch.setattr(SG._ShardedLeaf, "gather", counted)
    got = fetch_rows(sgs.dispatch(sgs.groups[0], X), len(X))
    assert np.array_equal(got, _solo(fn, params))
    assert live["peak"] == sum(v.nbytes for v in params.values())
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="zoo.shardgroup"):
        ShardGroupSet(fn, params, {"axes": {"tensor": 2},
                                   "strategy": "replicate"}, devices=DEVS)
    assert "shardgroup_whole_tree_gather" not in caplog.text


def test_sharded_handle_holds_no_whole_net(tmp_path, monkeypatch):
    """Under a mesh the groups' blocks are cut from the net's tensors and
    the handle keeps only a ``meta`` skeleton: an in-memory net is
    released once loaded, and ``load()`` reads the saved model onto the
    host and releases it too, answering as the solo load (the card test
    ``test_cuda_sharded_load_holds_only_the_blocks`` measures the
    card's side)."""
    import gc
    import weakref
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import KerasNet
    lm = TransformerLM(vocab_size=64, seq_len=16, n_layers=2, d_model=32,
                       n_heads=2, device="cpu").eval()
    ids = np.random.default_rng(6).integers(0, 64, (2, 16)).astype(np.int32)
    path = str(tmp_path / "lm")
    lm.save_model(path)
    want = InferenceModel().load(path).predict(ids)
    im = InferenceModel(mesh={"axes": {"tensor": 2}}, replicas=DEVS[:2])
    im.load_keras_net(lm)
    ref = weakref.ref(lm)
    del lm
    gc.collect()
    assert ref() is None
    assert all(t.device.type == "meta"
               for t in _imod.module_tensors(im._net).values())
    assert np.array_equal(im.predict(ids), want)
    im.close()
    loads = []
    real = KerasNet.load_model

    def spy(path, device=None):
        net = real(path, device=device)
        loads.append((torch.device(device), weakref.ref(net)))
        return net

    monkeypatch.setattr(KerasNet, "load_model", staticmethod(spy))
    im = InferenceModel(mesh={"axes": {"tensor": 2}}, replicas=DEVS[:2])
    im.load(path)
    gc.collect()
    try:
        assert [d for d, _ in loads] == [torch.device("cpu")]
        assert loads[0][1]() is None
        assert np.array_equal(im.predict(ids), want)
    finally:
        im.close()


# ----------------------------------------------------- model integration
def test_inference_model_mesh_integration():
    fn, params = _mlp_fn()
    expected = _solo(fn, params)
    m = InferenceModel(mesh={"axes": {"tensor": 2}}).load_fn(fn, params)
    try:
        assert np.array_equal(np.asarray(m.predict(X)), expected)
        assert m.placement_complete()
        st = m.serving_stats()
        assert st["groups"] == len(available_devices("cpu")) // 2
        assert st["group_size"] == 2
    finally:
        m.close()


def test_registry_mesh_deploy_and_group_families():
    fn, params = _mlp_fn()
    expected = _solo(fn, params)
    with ModelRegistry(replicas=DEVS) as reg:
        reg.deploy("shard", fn=fn, params=params,
                   mesh={"axes": {"tensor": 2}, "groups": 2},
                   warmup_shapes=(D_IN,))
        for _ in range(4):
            assert np.array_equal(np.asarray(reg.predict("shard", X)),
                                  expected)
        fams = {f.name: f for f in registry_families(reg.metrics())}
        assert fams["zoo_model_groups"].samples[0][1] == 2
        disp = {s[0]["group"]: s[1]
                for s in fams["zoo_group_dispatches_total"].samples}
        assert sum(disp.values()) >= 4


# ------------------------------------------------- group-atomic paging
def _paged_mesh_registry():
    return ModelRegistry(max_concurrency=2, replicas=DEVS,
                         pager={"max_resident": 1,
                                "quiesce_timeout_s": 1.0})


def _deploy_mesh(reg, name, fn, params):
    reg.deploy(name, fn=fn, params=params,
               mesh={"axes": {"tensor": 2}, "groups": 2},
               warmup_shapes=(D_IN,))


def test_pager_refuses_partial_group_placement():
    fn, params = _mlp_fn()
    expected = _solo(fn, params)
    with _paged_mesh_registry() as reg:
        _deploy_mesh(reg, "a", fn, params)
        _deploy_mesh(reg, "b", fn, params)
        reg.predict("b", X)  # a cold
        assert reg._entries["a"].pager_state != "resident"
        orig = _imod.InferenceModel.placement_complete
        _imod.InferenceModel.placement_complete = lambda self: False
        try:
            with pytest.raises(Exception):
                reg.predict("a", X)
        finally:
            _imod.InferenceModel.placement_complete = orig
        # the refused rebuild left the entry cold, counted as an error
        assert reg._entries["a"].pager_state != "resident"
        snap = reg.pager.snapshot()["models"]
        assert snap["a"]["fault_error"] >= 1
        # and the un-poisoned retry installs and serves bit-exactly
        assert np.array_equal(np.asarray(reg.predict("a", X)), expected)
        assert reg._entries["a"].active.model.placement_complete()


def test_concurrent_fault_evict_churn_never_partial():
    fn, params = _mlp_fn()
    rng = np.random.default_rng(1)
    params2 = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.1)
               for k, v in params.items()}
    exp = {"a": _solo(fn, params), "b": _solo(fn, params2)}
    with _paged_mesh_registry() as reg:
        _deploy_mesh(reg, "a", fn, params)
        _deploy_mesh(reg, "b", fn, params2)
        errs, wrong = [], []

        def hammer(name, n):
            for _ in range(n):
                try:
                    out = np.asarray(reg.predict(name, X))
                except Exception as e:  # noqa: BLE001 — gate counts
                    errs.append(e)
                    continue
                if not np.array_equal(out, exp[name]):
                    wrong.append(name)

        ts = [threading.Thread(target=hammer, args=(n, 8))
              for n in ("a", "b") for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs and not wrong
        snap = reg.pager.snapshot()["models"]
        # at budget 1 the alternating load must actually churn
        assert sum(m["fault_ok"] for m in snap.values()) >= 2
        # whatever ended resident is fully placed (never partial)
        for name in ("a", "b"):
            entry = reg._entries[name]
            if entry.pager_state == "resident":
                assert entry.active.model.placement_complete()


def test_undeploy_racing_group_fault_discards_rebuild():
    fn, params = _mlp_fn()
    with _paged_mesh_registry() as reg:
        _deploy_mesh(reg, "a", fn, params)
        _deploy_mesh(reg, "b", fn, params)
        reg.predict("b", X)  # a cold
        entry = reg._entries["a"]
        real = entry.pager_recipe.build
        started = threading.Event()
        built = []

        def slow_build(span=None):
            started.set()
            time.sleep(0.4)
            im = real(span=span)
            built.append(im)
            return im

        entry.pager_recipe.build = slow_build
        errs = []

        def hit():
            try:
                reg.predict("a", X)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=hit)
        t.start()
        assert started.wait(timeout=10)
        reg.undeploy("a", drain_timeout=0.1)
        t.join(timeout=30)
        assert not t.is_alive()
        assert len(errs) == 1 and isinstance(errs[0], ModelNotFound)
        # the stale sharded rebuild was discarded on the generation
        # check, not installed into the undeployed entry
        assert len(built) == 1
        assert entry.pager_state is None and entry.active is None


def test_net_deploy_pages_out_and_faults_in_sharded():
    """A net deployed under a mesh pages through its meta skeleton: the
    fault-in rebuild gathers on use again and answers bit-equal."""
    lm = TransformerLM(vocab_size=64, seq_len=16, n_layers=2, d_model=32,
                       n_heads=2, device="cpu").eval()
    ids = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(np.int32)
    with _paged_mesh_registry() as reg:
        reg.deploy("lm", lm, mesh={"axes": {"tensor": 2}},
                   warmup_shapes=(16,), warmup_dtypes=np.int32)
        want = reg.predict("lm", ids)
        _deploy_mesh(reg, "b", *_mlp_fn())
        reg.predict("b", X)  # lm cold
        assert reg._entries["lm"].pager_state == "cold"
        assert np.array_equal(reg.predict("lm", ids), want)
        model = reg._entries["lm"].active.model
        assert model.placement_complete()
        assert model.serving_stats()["groups"] == 2


# ------------------------------------------------------- sharded decode
def _tiny_lm():
    return TransformerLM(vocab_size=64, seq_len=48, n_layers=2, d_model=32,
                         n_heads=2, device="cpu").eval()


def test_decode_engine_mesh_bitexact():
    lm = _tiny_lm()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, int(rng.integers(4, 16)))
               for _ in range(3)]

    def run(mesh, temperature):
        eng = DecodeEngine(lm, capacity=2, max_len=48,
                           prompt_buckets=(16,), mesh=mesh,
                           devices=DEVS[:2] if mesh else None)
        try:
            streams = [eng.submit(p, max_new_tokens=5,
                                  temperature=temperature, seed=i)
                       for i, p in enumerate(prompts)]
            return [list(s.result(timeout=60)) for s in streams]
        finally:
            eng.close()

    # greedy token for token; sampled too (each slot draws from its own
    # (seed, token index) stream)
    for temperature in (0.0, 0.7):
        assert run(None, temperature) == run({"axes": {"tensor": 2}},
                                             temperature)


def _probe_logits(engine, prompts):
    """Admit ``prompts`` into the engine's slots 0, 1, ... (a mesh
    engine's members in turn, ``capacity / group size`` each) and return,
    on the host, the logits each member's next decode step selects from,
    computed eagerly by the step's body at the member's step batch.  Runs
    before the engine serves; the slots stay on the free list."""
    from analytics_zoo_tpu_torch.models.generation import (_decode_step,
                                                           _embed_token)
    from analytics_zoo_tpu_torch.pipeline.inference.decode import (
        TokenStream, _DecodeRequest)
    members = getattr(engine, "members", [engine])
    per = engine.capacity // len(members)
    parts = []
    for j, m in enumerate(members):
        rows = prompts[j * per:(j + 1) * per]
        if not rows:
            continue
        m._after_caller()
        with m._on_device():
            for slot, ids in enumerate(rows):
                prompt, n, bucket, _, _ = m._validate(ids, 1)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :n] = prompt
                m._admit_monolithic(_DecodeRequest(
                    padded, n, bucket, 1, None, TokenStream(0)), slot)
            posc = m._pos.clamp(max=m.max_len - 1)
            logits = _decode_step(m._model, m._caches,
                                  _embed_token(m._model, m._tok, posc), posc)
            parts.append(logits[:len(rows)].float().cpu())
    return torch.cat(parts)


def test_decode_engine_mesh_logits_and_stats():
    """Each member steps at capacity / group size rows: its logits hold
    the unsplit engine's at 1e-5 (bit-equal when the BLAS keeps its
    algorithm at that size), and admissions split over the members."""
    lm = _tiny_lm()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, int(rng.integers(4, 16)))
               for _ in range(4)]
    plain = DecodeEngine(lm, capacity=4, max_len=48, prompt_buckets=(16,))
    mesh = DecodeEngine(lm, capacity=4, max_len=48, prompt_buckets=(16,),
                        mesh={"axes": {"tensor": 2}}, devices=DEVS[:2])
    try:
        want = _probe_logits(plain, prompts)
        got = _probe_logits(mesh, prompts)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        assert [m.capacity for m in mesh.members] == [2, 2]
        assert mesh.members[0]._model is lm
        assert mesh.members[1]._model is not lm
        mesh.warmup()
        outs = mesh.generate(prompts, 4, timeout=60)
        st = mesh.stats()
        assert st["admitted"] == 4 and st["capacity"] == 4
        assert st["mesh_axes"] == {"tensor": 2} and st["mesh_devices"] == 2
        assert all(m.stats()["admitted"] >= 1 for m in mesh.members)
        assert all(len(o) == 4 for o in outs)
    finally:
        plain.close()
        mesh.close()


def test_decode_engine_mesh_rejects_unsupported():
    lm = _tiny_lm()
    with pytest.raises(ValueError):
        DecodeEngine(lm, capacity=3, max_len=48, prompt_buckets=(16,),
                     mesh={"axes": {"tensor": 2}},
                     devices=DEVS)  # 3 % 2 != 0
    with pytest.raises(ValueError):
        DecodeEngine(lm, capacity=4, max_len=48, prompt_buckets=(16,),
                     prefix_pool=2, mesh={"axes": {"tensor": 2}},
                     devices=DEVS)
    with pytest.raises(ValueError):
        DecodeEngine(lm, capacity=4, max_len=48, prompt_buckets=(16,),
                     device="cpu", mesh={"axes": {"tensor": 2}},
                     devices=DEVS)
    with pytest.raises(ValueError, match="goes with mesh"):
        DecodeEngine(lm, capacity=4, max_len=48, prompt_buckets=(16,),
                     devices=DEVS)


def test_inference_model_mesh_hands_the_mesh_to_the_engine():
    lm = _tiny_lm()
    prompt = np.random.default_rng(5).integers(0, 64, 9)
    solo = InferenceModel(decode_capacity=2, decode_prompt_buckets=(16,))
    solo.load_keras_net(lm)
    im = InferenceModel(mesh={"axes": {"tensor": 2}}, replicas=DEVS[:2],
                        decode_capacity=2, decode_prompt_buckets=(16,),
                        store_tag="lm")
    im.load_keras_net(lm)
    try:
        eng = im.decode_engine
        assert len(eng.members) == 2 and eng.store_tag == "lm"
        assert np.array_equal(im.generate([prompt], 6, timeout=60)[0],
                              solo.generate([prompt], 6, timeout=60)[0])
        assert im.serving_stats()["decode"]["mesh_devices"] == 2
    finally:
        im.close()
        solo.close()


# ------------------------------------------------ parity with the JAX side
LM_CFG = dict(vocab_size=64, seq_len=16, n_layers=2, d_model=32, n_heads=2)
SPECS = [
    {"axes": {"tensor": 2}},
    {"axes": {"fsdp": 2, "tensor": 2}, "groups": 1, "strategy": "fsdp"},
    {"axes": {"tensor": 2}, "rules": {"W": "1"}, "fsdp_min_size": 8},
    {},
    {"axes": {"bogus_axis": 2}},
    {"axes": {"tensor": 0}},
    {"axes": {"tensor": 2}, "strategy": "bogus"},
    {"axes": {"tensor": 2}, "groups": -1},
    {"axes": {"tensor": 2}, "unknown_key": 1},
    {"axes": []},
    {"axes": {"tensor": 2}, "rules": [1]},
]
CARVE_SPECS = [{"axes": {"tensor": 2}}, {"axes": {"tensor": 2}, "groups": 1},
               {"axes": {"fsdp": 2, "tensor": 2}}, {"axes": {"tensor": 3}},
               {"axes": {"tensor": 8}}, {"axes": {"tensor": 2}, "groups": 3}]
TREE_SPECS = [
    {"axes": {"tensor": 2}},
    {"axes": {"tensor": 2}, "rules": {r"attn_\d+/W[qkv]$": 1,
                                      r"attn_\d+/Wo$": 0, "mlp_up": 1}},
    {"axes": {"fsdp": 2}, "strategy": "fsdp", "fsdp_min_size": 64},
    {"axes": {"tensor": 2}, "strategy": "replicate"},
    {"axes": {"tensor": 1}},
]

JAX_SIDE = textwrap.dedent('''
    import json, sys
    import jax, jax.lib
    from jaxlib import xla_client
    jax.lib.xla_client = xla_client  # the installed jax moved it
    import numpy as np
    from analytics_zoo_tpu.serving import shardgroup as SG
    from analytics_zoo_tpu.pipeline.inference import InferenceModel
    from analytics_zoo_tpu.models import TransformerLM

    cfg = json.loads(sys.argv[1])
    out = {"canonical": [], "layouts": [], "trees": []}
    for spec in cfg["specs"]:
        try:
            out["canonical"].append(
                ["ok", SG.mesh_spec_canonical(SG.normalize_mesh_spec(spec))])
        except Exception as e:
            out["canonical"].append([type(e).__name__, str(e)])
    devs = jax.local_devices()
    for spec in cfg["carve_specs"]:
        try:
            groups = SG.carve_groups(devs, SG.normalize_mesh_spec(spec))
            out["layouts"].append(["ok", [
                [[devs.index(d) for d in g], list(m.axis_names),
                 [int(m.shape[a]) for a in m.axis_names]]
                for g, m in groups]])
        except Exception as e:
            out["layouts"].append([type(e).__name__, str(e)])
    lm = TransformerLM(**cfg["lm"])
    params = jax.device_get(lm.ensure_inference_ready().state.params)
    rng = np.random.default_rng(3)
    tree = {layer: {key: (np.asarray(a) + rng.normal(0, 0.1, a.shape)
                          ).astype(np.float32)
                    for key, a in leaves.items()}
            for layer, leaves in params.items()}
    lm.set_weights(tree)
    arrays = {f"lm::{layer}::{key}": a for layer, leaves in tree.items()
              for key, a in leaves.items()}
    for spec in cfg["tree_specs"]:
        spec = SG.normalize_mesh_spec(spec)
        mesh = SG.carve_groups(devs, spec)[0][1]
        shardings = SG.spec_tree_for(tree, mesh, spec)
        out["trees"].append(sorted(
            [f"{layer}/{key}", [e if e is None or isinstance(e, str)
                                else list(e) for e in ns.spec]]
            for layer, leaves in shardings.items()
            for key, ns in leaves.items()))
    x = np.random.default_rng(7).integers(
        0, cfg["lm"]["vocab_size"], (3, cfg["lm"]["seq_len"])).astype(
            np.int32)
    # one group: placing a second one deserializes the executable, which
    # the installed jaxlib's API refuses (the reference's own shardgroup
    # tests are red here for it)
    im = InferenceModel(mesh={"axes": {"tensor": 2}, "groups": 1})
    im.load_keras_net(lm)
    try:
        arrays["y"] = np.asarray(im.predict(x))
        out["groups"] = im.serving_stats()["groups"]
    finally:
        im.close()
    arrays["x"] = x
    np.savez(sys.argv[2], **arrays)
    print("RESULT " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every parity case's JAX-package result, from one shimmed
    subprocess on four virtual CPU devices."""
    d = tmp_path_factory.mktemp("shardgroup_parity")
    (d / "jax_side.py").write_text(JAX_SIDE)
    cfg = {"specs": SPECS, "carve_specs": CARVE_SPECS,
           "tree_specs": TREE_SPECS, "lm": LM_CFG}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, str(d / "jax_side.py"), json.dumps(cfg),
         str(d / "arrays.npz")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads(line[0][len("RESULT "):])
    with np.load(d / "arrays.npz") as z:
        out["arrays"] = {k: z[k] for k in z.files}
    return out


def _lm_tree(arrays):
    tree = {}
    for k, a in arrays.items():
        if k.startswith("lm::"):
            _, layer, key = k.split("::")
            tree.setdefault(layer, {})[key] = a
    return tree


def test_mesh_specs_and_errors_match_jax(jax_side):
    got = []
    for spec in SPECS:
        try:
            got.append(["ok", SG.mesh_spec_canonical(
                normalize_mesh_spec(spec))])
        except Exception as e:  # noqa: BLE001 — compared with JAX's
            got.append([type(e).__name__, str(e)])
    assert got == jax_side["canonical"]
    assert sum(1 for g in got if g[0] == "ok") == 5


def test_carve_layouts_match_jax(jax_side):
    got = []
    for spec in CARVE_SPECS:
        try:
            groups = carve_groups(DEVS, normalize_mesh_spec(spec))
            got.append(["ok", [
                [[g * len(gdevs) + j for j in range(len(gdevs))],
                 list(m.axis_names), [m.shape[a] for a in m.axis_names]]
                for g, (gdevs, m) in enumerate(groups)]])
        except Exception as e:  # noqa: BLE001 — compared with JAX's
            got.append([type(e).__name__, str(e)])
    assert got == jax_side["layouts"]


def test_spec_trees_match_jax(jax_side):
    tree = _lm_tree(jax_side["arrays"])
    for spec, want in zip(TREE_SPECS, jax_side["trees"]):
        spec = normalize_mesh_spec(spec)
        mesh = carve_groups(DEVS, spec)[0][1]
        specs = SG.spec_tree_for(tree, mesh, spec)
        got = sorted([f"{layer}/{key}", [
            e if e is None or isinstance(e, str) else list(e) for e in s]]
            for layer, leaves in specs.items() for key, s in leaves.items())
        assert got == want, spec
    # the tables split something in every sharded case
    assert any(any(e for e in s) for _, s in jax_side["trees"][0])


def test_sharded_predict_matches_jax_shard_group_set(jax_side):
    arrays = jax_side["arrays"]
    lm = TransformerLM(**LM_CFG, device="cpu")
    from_jax_params(lm, _lm_tree(arrays))
    lm.eval()
    im = InferenceModel(mesh={"axes": {"tensor": 2}}, replicas=DEVS)
    im.load_keras_net(lm)
    try:
        y = im.predict(arrays["x"])
        assert im.serving_stats()["groups"] == 2
        assert jax_side["groups"] == 1
    finally:
        im.close()
    # the sharding adds nothing: the port's groups give its unsharded
    # bits; the packages' forwards differ by a few ulps of log-probs of
    # magnitude ~5, so the 1e-6 is relative
    assert np.array_equal(y, InferenceModel().load_keras_net(lm).predict(
        arrays["x"]))
    np.testing.assert_allclose(y, arrays["y"], rtol=1e-6, atol=0)
