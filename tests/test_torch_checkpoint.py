"""The port's checkpoints (``analytics_zoo_tpu_torch.train.checkpoint``)
against the JAX package's.

1. Counterparts of the single-process cases of
   ``tests/test_sharded_checkpoint.py``: the commit manifest is written
   last and covers every file; a torn tag is skipped; a checksum failure
   deletes the tag and falls back; an explicit corrupt tag raises; an
   undeletable corrupt tag is refused; a directory without commits
   restores by the newest-tag rule; stale shards of a larger pod are
   ignored; renamed layers, auto-number digit flips and leaves added
   after the save are bridged by name.
2. The formats are the same files: each package's ``restore_sharded``
   reads the other's ``save_sharded``.
3. ``save_model``/``load_model`` and ``Trainer.save_weights``/
   ``load_weights`` both ways between the packages, for a Sequential with
   BatchNormalization under every optimizer name (and momentum, a
   scheduled rate, and both clippings) and for a small TransformerLM:
   the restored weights, layer state and optimizer state are the saved
   ones bit for bit under optax's leaf names, and a state that went
   through the other package trains on bit for bit as the one that
   never left (a lost or misplaced moment would show).  Predictions of
   the two packages from the same state agree within 1e-6 of the
   largest entry for TransformerLM, and within 3e-5 with
   BatchNormalization, whose eval debias the port takes in f64 and the
   JAX package in f32 (``test_torch_layer_set.py``).  The port's earlier
   flat saves still load.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
import jax

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.models import TransformerLM as JTransformerLM
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import load_model as jload_model
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.train import checkpoint as jckpt
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models.jax_params import (to_jax_params,
                                                       to_jax_state)
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras import load_model
from analytics_zoo_tpu_torch.train import checkpoint as ckpt
from analytics_zoo_tpu_torch.train import metrics as train_metrics


def _w(v, shape=(4, 4)):
    return {"w": np.full(shape, v, np.float32)}


def _zeros(shape=(4, 4)):
    return {"w": np.zeros(shape, np.float32)}


def _flip_middle_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


# ---- 1. the protocol -------------------------------------------------------

def test_commit_manifest_written_last_and_covers_all_files(tmp_path):
    tree = {"w": torch.ones(8, 4), "step": np.int32(7)}
    ckpt.save_sharded(str(tmp_path), "c1", tree, meta={"step": 1})
    commit = ckpt.read_commit(str(tmp_path), "c1")
    assert set(commit["files"]) == {"ckpt_c1.shard-p0.npz", "ckpt_c1.json"}
    assert commit["n_processes"] == 1
    for fn, rec in commit["files"].items():
        path = tmp_path / fn
        assert path.stat().st_size == rec["bytes"]
        assert hashlib.sha256(path.read_bytes()).hexdigest() == \
            rec["sha256"]
    assert ckpt.verify_commit(str(tmp_path), "c1", deep=True) == (True, "ok")
    # the commit's mtime is the last of the tag's files
    times = {fn: os.stat(tmp_path / fn).st_mtime_ns
             for fn in os.listdir(tmp_path)}
    assert times["ckpt_c1.commit.json"] == max(times.values())


def test_torn_tag_without_commit_skipped_for_newest_complete(tmp_path):
    ckpt.save_sharded(str(tmp_path), 1, _w(1.0), meta={"step": 1})
    ckpt.save_sharded(str(tmp_path), 2, _w(2.0), meta={"step": 2})
    os.remove(str(tmp_path / "ckpt_2.commit.json"))
    assert ckpt.latest_tag(str(tmp_path)) == "1"
    out = ckpt.restore_sharded(str(tmp_path), _zeros())
    np.testing.assert_array_equal(out["w"], _w(1.0)["w"])
    assert ckpt.read_meta(str(tmp_path)) == {"step": 1}


def test_checksum_mismatch_deletes_tag_and_falls_back(tmp_path):
    train_metrics.reset()
    ckpt.save_sharded(str(tmp_path), 1, _w(1.0), meta={"step": 1})
    ckpt.save_sharded(str(tmp_path), 2, _w(2.0), meta={"step": 2})
    _flip_middle_byte(tmp_path / "ckpt_2.shard-p0.npz")
    out = ckpt.restore_sharded(str(tmp_path), _zeros())
    np.testing.assert_array_equal(out["w"], _w(1.0)["w"])
    assert not any("ckpt_2" in f for f in os.listdir(tmp_path))
    assert train_metrics.snapshot()["ckpt_restores"] == {
        "corrupt_discarded": 1, "ok": 1}
    _flip_middle_byte(tmp_path / "ckpt_1.shard-p0.npz")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_sharded(str(tmp_path), _zeros())


def test_explicit_corrupt_tag_raises_instead_of_fallback(tmp_path):
    ckpt.save_sharded(str(tmp_path), "x", _w(3.0))
    _flip_middle_byte(tmp_path / "ckpt_x.shard-p0.npz")
    with pytest.raises(ValueError, match="commit manifest"):
        ckpt.restore_sharded(str(tmp_path), _zeros(), "x")


def test_undeletable_corrupt_tag_raises_instead_of_spinning(tmp_path,
                                                            monkeypatch):
    ckpt.save_sharded(str(tmp_path), 1, _w(3.0))
    _flip_middle_byte(tmp_path / "ckpt_1.shard-p0.npz")
    monkeypatch.setattr(ckpt, "discard_tag", lambda *a, **k: None)
    with pytest.raises(ValueError, match="could not be removed"):
        ckpt.restore_sharded(str(tmp_path), _zeros())


def test_legacy_directory_without_commits_still_restores(tmp_path):
    ckpt.save_sharded(str(tmp_path), 3, _w(5.0, (2, 2)))
    os.remove(str(tmp_path / "ckpt_3.commit.json"))
    assert ckpt.latest_tag(str(tmp_path)) == "3"
    out = ckpt.restore_sharded(str(tmp_path), _zeros((2, 2)))
    np.testing.assert_array_equal(out["w"], _w(5.0, (2, 2))["w"])


def test_port_flat_save_of_an_earlier_release_restores(tmp_path):
    """The port's earlier saves: flat, no commit, names in the tree's
    insertion order, the optimizer's leaves named by position."""
    names = ["params/d/W", "params/d/b", "opt_state/count",
             "opt_state/states/0/mu/0"]
    arrays = [np.full((2, 3), 4.0, np.float32), np.ones(3, np.float32),
              np.int64(5), np.zeros((2, 3), np.float32)]
    np.savez(str(tmp_path / "ckpt_epoch2.npz"),
             **{f"arr_{i}": a for i, a in enumerate(arrays)})
    (tmp_path / "ckpt_epoch2.json").write_text(json.dumps(
        {"names": names, "tag": "epoch2", "meta": {"epoch": 2}}))
    assert ckpt.latest_tag(str(tmp_path)) == "epoch2"
    out = ckpt.restore_sharded(str(tmp_path), {"params": {"d": {
        "W": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.float32)}}})
    np.testing.assert_array_equal(out["params"]["d"]["W"], arrays[0])


def test_async_save_sharded_copies_now_and_joins(tmp_path):
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    ckpt.async_save_sharded(str(tmp_path), "t3", {"w": w},
                            meta={"step": 1})
    w.add_(100.0)  # the loop updates its tensors in place at once
    ckpt.wait_pending(str(tmp_path))
    out = ckpt.restore_sharded(str(tmp_path), _zeros((8, 4)), "t3")
    np.testing.assert_array_equal(out["w"], np.arange(32).reshape(8, 4))


def test_leaves_are_stored_once_and_missing_data_detected(tmp_path):
    path = ckpt.save_sharded(str(tmp_path), "t4",
                             {"a": np.ones((8, 4), np.float32),
                              "b": np.ones(3, np.float32)})
    with np.load(path) as data:
        assert sorted(data.files) == ["0|0:8,0:4", "1|0:3"]
        kept = {"0|0:8,0:4": data["0|0:8,0:4"]}
    # a shard rewritten without one leaf, under an uncommitted tag (a
    # committed one fails its checksums first)
    np.savez(path, **kept)
    os.remove(str(tmp_path / "ckpt_t4.commit.json"))
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore_sharded(str(tmp_path), {
            "a": np.zeros((8, 4), np.float32),
            "b": np.zeros(3, np.float32)}, "t4")


def test_stale_shards_from_larger_pod_ignored(tmp_path):
    ckpt.save_sharded(str(tmp_path), "t6", {"w": np.ones((4, 4),
                                                          np.float32)})
    np.savez(str(tmp_path / "ckpt_t6.shard-p1.npz"),
             **{"0|0:4,0:4": np.full((4, 4), 99.0, np.float32)})
    out = ckpt.restore_sharded(str(tmp_path), _zeros(), "t6")
    np.testing.assert_array_equal(out["w"], np.ones((4, 4)))


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_restore_fills_post_save_state_leaf_by_name(tmp_path, fmt):
    save = ckpt.save_checkpoint if fmt == "flat" else ckpt.save_sharded
    old = {"params": {"dense": {"W": np.arange(6, dtype=np.float32)
                                .reshape(2, 3)}},
           "model_state": {"bn_7": {
               "moving_mean": np.array([1.0, 2.0], np.float32),
               "moving_var": np.array([3.0, 4.0], np.float32)}}}
    save(str(tmp_path), 1, old)
    template = {"params": {"dense": {"W": np.zeros((2, 3), np.float32)}},
                "model_state": {"bn_7": {
                    "moving_mean": np.zeros(2, np.float32),
                    "moving_var": np.ones(2, np.float32),
                    "count": np.zeros((), np.float32)}}}
    out = ckpt.restore_sharded(str(tmp_path), template, 1)
    np.testing.assert_array_equal(out["params"]["dense"]["W"],
                                  old["params"]["dense"]["W"])
    np.testing.assert_array_equal(
        out["model_state"]["bn_7"]["moving_var"], [3.0, 4.0])
    assert np.isinf(out["model_state"]["bn_7"]["count"])
    template["params"]["dense"]["brand_new_bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no restore default"):
        ckpt.restore_sharded(str(tmp_path), template, 1)


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_restore_survives_autonumber_digit_boundary_flip(tmp_path, fmt):
    save = ckpt.save_checkpoint if fmt == "flat" else ckpt.save_sharded
    w_big = np.arange(32, dtype=np.float32).reshape(8, 4)
    w_small = np.arange(8, dtype=np.float32).reshape(4, 2)
    save(str(tmp_path), 1, {"params": {"dense_99": {"W": w_big},
                                       "dense_100": {"W": w_small}}})
    template = {"params": {
        "dense_101": {"W": np.zeros((8, 4), np.float32)},
        "dense_102": {"W": np.zeros((4, 2), np.float32)}}}
    out = ckpt.restore_sharded(str(tmp_path), template, 1)
    np.testing.assert_array_equal(out["params"]["dense_101"]["W"], w_big)
    np.testing.assert_array_equal(out["params"]["dense_102"]["W"], w_small)


def test_restore_same_shape_stack_keeps_construction_order(tmp_path):
    vals = [np.full((4, 4), v, np.float32) for v in (1.0, 2.0, 3.0)]
    ckpt.save_checkpoint(str(tmp_path), 1, {"params": {
        f"dense_{n}": {"W": v} for n, v in zip((9, 10, 11), vals)}})
    template = {"params": {f"dense_{n}": {"W": np.zeros((4, 4),
                                                        np.float32)}
                           for n in (10, 11, 12)}}
    out = ckpt.restore_sharded(str(tmp_path), template, 1)
    for n, v in zip((10, 11, 12), vals):
        np.testing.assert_array_equal(out["params"][f"dense_{n}"]["W"], v)


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_restore_bridges_renamed_layers(tmp_path, fmt):
    save = ckpt.save_checkpoint if fmt == "flat" else ckpt.save_sharded
    tok = np.arange(12, dtype=np.float32).reshape(4, 3)
    pos = 10.0 * np.arange(6, dtype=np.float32).reshape(2, 3)
    save(str(tmp_path / "a"), 1, {"params": {
        "embedding_1": {"weights": tok},
        "positionalembedding_1": {"weights": pos}}})
    template = {"params": {
        "tok_embed": {"weights": np.zeros((4, 3), np.float32)},
        "pos_embed": {"weights": np.zeros((2, 3), np.float32)}}}
    out = ckpt.restore_sharded(str(tmp_path / "a"), template, 1)
    np.testing.assert_array_equal(out["params"]["tok_embed"]["weights"],
                                  tok)
    np.testing.assert_array_equal(out["params"]["pos_embed"]["weights"],
                                  pos)
    # both spellings saved: the direct match wins
    save(str(tmp_path / "b"), 1, {"params": {
        "embedding_1": {"weights": tok},
        "positionalembedding_1": {"weights": pos},
        "tok_embed": {"weights": 2.0 * tok}}})
    out = ckpt.restore_sharded(str(tmp_path / "b"), {"params": {
        "tok_embed": {"weights": np.zeros((4, 3), np.float32)}}}, 1)
    np.testing.assert_array_equal(out["params"]["tok_embed"]["weights"],
                                  2.0 * tok)
    # without the whole migration signature the aliases stay inert
    save(str(tmp_path / "c"), 1, {"params": {
        "embedding_1": {"weights": tok}}})
    with pytest.raises(ValueError, match="no restore default"):
        ckpt.restore_sharded(str(tmp_path / "c"), {"params": {
            "tok_embed": {"weights": np.zeros((4, 3), np.float32)}}}, 1)


# ---- 2. the same files -----------------------------------------------------

def _tree(rng):
    return {"params": {"dense_1": {"W": rng.normal(size=(3, 4)).astype(
        np.float32), "b": rng.normal(size=4).astype(np.float32)}},
        "opt_state": [{".count": np.int32(3),
                       ".mu": {"dense_1": {"W": np.ones((3, 4),
                                                        np.float32)}}}]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_sharded_files(tmp_path, writer):
    tree = _tree(np.random.default_rng(0))
    save = ckpt.save_sharded if writer == "port" else jckpt.save_sharded
    save(str(tmp_path), 5, tree, meta={"step": 5, "epoch": 1})
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    mine = ckpt.restore_sharded(str(tmp_path), zeros)
    theirs = jckpt.restore_sharded(str(tmp_path), zeros)
    for got in (mine, theirs):
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(tree)[0],
                jax.tree_util.tree_flatten_with_path(got)[0]):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(pa))
    assert ckpt.read_meta(str(tmp_path)) == jckpt.read_meta(
        str(tmp_path)) == {"step": 5, "epoch": 1}
    with open(tmp_path / "ckpt_5.json") as f:
        manifest = json.load(f)
    assert manifest["names"] == jckpt._leaf_names(tree)
    assert manifest["format"] == "sharded"
    assert ckpt.verify_commit(str(tmp_path), 5, deep=True)[0]
    assert jckpt.verify_commit(str(tmp_path), 5, deep=True)[0]


# ---- 3. models across the packages -----------------------------------------

#: every optimizer name, and the variants that move optax's state
OPTIMIZERS = ["sgd", "adam", "adamax", "adagrad", "adadelta", "rmsprop",
              "adamw", "lamb", "lars",
              {"name": "sgd", "lr": 0.05, "momentum": 0.9},
              {"name": "rmsprop", "lr": 1e-3, "momentum": 0.5},
              {"name": "adam", "lr": 1e-2, "decay": 0.1},
              {"name": "sgd", "lr": 0.05, "decay": 0.1}]


def _opt_id(o):
    return o if isinstance(o, str) else "-".join(
        f"{k}{v}" for k, v in o.items())


def _data(n=32):
    rs = np.random.RandomState(0)
    return (rs.rand(n, 4).astype(np.float32),
            rs.randint(0, 3, n).astype(np.int32))


def _jax_seq(opt, clip):
    with jname_scope("m"):
        m = JSequential()
        m.add(JL.Dense(8, activation="relu", input_shape=(4,)))
        m.add(JL.BatchNormalization())
        m.add(JL.Dense(3, activation="softmax"))
    if clip:
        m.set_gradient_clipping_by_l2_norm(1.0)
        m.set_constant_gradient_clipping(-0.5, 0.5)
    m.compile(optimizer=opt, loss="sparse_categorical_crossentropy")
    return m


def _port_seq(opt, clip):
    with name_scope("m"):
        m = Sequential(device="cpu", seed=3)
        m.add(L.Dense(8, activation="relu", input_shape=(4,)))
        m.add(L.BatchNormalization())
        m.add(L.Dense(3, activation="softmax"))
    if clip:
        m.set_gradient_clipping_by_l2_norm(1.0)
        m.set_constant_gradient_clipping(-0.5, 0.5)
    m.compile(optimizer=opt, loss="sparse_categorical_crossentropy")
    return m


def _jax_leaves(jm):
    tree = jax.device_get(jm.trainer.state.as_tree())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jckpt._path_name(p): np.asarray(v) for p, v in flat}


def _port_leaves(tm):
    names, leaves = ckpt._flatten(tm.trainer.state_tree())
    return {n: ckpt._host(v) for n, v in zip(names, leaves)}


def _assert_same_state(jm, tm):
    """Every leaf of the two packages' training states, by name: the
    same names, and bit-equal values."""
    jl, tl = _jax_leaves(jm), _port_leaves(tm)
    assert sorted(jl) == sorted(tl)
    for name in jl:
        np.testing.assert_array_equal(tl[name], jl[name], err_msg=name)
    assert jm.trainer.state.step == tm.trainer.state.step
    assert jm.trainer.state.epoch == tm.trainer.state.epoch


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


#: predictions of the two packages from the same state, over the largest
#: entry: BatchNormalization's eval debias is f64 in the port and f32 in
#: the JAX package, and magnifies the last bit 13-fold at count 8
BN_PREDICT_TOL = 3e-5


@pytest.mark.parametrize("opt", OPTIMIZERS, ids=_opt_id)
def test_sequential_with_batchnorm_saves_load_across_packages(tmp_path,
                                                              opt):
    """Each package loads the other's ``save_model`` to the same state,
    bit for bit, under optax's leaf names; and a state that went through
    the other package trains on exactly as the one that never left
    (a moment lost or misplaced on the way would show)."""
    x, y = _data()
    jm = _jax_seq(opt, False)
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    jm.save_model(str(tmp_path / "jax"))
    tm = load_model(str(tmp_path / "jax"), device="cpu")
    _assert_same_state(jm, tm)
    _close(tm.predict(x), jm.predict(x), BN_PREDICT_TOL)
    tm.save_model(str(tmp_path / "back"))
    jback = jload_model(str(tmp_path / "back"))
    _assert_same_state(jback, tm)
    for m in (jm, jback):
        m.fit(x, y, batch_size=8, nb_epoch=1)
    for a, b in zip(jax.tree_util.tree_leaves(jm.trainer.state.as_tree()),
                    jax.tree_util.tree_leaves(
                        jback.trainer.state.as_tree())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    tm2 = _port_seq(opt, False)
    tm2.fit(x, y, batch_size=8, nb_epoch=2)
    tm2.save_model(str(tmp_path / "port"))
    jm2 = jload_model(str(tmp_path / "port"))
    _assert_same_state(jm2, tm2)
    _close(jm2.predict(x), tm2.predict(x), BN_PREDICT_TOL)
    jm2.save_model(str(tmp_path / "forth"))
    tforth = load_model(str(tmp_path / "forth"), device="cpu")
    for m in (tm2, tforth):
        m.fit(x, y, batch_size=8, nb_epoch=1)
    a, b = _port_leaves(tm2), _port_leaves(tforth)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


LM = dict(vocab_size=24, seq_len=12, n_layers=2, d_model=16, n_heads=2)


def _lm_data(n=16):
    rng = np.random.default_rng(1)
    x = rng.integers(0, LM["vocab_size"], (n, LM["seq_len"])).astype(
        np.int32)
    return x, (x + 1) % LM["vocab_size"]


def test_transformer_lm_saves_load_across_packages(tmp_path):
    x, y = _lm_data()
    jm = JTransformerLM(**LM, remat=True)
    jm.compile({"name": "adam", "lr": 3e-3}, "class_nll", seed=0)
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    jm.save_model(str(tmp_path / "jax"))
    tm = load_model(str(tmp_path / "jax"), device="cpu")
    assert tm.hyper["remat"] is True and tm.attn_0.remat
    _assert_same_state(jm, tm)
    _close(tm.predict(x), jm.predict(x), 1e-6)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.save_model(str(tmp_path / "port"))
    jm2 = jload_model(str(tmp_path / "port"))
    _assert_same_state(jm2, tm)
    _close(jm2.predict(x), tm.predict(x), 1e-6)


def _legacy_flat_save(directory, tag, tree, meta=None):
    """The port's earlier flat writer: leaves in the tree's insertion
    order, no commit manifest."""
    names, leaves = [], []

    def walk(t, prefix):
        items = t.items() if isinstance(t, dict) else enumerate(t)
        for k, v in items:
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, (dict, list, tuple)):
                walk(v, name)
            elif v is not None:
                names.append(name)
                leaves.append(ckpt._host(v))

    walk(tree, "")
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, f"ckpt_{tag}.npz"),
             **{f"arr_{i}": a for i, a in enumerate(leaves)})
    with open(os.path.join(directory, f"ckpt_{tag}.json"), "w") as f:
        json.dump({"names": names, "tag": str(tag), "meta": meta or {}}, f)


def test_earlier_port_saves_still_load(tmp_path):
    """A model saved by the port's earlier ``save_model`` (weights and
    layer state, flat) and an epoch snapshot of its earlier trainer (the
    optimizer's leaves by position: ``opt_state/count``,
    ``opt_state/states/0/mu/0``) load into today's model and trainer."""
    from analytics_zoo_tpu_torch.models.jax_params import model_tree
    x, y = _data()
    tm = _port_seq("adam", False)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.save_model(str(tmp_path / "new"))
    legacy = tmp_path / "old"
    os.makedirs(legacy)
    os.replace(str(tmp_path / "new" / "architecture.json"),
               str(legacy / "architecture.json"))
    _legacy_flat_save(str(legacy / "weights"), "final", model_tree(tm))
    back = load_model(str(legacy), device="cpu")
    np.testing.assert_array_equal(back.predict(x), tm.predict(x))

    st = tm.trainer.state
    _legacy_flat_save(str(tmp_path / "ckpts"), "epoch1", {
        "params": to_jax_params(tm), "model_state": to_jax_state(tm),
        "opt_state": {"count": np.int64(st.opt_state.count),
                      "states": st.opt_state.states}},
        meta={"step": st.step, "epoch": st.epoch})
    fresh = _port_seq("adam", False)
    fresh.trainer.load_weights(str(tmp_path / "ckpts"))
    assert fresh.trainer.state.opt_state.count == 4
    assert fresh.trainer.state.epoch == 1
    a, b = _port_leaves(tm), _port_leaves(fresh)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
