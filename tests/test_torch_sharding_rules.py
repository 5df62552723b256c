"""The port's sharding rule tables (``analytics_zoo_tpu_torch/parallel/
sharding.py``) against the JAX package's, in one process.

The rules are pure functions of leaf shapes and axis sizes, so the same
shapes go through both packages and the specs must be equal leaf by
leaf: the counterparts of ``tests/test_sharding_rules.py`` and of the
rule cases of ``tests/test_attention_parallel.py``, then every leaf of
the JAX package's parameter trees of TransformerLM (with and without
MoE blocks) and ResNet-50 under ``fsdp``, ``tp`` and ``fsdp_tp`` on
meshes {data 2, fsdp 4} and {data 2, fsdp 2, tensor 2}, and adam's
moments through ``opt_state_sharding_tree``.  The port takes a mapping
of axis sizes where the JAX package takes a mesh of the 8 virtual CPU
devices.
"""

import numpy as np
import optax
import jax
import pytest
import torch
from jax.sharding import NamedSharding

from analytics_zoo_tpu.parallel import mesh as jmesh
from analytics_zoo_tpu.parallel import sharding as jsh
from analytics_zoo_tpu_torch.parallel import sharding as tsh
from analytics_zoo_tpu_torch.parallel.mesh import (data_sharding, dp_size,
                                                   replicated)
from analytics_zoo_tpu_torch.parallel.sharding import P
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers

FSDP2 = {"data": 4, "fsdp": 2}
FULL = {"data": 2, "fsdp": 2, "tensor": 2}

LM_RULES = {r"attn_\d+/W[qkv]$": 1, r"attn_\d+/Wo$": 0,
            r"mlp_up_\d+/W$": 1, r"mlp_down_\d+/W$": 0}
RESNET_RULES = {r"fc1000/W": 1}


# ---------------------------------------------------------------- fsdp


def test_fsdp_picks_largest_divisible_axis():
    tree = tsh.fsdp_tree({"w": np.zeros((64, 256, 2))}, FSDP2, min_size=1)
    assert tree["w"] == P(None, "fsdp", None)


def test_fsdp_tie_breaks_toward_earliest_dim():
    tree = tsh.fsdp_tree({"sq": np.zeros((128, 128)),
                          "cube": np.zeros((4, 64, 64))}, FSDP2,
                         min_size=1)
    assert tree["sq"] == P("fsdp", None)
    assert tree["cube"] == P(None, "fsdp", None)


def test_fsdp_prefers_size_over_position():
    tree = tsh.fsdp_tree({"a": np.zeros((64, 128)),
                          "b": np.zeros((128, 64))}, FSDP2, min_size=1)
    assert tree["a"] == P(None, "fsdp")
    assert tree["b"] == P("fsdp", None)


def test_fsdp_rank0_and_small_leaves_replicate():
    tree = tsh.fsdp_tree({"gain": np.float32(3.0),
                          "tiny": np.zeros((8,))}, FSDP2, min_size=16)
    assert tree["gain"] == P() and tree["tiny"] == P()
    zero = tsh.fsdp_tree({"gain": np.float32(1.0)}, FSDP2, min_size=0)
    assert zero["gain"] == P()


def test_fsdp_no_divisible_axis_replicates():
    tree = tsh.fsdp_tree({"odd": np.zeros((3, 5))}, FSDP2, min_size=1)
    assert tree["odd"] == P()


def test_fsdp_absent_or_unit_axis_replicates_all():
    for sizes in ({"data": 8}, {"data": 8, "fsdp": 1}):
        tree = tsh.fsdp_tree({"w": np.zeros((64, 64))}, sizes, min_size=1)
        assert tree["w"] == P()


# --------------------------------------------------- combine_spec_trees


def test_combine_fsdp_and_tp_on_same_kernel():
    out = tsh.combine_spec_trees({"W": P("fsdp", None)},
                                 {"W": P(None, "tensor")})
    assert out["W"] == P("fsdp", "tensor")


def test_combine_collision_drops_base_axis():
    out = tsh.combine_spec_trees({"W": P("tensor", None)},
                                 {"W": P(None, "tensor")})
    assert out["W"] == P(None, "tensor")


def test_combine_pads_mismatched_rank_specs():
    out = tsh.combine_spec_trees({"W": P("fsdp")}, {"W": P(None, "tensor")})
    assert out["W"] == P("fsdp", "tensor")
    out2 = tsh.combine_spec_trees({"W": P(None, "fsdp")},
                                  {"W": P("tensor")})
    assert out2["W"] == P("tensor", "fsdp")


def test_combine_empty_side_passes_other_through():
    assert tsh.combine_spec_trees({"a": P("fsdp", None)},
                                  {"a": P()})["a"] == P("fsdp", None)
    assert tsh.combine_spec_trees({"a": P()},
                                  {"a": P("fsdp", None)})["a"] \
        == P("fsdp", None)


def test_shard_params_fsdp_tp_end_to_end():
    params = {"dense": {"W": np.zeros((256, 128)), "b": np.zeros((128,))}}
    tree = tsh.shard_params(params, FULL, "fsdp_tp", tp_rules={r"W$": 1},
                            fsdp_min_size=1)
    assert tree["dense"]["W"] == P("fsdp", "tensor")
    assert tree["dense"]["b"] == P("fsdp")


def test_tensor_rules_skip_non_divisible_dims():
    tree = tsh.tensor_parallel_tree({"W": np.zeros((6, 7))}, FULL,
                                    {r"W$": 1})
    assert tree["W"] == P()


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="Unknown sharding strategy"):
        tsh.shard_params({"W": np.zeros((4, 4))}, FULL, "zero3")


# ------------------------------------------------ opt_state_sharding


def _port_opt_tree(params, name="adam"):
    """The port's optimizer state as optax's tree (meta tensors: shapes
    only) for a {layer: {param: leaf}} tree."""
    flat = tsh.flatten_with_path(params)
    paths = [tuple(k for _, k in path) for path, _ in flat]
    metas = [torch.empty(np.shape(l), device="meta") for _, l in flat]
    opt = optimizers.get(name)
    return opt.state_tree(opt.init(metas), paths)


def test_opt_state_moments_follow_their_params():
    params = {"dense": {"W": np.zeros((256, 128)), "b": np.zeros((128,))}}
    shardings = tsh.fsdp_tree(params, FSDP2, min_size=1)
    plan = tsh.opt_state_sharding_tree(_port_opt_tree(params), params,
                                       shardings, FSDP2)
    assert plan["0"][".mu"]["dense"]["W"] == P("fsdp", None)
    assert plan["0"][".nu"]["dense"]["W"] == P("fsdp", None)
    assert plan["0"][".count"] == P()


def test_opt_state_shape_mismatch_replicates():
    params = {"W": np.zeros((256, 128))}
    shardings = tsh.fsdp_tree(params, FSDP2, min_size=1)
    fake_state = {"mu": {"W": np.zeros((256, 128))},
                  "buf": {"W": np.zeros((3,))}}
    plan = tsh.opt_state_sharding_tree(fake_state, params, shardings, FSDP2)
    assert plan["mu"]["W"] == P("fsdp", None)
    assert plan["buf"]["W"] == P()


def test_opt_state_replicated_params_replicate_everything():
    params = {"W": np.zeros((64, 64))}
    shardings = tsh.replicated_tree(params, FSDP2)
    plan = tsh.opt_state_sharding_tree(
        _port_opt_tree(params, {"name": "sgd", "momentum": 0.9}), params,
        shardings, FSDP2)
    assert all(s == P() for _, s in tsh.flatten_with_path(plan))


# ----------------------------------- counterparts of the attention file


def test_fsdp_sharding_rules():
    tree = tsh.fsdp_tree({"big": np.zeros((512, 64)),
                          "small": np.zeros((4, 4))},
                         {"data": 2, "fsdp": 4}, min_size=1024)
    assert tree["big"] == P("fsdp", None)
    assert tree["small"] == P()


def test_tensor_parallel_rules():
    params = {"layer1": {"W": np.zeros((64, 32)), "b": np.zeros((32,))},
              "other": {"W": np.zeros((64, 32))}}
    tree = tsh.tensor_parallel_tree(params, {"data": 4, "tensor": 2},
                                    {r"layer1/W": 1})
    assert tree["layer1"]["W"] == P(None, "tensor")
    assert tree["layer1"]["b"] == P()
    assert tree["other"]["W"] == P()


# ------------------------------------------------------- mesh helpers


def test_data_sharding_and_dp_size_follow_present_axes():
    assert data_sharding(FULL).spec == (("data", "fsdp"),)
    assert data_sharding({"tensor": 2, "data": 1}).spec == ()
    assert replicated(FULL).spec == ()
    assert dp_size(FULL) == 4 and dp_size({"seq": 4}) == 1


def test_spec_to_placements_on_named_dims():
    from torch.distributed.tensor import Replicate, Shard

    class Names:  # the placements read only the mesh's dim names
        mesh_dim_names = ("data", "fsdp", "tensor", "seq", "expert",
                          "pipe")

    got = tsh.spec_to_placements(P("fsdp", "tensor"), Names())
    assert got == (Replicate(), Shard(0), Shard(1), Replicate(),
                   Replicate(), Replicate())
    batch = tsh.spec_to_placements(P(("data", "fsdp")), Names())
    assert batch[:2] == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.spec_to_placements(P(("fsdp", "data")), Names())


def test_local_shard_blocks_tile_the_leaf():
    """Every rank's block under P('fsdp', 'tensor') on {fsdp 2, tensor
    2}, put back in place, rebuilds the leaf exactly once."""
    full = torch.arange(8 * 6.).reshape(8, 6)
    sizes = {"fsdp": 2, "tensor": 2}
    seen = torch.zeros_like(full)
    for f in range(2):
        for t in range(2):
            idx = tsh._block(P("fsdp", "tensor"), sizes,
                             {"fsdp": f, "tensor": t}, full.shape)
            seen[idx] += full[idx]
    assert torch.equal(seen, full)


# ------------------------------- whole parameter trees, leaf by leaf


def _jax_tree(model: str):
    from analytics_zoo_tpu.models.textgeneration import TransformerLM
    from analytics_zoo_tpu.models.image.classification import resnet50
    if model == "resnet50":
        graph = resnet50().to_graph()
    else:
        graph = TransformerLM(
            vocab_size=32000, seq_len=2048, n_layers=2, d_model=768,
            n_heads=12, moe_every=2 if model == "lm_moe" else None
        ).to_graph()
    params, _ = jax.eval_shape(lambda r: graph.init(r),
                               jax.random.PRNGKey(0))
    return params


_TREES = {}


def _trees(model):
    """(JAX shape tree, the same tree of zero-stride numpy leaves)."""
    if model not in _TREES:
        jtree = _jax_tree(model)
        ttree = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), jtree)
        _TREES[model] = (jtree, ttree)
    return _TREES[model]


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda l: isinstance(l, NamedSharding))[0]
    return {_name(path): tuple(sh.spec) for path, sh in flat}


def _name(path):
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "name"):
            parts.append("." + k.name)
        else:
            parts.append(str(k.idx))
    return "/".join(parts)


def _port_specs(tree):
    return {"/".join(str(k) for _, k in path): tuple(spec)
            for path, spec in tsh.flatten_with_path(tree)}


def _strategy_args(model, strategy):
    rules = RESNET_RULES if model == "resnet50" else LM_RULES
    return {"tp_rules": rules} if strategy != "fsdp" else {}


MODELS = ("lm", "lm_moe", "resnet50")
STRATEGIES = ("fsdp", "tp", "fsdp_tp")
MESHES = {"data2_fsdp4": {"data": 2, "fsdp": 4},
          "data2_fsdp2_tensor2": {"data": 2, "fsdp": 2, "tensor": 2}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", MODELS)
def test_param_specs_equal_jax_leaf_by_leaf(model, strategy, mesh_name):
    axes = MESHES[mesh_name]
    jtree, ttree = _trees(model)
    jm = jmesh.create_mesh(axes)
    want = _jax_specs(jsh.shard_params(jtree, jm, strategy,
                                       **_strategy_args(model, strategy)))
    got = _port_specs(tsh.shard_params(ttree, axes, strategy,
                                       **_strategy_args(model, strategy)))
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff
    # a strategy splits something wherever its mesh axis exists
    splits = any(s for s in got.values())
    assert splits == (strategy != "tp" or "tensor" in axes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", MODELS)
def test_adam_moment_specs_equal_jax(model, strategy, mesh_name):
    axes = MESHES[mesh_name]
    jtree, ttree = _trees(model)
    jm = jmesh.create_mesh(axes)
    kw = _strategy_args(model, strategy)
    jspecs = jsh.shard_params(jtree, jm, strategy, **kw)
    jopt = jax.eval_shape(optax.adam(1e-3).init, jtree)
    want = _jax_specs(jsh.opt_state_sharding_tree(jopt, jtree, jspecs, jm))
    tspecs = tsh.shard_params(ttree, axes, strategy, **kw)
    topt = _port_opt_tree(ttree)
    got = _port_specs(tsh.opt_state_sharding_tree(topt, ttree, tspecs,
                                                  axes))
    # optax keeps an EmptyState for the rate (no leaves); the moments
    # and the count are the leaves of both
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}
    moments = [k for k in got if "/.mu/" in k or "/.nu/" in k]
    assert len(moments) == 2 * len(_port_specs(tspecs))
    assert any(got[k] for k in moments) == (strategy != "tp"
                                            or "tensor" in axes)


def test_port_lm_leaf_paths_match_jax():
    """The tp rules name the port's TransformerLM leaves by the JAX
    package's paths: both trees hold the same paths and shapes."""
    from analytics_zoo_tpu.models.textgeneration import (
        TransformerLM as JLM)
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.models.jax_params import weight_tree
    kw = dict(vocab_size=64, seq_len=8, n_layers=2, d_model=16, n_heads=2,
              moe_every=2, n_experts=2)
    port = weight_tree(TransformerLM(device="cpu", **kw))
    jtree, _ = jax.eval_shape(lambda r: JLM(**kw).to_graph().init(r),
                              jax.random.PRNGKey(0))
    got = {"/".join(str(k) for _, k in path): tuple(leaf.shape)
           for path, leaf in tsh.flatten_with_path(port)}
    want = {_name(path): tuple(l.shape) for path, l in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert got == want
