"""Parameter sharding rules: a tree of leaves -> a tree of specs.

Counterpart of ``analytics_zoo_tpu/parallel/sharding.py``, with the JAX
package's rule tables and their tie-breaks:

* ``fsdp`` (ZeRO): every leaf of at least ``min_size`` elements is split
  over the ``fsdp`` axis along its largest dimension divisible by the
  axis size (ties go to the earliest dimension); rank-0 and small leaves
  replicate;
* ``tensor``: megatron-style rules, a regex over the leaf's
  ``"/"``-joined path mapped to the dimension split over ``tensor``;
* ``combine_spec_trees``: both on one leaf, the overlay's axes winning;
* ``opt_state_sharding_tree``: each optimizer moment with its parameter.

The rules are pure functions of the leaves' shapes and the mesh's axis
sizes (a ``DeviceMesh`` or a plain ``{axis: size}`` mapping): they make
no collective and need no process group.  They return, per leaf, a
:class:`P`: a tuple holding per dimension the mesh axis it is split
over, or None (``jax.sharding.PartitionSpec``'s vocabulary; ``P()`` is
replicated).  :func:`spec_to_placements` turns a spec into DTensor
placements on a ``DeviceMesh``, and :func:`local_shard` /
:func:`gather_shard` cut a whole tensor into this rank's block and put
the blocks back together.

A tree is nested dicts, lists and tuples (named tuples too); everything
else is a leaf.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional

import numpy as np

from .mesh import axis_sizes


class P(tuple):
    """A partition spec: per dimension a mesh axis name, a tuple of
    axis names (major first), or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple)) and not isinstance(t, P)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in tree)
    if _is_node(tree):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):  # a named tuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _key_str(tree, key) -> str:
    """A path entry as ``jax.tree_util``'s keys print (``str(key)``):
    ``['name']`` for a dict key, ``.field`` for a named tuple's field,
    ``[i]`` for a sequence index."""
    if isinstance(tree, dict):
        return f"[{key!r}]"
    if hasattr(tree, "_fields"):
        return f".{tree._fields[key]}"
    return f"[{key}]"


def _path_name(tree, key) -> str:
    """A path entry as the JAX package joins leaf paths with ``/``
    (``getattr(k, "key", k)``: a dict key bare, the rest as printed)."""
    return str(key) if isinstance(tree, dict) else _key_str(tree, key)


def flatten_with_path(tree, prefix=()):
    """[(path, leaf)] in ``jax.tree_util`` order (dict keys sorted),
    each path a tuple of (node, key) pairs."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif _is_node(tree):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, sub in items:
        out += flatten_with_path(sub, prefix + ((tree, k),))
    return out


def leaf_path(path) -> str:
    """The ``"/"``-joined leaf path the tensor-parallel rules match."""
    return "/".join(_path_name(node, k) for node, k in path)


def unflatten(tree, leaves):
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return type(t)((k, rebuild(t[k])) for k in sorted(t))
        if _is_node(t):
            out = [rebuild(s) for s in t]
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)

    return rebuild(tree)


def replicated_tree(params, mesh=None):
    return tree_map(lambda _: P(), params)


def fsdp_tree(params, mesh, axis: str = "fsdp", min_size: int = 2 ** 14):
    """Split each large leaf along its largest axis divisible by the
    fsdp axis size; small leaves stay replicated (gather cost > memory
    win)."""
    n = axis_sizes(mesh).get(axis, 1)
    if n == 1:
        return replicated_tree(params, mesh)

    def rule(p):
        shape = np.shape(p)
        if len(shape) == 0:
            return P()
        if np.prod(shape, dtype=np.int64) < min_size:
            return P()
        # largest divisible axis; ties to the EARLIEST dim, so a square
        # kernel shards the same axis on every process
        cands = [(d, i) for i, d in enumerate(shape) if d % n == 0]
        if not cands:
            return P()
        _, idx = min(cands, key=lambda c: (-c[0], c[1]))
        spec = [None] * len(shape)
        spec[idx] = axis
        return P(*spec)

    return tree_map(rule, params)


def tensor_parallel_tree(params, mesh, rules: Dict[str, Any],
                         axis: str = "tensor"):
    """Megatron-style rules: the first regex (in ``rules``' order) that
    matches a leaf's ``"/"``-joined path names the dimension split over
    ``tensor``, when that dimension divides the axis size.  Unmatched
    leaves replicate."""
    n = axis_sizes(mesh).get(axis, 1)
    if n == 1:
        return replicated_tree(params, mesh)
    out = []
    for path, leaf in flatten_with_path(params):
        name = leaf_path(path)
        spec = P()
        for pattern, dim in rules.items():
            if re.search(pattern, name):
                shape = np.shape(leaf)
                if len(shape) > dim and shape[dim] % n == 0:
                    entries = [None] * len(shape)
                    entries[dim] = axis
                    spec = P(*entries)
                break
        out.append(spec)
    return unflatten(params, out)


def _axes_of(spec) -> set:
    out = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            out.update(entry)
        else:
            out.add(entry)
    return out


def combine_spec_trees(base, overlay):
    """Per-dimension merge of two spec trees: the overlay's axes win on
    the dims they name, the base fills the others unless it would reuse
    an axis the overlay took (a spec names an axis once).  A Dense
    kernel under fsdp_tp becomes ``P('fsdp', 'tensor')``."""

    def combine(b, o):
        if o == P():
            return b
        if b == P():
            return o
        bspec, ospec = list(b), list(o)
        rank = max(len(bspec), len(ospec))
        bspec += [None] * (rank - len(bspec))
        ospec += [None] * (rank - len(ospec))
        taken = _axes_of(ospec)
        out = []
        for bb, oo in zip(bspec, ospec):
            if oo is not None:
                out.append(oo)
            elif bb is not None and not (_axes_of([bb]) & taken):
                out.append(bb)
            else:
                out.append(None)
        return P(*out)

    return tree_map(combine, base, overlay)


def opt_state_sharding_tree(opt_state, params, param_shardings, mesh=None):
    """ZeRO: each optimizer-state leaf whose key path ENDS with a
    parameter's path (the deepest such suffix) and whose shape matches
    takes that parameter's spec; every other leaf (counts, schedule
    scalars) replicates.  ``opt_state`` is the optimizer state as a tree
    (the port's ``ZooOptimizer.state_tree``, optax's layout)."""
    by_path: Dict[tuple, Any] = {}
    spec_leaves = [s for _, s in flatten_with_path(param_shardings)]
    for (path, leaf), spec in zip(flatten_with_path(params), spec_leaves):
        key = tuple(_key_str(node, k) for node, k in path)
        by_path[key] = (tuple(np.shape(leaf)), spec)
    out = []
    for path, leaf in flatten_with_path(opt_state):
        keys = tuple(_key_str(node, k) for node, k in path)
        shape = tuple(np.shape(leaf))
        spec = P()
        for klen in range(len(keys), 0, -1):
            hit = by_path.get(keys[-klen:])
            if hit is not None and hit[0] == shape:
                spec = hit[1]
                break
        out.append(spec)
    return unflatten(opt_state, out)


def shard_params(params, mesh, strategy: str = "replicate",
                 tp_rules: Optional[Dict[str, int]] = None,
                 fsdp_min_size: int = 2 ** 14):
    """Resolve a named strategy into a spec tree."""
    if strategy in ("replicate", "dp"):
        return replicated_tree(params, mesh)
    if strategy == "fsdp":
        return fsdp_tree(params, mesh, min_size=fsdp_min_size)
    if strategy in ("tp", "tensor"):
        return tensor_parallel_tree(params, mesh, tp_rules or {})
    if strategy in ("fsdp_tp", "fsdp+tp"):
        return combine_spec_trees(
            fsdp_tree(params, mesh, min_size=fsdp_min_size),
            tensor_parallel_tree(params, mesh, tp_rules or {}))
    raise ValueError(f"Unknown sharding strategy {strategy!r}")


# ------------------------------------------------ specs on a DeviceMesh

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on each mesh dim that splits tensor dim ``d``, ``Replicate()`` on
    the others.  A dim split over several axes needs them in the mesh's
    dim order (DTensor splits in that order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} "
                             f"are not in the mesh's order {names}")
        for i in order:
            placements[i] = Shard(d)
    return tuple(placements)


def placed_shape(local_shape, spec, mesh) -> tuple:
    """The global shape of a block of ``local_shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    shape = list(local_shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            shape[d] *= sizes.get(a, 1)
    return tuple(shape)


def to_dtensor(local, spec, mesh):
    """``local`` (this rank's block under ``spec``) as the DTensor on
    ``mesh``, sharing its storage: no data moves."""
    import torch
    from torch.distributed.tensor import DTensor
    shape = torch.Size(placed_shape(local.shape, spec, mesh))
    return DTensor.from_local(
        local.detach(), mesh, spec_to_placements(spec, mesh),
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _block(spec, sizes, coords, shape):
    """The index tuple of this rank's block of a leaf of ``shape``."""
    index = []
    for d, dim in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        n, k = 1, 0
        for a in axes:
            n, k = n * sizes[a], k * sizes[a] + coords[a]
        step = dim // n
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index)


def local_shard(full, spec, mesh):
    """This rank's block of a whole (replicated) tensor under ``spec``,
    as a new contiguous tensor."""
    from .mesh import axis_index
    sizes = axis_sizes(mesh)
    coords = {a: axis_index(mesh, a) for a in sizes}
    return full[_block(spec, sizes, coords, full.shape)].contiguous()


def block_index(spec, mesh, shape):
    """This rank's block of a leaf of global ``shape`` as slices."""
    from .mesh import axis_index
    sizes = axis_sizes(mesh)
    coords = {a: axis_index(mesh, a) for a in sizes}
    return _block(spec, sizes, coords, shape)


def gather_shard(local, spec, mesh, keep_axes=()):
    """The whole tensor from the ranks' blocks under ``spec`` (all-gather
    over each axis that splits a dim), leaving split the dims over
    ``keep_axes``.  Collective over those axes' groups; no autograd."""
    import torch.distributed as dist
    from .mesh import group_over
    out = local
    for d, entry in enumerate(spec):
        # innermost (minor) axis first: each gather rebuilds one level
        for a in reversed(_entry_axes(entry)):
            if a in keep_axes:
                continue
            group = group_over(mesh, (a,))
            if group is None:
                continue
            from ._compat import _gather
            out = _gather(out, group, dist.get_world_size(group), d)
    return out


def dtensor_sharding(leaf):
    """The ``NamedSharding`` of a DTensor (its mesh and the spec of its
    placements); None for anything else."""
    from torch.distributed.tensor import DTensor, Shard
    from .mesh import NamedSharding
    if not isinstance(leaf, DTensor):
        return None
    mesh = leaf.device_mesh
    entries = [[] for _ in range(leaf.dim())]
    for name, pl in zip(mesh.mesh_dim_names, leaf.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return NamedSharding(mesh, P(*(None if not e else e[0] if len(e) == 1
                                   else tuple(e) for e in entries)))
