"""Sharded serving: replica GROUPS over device sub-meshes.

Counterpart of ``analytics_zoo_tpu/serving/shardgroup.py``.  A
:class:`ShardGroupSet` generalizes the ``ReplicaSet`` contract to M
replica *groups*: each group is a tuple of devices with a small mesh
over them (:class:`GroupMesh`), and the model's weight tree is sharded
across the group's devices by a declarative rule table
(:mod:`analytics_zoo_tpu_torch.parallel.sharding`).  Scheduling, health
probing, elasticity, hedging and in-flight accounting are inherited: a
group IS a replica to every caller (``ShardGroup`` subclasses
``Replica``; ``group.device`` is the group's first device).

A serving group lives in one process and has no process group: its
mesh is an in-process object (axis names, sizes and the member devices
in row-major order), not a ``torch.distributed`` ``DeviceMesh``.

* **Placement.**  At rest each member device holds only its block of
  every leaf, cut by ``parallel/sharding.py``'s ``_block`` from the
  member's coordinates; a replicated leaf is whole on every member.
* **Dispatch gathers on use.**  The forward runs on the group's first
  device, on the group's stream.  For a module (``InferenceModel``'s
  nets) each layer's leaves are gathered there when the layer is called,
  by peer copies of the members' blocks, and freed when it returns, so
  the executing device holds its own blocks plus about one gathered
  layer, not the whole model.  A bare ``fn(params, x)`` has no layer to
  gather at: its whole tree is gathered for the call and freed after,
  so its peak is the whole model plus the first member's blocks, and
  the set logs a ``shardgroup_whole_tree_gather`` warning when it is
  built.  Give the function its module as ``fn.module`` (as
  ``InferenceModel``'s ``module_forward`` does) to gather by layer.
* **Why gather, not XLA's scheme.**  XLA partitions the forward so that
  each device contracts its own columns and the outputs are all-gathered
  (bit-exact under column rules, not under row rules, whose partial sums
  are added in another order).  A generic torch ``fn(params, x)`` cannot
  be partitioned that way without DTensor, which needs one process a
  device.  Gathering on use runs the unsharded program on the whole
  weights, so a group gives the single-device floats by construction,
  under column and row rules alike.
* **Builds.**  "Compile once, place everywhere" is "build on group 0,
  place on every other group": a signature's first run on group 0 is its
  one build (``profile.note_compile``), and its first run on every other
  group, or on a group that joins later, is a placement, which counts no
  build.
* ``devices`` may repeat a card (``["cuda:0", "cuda:0"]``): that is how
  one card runs a group of two, each member's blocks a separate copy.

The mesh spec (:func:`normalize_mesh_spec`) is a small JSON-safe dict,
so it rides the deploy keywords end to end: ``InferenceModel(mesh=...)``,
``ModelRegistry.deploy(..., mesh=...)`` and the pager's rebuild recipe
build the same groups from the same spec; its canonical form and error
messages are the JAX package's.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..observability.log import get_logger as _get_logger
from ..parallel import sharding as _sharding
from ..parallel.mesh import AXES as _MESH_AXES
from ..parallel.sharding import (P, _block, fsdp_tree, replicated_tree,
                                 tensor_parallel_tree)
from ..pipeline.inference.serving import (Replica, ReplicaSet, _as_tensor,
                                          _norm_device, available_devices,
                                          module_twin, tree_leaves,
                                          tree_map)

_slog = _get_logger("zoo.shardgroup")

_STRATEGIES = ("tp", "tensor", "fsdp", "replicate")


def normalize_mesh_spec(spec) -> Dict[str, Any]:
    """Validate and canonicalize a deploy-spec ``mesh`` section.

    Accepted keys::

        axes:          {axis_name: size}: the sub-mesh each group spans;
                       group size = product of sizes.  Axis names come
                       from parallel.mesh.AXES.
        groups:        "all" (default): as many groups as the devices
                       hold, or an explicit int >= 1.
        strategy:      "tp" (default) | "tensor" | "fsdp" | "replicate"
        rules:         {param-path regex: axis index} for tp; when
                       omitted, the default column rules shard every
                       >=2-D weight's LAST axis.
        fsdp_min_size: replicate params smaller than this (fsdp only).

    Returns a plain-dict canonical form (sorted keys via
    :func:`mesh_spec_canonical`): the build input and the store's
    ``mesh`` meta."""
    if not isinstance(spec, dict):
        raise ValueError(f"mesh spec must be a dict, got {type(spec).__name__}")
    unknown = set(spec) - {"axes", "groups", "strategy", "rules",
                           "fsdp_min_size"}
    if unknown:
        raise ValueError(f"unknown mesh spec keys: {sorted(unknown)}")
    axes_in = spec.get("axes") or {"tensor": 1}
    if not isinstance(axes_in, dict) or not axes_in:
        raise ValueError("mesh spec 'axes' must be a non-empty dict")
    axes: Dict[str, int] = {}
    for name, size in axes_in.items():
        if name not in _MESH_AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} (choose from {_MESH_AXES})")
        size = int(size)
        if size < 1:
            raise ValueError(f"mesh axis {name!r} size must be >= 1")
        axes[name] = size
    groups = spec.get("groups", "all")
    if groups != "all":
        groups = int(groups)
        if groups < 1:
            raise ValueError("mesh spec 'groups' must be >= 1 or 'all'")
    strategy = spec.get("strategy", "tp")
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown sharding strategy {strategy!r} "
                         f"(choose from {_STRATEGIES})")
    rules = spec.get("rules") or None
    if rules is not None:
        if not isinstance(rules, dict):
            raise ValueError("mesh spec 'rules' must map regex -> axis index")
        rules = {str(k): int(v) for k, v in rules.items()}
    return {"axes": axes, "groups": groups, "strategy": strategy,
            "rules": rules,
            "fsdp_min_size": int(spec.get("fsdp_min_size", 2 ** 14))}


def group_size(spec: Dict[str, Any]) -> int:
    """Devices per group: the product of the spec's axis sizes."""
    n = 1
    for s in spec["axes"].values():
        n *= int(s)
    return n


def mesh_spec_canonical(spec: Dict[str, Any]) -> str:
    """The spec's canonical JSON (sorted keys, no whitespace variance)."""
    return json.dumps(spec, sort_keys=True, separators=(",", ":"))


class GroupMesh:
    """One serving group's mesh: axis names, their sizes (``shape``, a
    mapping the rule tables read) and the member devices in row-major
    order over the axes.  In-process: no process group behind it."""

    __slots__ = ("axis_names", "shape", "devices")

    def __init__(self, devices, axes: Dict[str, int]):
        self.axis_names = tuple(axes)
        self.shape = {name: int(axes[name]) for name in self.axis_names}
        self.devices = tuple(devices)

    def coords(self, member: int) -> Dict[str, int]:
        """Member ``member``'s coordinate on every axis (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            member, out[name] = divmod(member, self.shape[name])
        return out

    def __repr__(self):
        return f"GroupMesh({self.shape}, {len(self.devices)} devices)"


def carve_groups(devices, spec: Dict[str, Any]
                 ) -> List[Tuple[Tuple, GroupMesh]]:
    """Carve ``devices`` into replica groups: consecutive runs of
    ``group_size`` devices, each with a :class:`GroupMesh` shaped by the
    spec's axes.  Leftover devices stay idle (logged, never
    half-grouped)."""
    devs = [torch.device(d) for d in devices]
    gsize = group_size(spec)
    if gsize > len(devs):
        raise ValueError(
            f"mesh spec needs {gsize} devices per group but only "
            f"{len(devs)} are available")
    n_groups = len(devs) // gsize
    if spec["groups"] != "all":
        if spec["groups"] > n_groups:
            raise ValueError(
                f"mesh spec asks for {spec['groups']} groups of "
                f"{gsize} but only {len(devs)} devices are available")
        n_groups = spec["groups"]
    leftover = len(devs) - n_groups * gsize
    if leftover and spec["groups"] == "all":
        _slog.info("shardgroup_devices_idle", idle=leftover,
                   group_size=gsize, groups=n_groups)
    out = []
    for g in range(n_groups):
        gdevs = tuple(devs[g * gsize:(g + 1) * gsize])
        out.append((gdevs, GroupMesh(gdevs, spec["axes"])))
    return out


def _column_tree(params, mesh, axis: str = "tensor"):
    """The default rule table: shard every >=2-D leaf along its LAST axis
    when divisible by the tensor-axis size, replicate the rest."""
    n = dict(mesh.shape).get(axis, 1)
    if n == 1:
        return replicated_tree(params, mesh)

    def rule(p):
        shape = tuple(p.shape) if hasattr(p, "shape") else ()
        if len(shape) >= 2 and shape[-1] % n == 0:
            spec = [None] * len(shape)
            spec[-1] = axis
            return P(*spec)
        return P()

    return _sharding.tree_map(rule, params)


def spec_tree_for(params, mesh, spec: Dict[str, Any]):
    """The spec's strategy and rule table resolved into a tree of
    partition specs (``parallel.sharding.P``) for ``params`` on
    ``mesh``."""
    strategy = spec["strategy"]
    if strategy == "replicate":
        return replicated_tree(params, mesh)
    if strategy == "fsdp":
        return fsdp_tree(params, mesh, axis="fsdp",
                         min_size=spec["fsdp_min_size"])
    # tp / tensor
    if spec["rules"]:
        return tensor_parallel_tree(params, mesh, spec["rules"])
    return _column_tree(params, mesh)


class _ShardedLeaf:
    """One leaf of a group's params: its whole shape and dtype, its spec,
    and per member its block and the block's index in the whole."""

    __slots__ = ("shape", "dtype", "spec", "blocks", "index", "whole")

    def __init__(self, full: torch.Tensor, spec, mesh: GroupMesh):
        self.shape = tuple(full.shape)
        self.dtype = full.dtype
        self.spec = spec
        self.whole = all(e is None for e in spec)
        self.blocks: List[torch.Tensor] = []
        self.index: List[Tuple] = []
        for i, dev in enumerate(mesh.devices):
            idx = _block(spec, mesh.shape, mesh.coords(i), self.shape)
            src = full[idx]
            block = torch.empty(src.shape, dtype=self.dtype, device=dev)
            block.copy_(src)
            self.blocks.append(block)
            self.index.append(idx)

    def to_host(self) -> torch.Tensor:
        """The whole leaf assembled on the host from the blocks."""
        out = torch.empty(self.shape, dtype=self.dtype)
        n = 1 if self.whole else len(self.blocks)
        for idx, block in zip(self.index[:n], self.blocks[:n]):
            out[idx].copy_(block)
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole leaf on ``device`` (the first member's): a
        replicated leaf is the first member's copy as it is; a sharded
        one is assembled from every member's block, on the current
        stream."""
        if self.whole:
            return self.blocks[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for idx, block in zip(self.index, self.blocks):
            out[idx].copy_(block, non_blocking=True)
        return out


def _gather_on_use(skeleton, leaves: Dict[str, _ShardedLeaf], device):
    """Hooks on every module of ``skeleton`` (a ``meta`` copy of the
    served net) that own parameters or buffers: before the module runs,
    its own leaves are gathered on ``device`` into its slots; after it
    returns (or raises) the ``meta`` placeholders go back, freeing the
    gathered copies."""
    names = {id(t): n for n, t in skeleton.named_parameters()}
    names.update({id(t): n for n, t in skeleton.named_buffers()})
    for mod in skeleton.modules():
        own = [(slot, key, leaves[names[id(t)]], t)
               for slot in ("_parameters", "_buffers")
               for key, t in getattr(mod, slot).items() if t is not None]
        if not own:
            continue

        def gather(module, inputs, own=own):
            for slot, key, leaf, _ in own:
                getattr(module, slot)[key] = leaf.gather(device)

        def release(module, inputs, output, own=own):
            for slot, key, _, placeholder in own:
                getattr(module, slot)[key] = placeholder

        mod.register_forward_pre_hook(gather)
        mod.register_forward_hook(release, always_call=True)


class ShardGroup(Replica):
    """One replica group: its devices, the mesh over them, its params as
    per-member blocks (``params``: a tree of sharded leaves) and, for a
    module, the ``meta`` skeleton its forward runs through.  IS-A
    ``Replica``: ``device`` is the first member, where the forward runs,
    and ``stream`` a stream there."""

    __slots__ = ("devices", "mesh", "skeleton", "lock")

    def __init__(self, index: int, devices: Tuple, mesh: GroupMesh,
                 params):
        super().__init__(index, devices[0], params)
        self.devices = tuple(devices)
        self.mesh = mesh
        self.skeleton = None
        # the skeleton's slots are swapped during a forward
        self.lock = threading.Lock()

    def member_bytes(self) -> List[int]:
        """Bytes each member device holds at rest."""
        out = [0] * len(self.devices)
        for leaf in tree_leaves(self.params):
            for j, block in enumerate(leaf.blocks):
                out[j] += block.numel() * block.element_size()
        return out

    def __repr__(self):
        return (f"ShardGroup({self.index}, {len(self.devices)} devices, "
                f"healthy={self.healthy}, active={self.active})")


class _GroupForward:
    """One group's "executable" for one placed signature: the forward on
    the group's first device over leaves gathered on use."""

    __slots__ = ("_fn", "_group")

    def __init__(self, fn, group: ShardGroup):
        self._fn = fn
        self._group = group

    def execute(self, args):
        group = self._group
        with group.lock:
            if group.skeleton is not None:
                return group.skeleton(list(args) if isinstance(args, tuple)
                                      else args)
            whole = tree_map(lambda leaf: leaf.gather(group.device),
                             group.params)
            return self._fn(whole, args)


class ShardGroupSet(ReplicaSet):
    """M replica groups over device sub-meshes: the ``ReplicaSet``
    contract with "device" generalized to "group" (module docstring).
    ``fn(params, x)`` and ``params`` as ``ReplicaSet`` takes them; a
    function made by ``InferenceModel`` for a net carries the net as
    ``fn.module`` and is gathered on use a layer at a time.  ``devices``
    is carved into groups (every card when None; repeats allowed)."""

    def __init__(self, fn, params, mesh_spec, devices=None, **kw):
        self._mesh_spec = normalize_mesh_spec(mesh_spec)
        self._spec_canonical = mesh_spec_canonical(self._mesh_spec)
        if (getattr(fn, "module", None) is None
                and group_size(self._mesh_spec) > 1
                and self._mesh_spec["strategy"] != "replicate"):
            _slog.warning(
                "shardgroup_whole_tree_gather",
                detail="fn has no .module to gather by layer: each "
                       "dispatch gathers the whole tree on the group's "
                       "first device")
        super().__init__(fn, params, devices=devices, **kw)

    # ---- placement-unit hooks ----
    def _carve_units(self, devices) -> List:
        devs = ([_norm_device(d) for d in devices] if devices
                else available_devices("cuda"))
        if not devs:
            raise ValueError("ShardGroupSet needs at least one device")
        return carve_groups(devs, self._mesh_spec)

    def _place_params(self, params, unit, first=None):
        # every group is cut from the whole params, never from group 0's
        # blocks
        _, mesh = unit
        tensors = tree_map(_as_tensor, params)
        specs = spec_tree_for(tensors, mesh, self._mesh_spec)
        return _sharding.tree_map(
            lambda t, s: _ShardedLeaf(t, s, mesh), tensors, specs)

    def _make_replica(self, index: int, unit, placed) -> ShardGroup:
        gdevs, mesh = unit
        group = ShardGroup(index, gdevs, mesh, placed)
        module = getattr(self._fn, "module", None)
        if module is not None:
            group.skeleton = module_twin(
                module, lambda t: torch.empty_like(t, device="meta"))
            _gather_on_use(group.skeleton, placed, group.device)
        if group.device.type == "cuda":
            group.stream = torch.cuda.Stream(group.device)
            # after the blocks the callers' streams just wrote
            for dev in set(gdevs):
                group.stream.wait_stream(torch.cuda.current_stream(dev))
        return group

    def _make_exe(self, replica: ShardGroup) -> _GroupForward:
        return _GroupForward(self._fn, replica)

    def span_labels(self, replica) -> Dict[str, Any]:
        # a "replica" here IS a group: label both, so dashboards keyed on
        # either name resolve and traces show which group served
        return {"replica": replica.index, "group": replica.index}

    # ---- identity / introspection ----
    @property
    def groups(self) -> Tuple[ShardGroup, ...]:
        return self.replicas

    @property
    def group_size(self) -> int:
        return len(self.replicas[0].devices)

    @property
    def mesh_spec(self) -> Dict[str, Any]:
        return self._mesh_spec

    def member_bytes(self) -> List[List[int]]:
        """Per group, the bytes each member device holds at rest."""
        return [g.member_bytes() for g in self.replicas]

    def host_params(self):
        """The whole params on the host, assembled from the first
        group's blocks (what a page-out keeps)."""
        return tree_map(lambda leaf: leaf.to_host(), self.replicas[0].params)

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update({
            "groups": len(self.replicas),
            "group_size": self.group_size,
            "group_dispatches": {g.index: g.dispatches
                                 for g in self.replicas},
            "mesh_axes": dict(self._mesh_spec["axes"]),
        })
        return out
