"""A sharded train state: a model's parameters and optimizer moments
placed on a mesh by the rule tables.

The port's counterpart of what the JAX package's Trainer gets from
``jax.jit``'s in/out shardings and GSPMD.  One process drives one
device, so :class:`StatePlan` does by hand what GSPMD inserts:

* each parameter's *master* is this rank's block under its spec
  (``sharding.shard_params``); a replicated parameter's master is the
  module's own tensor.  The optimizer runs on the masters, so its
  moments are blocks too (ZeRO);
* the model computes on plain tensors, never on DTensors (the flash
  kernels, BatchNorm and the elementwise DSL are ``autograd.Function``s
  DTensor has no rule for).  A parameter is gathered on use: after each
  update the module's own tensor is refilled from the blocks
  (all-gather over the leaf's axes), as FSDP2 gathers before a forward;
* except on the ``tensor`` axis, for the layers that compute on their
  blocks (:meth:`StatePlan.tensor_layers`): a ``Dense`` whose kernel is
  split on its columns (the bias split with it, or replicated and
  sliced) or on its rows (the bias replicated), and a
  ``MultiHeadSelfAttention`` whose ``Wq``/``Wk``/``Wv`` are split on the
  head axis and ``Wo`` on its head axis.  They get their tensor-axis
  blocks (gathered over the other axes) and exchange activations
  instead: any rule table stays correct, the rest being gathered;
* gradients are averaged over the data axes (``data``, ``fsdp``), never
  over ``tensor``, then cut to each master's block;
* norms for clipping count every element once: a block's squared sum is
  added over the axes that split it.

:meth:`StatePlan.params_tree` and :meth:`StatePlan.opt_tree` show the
masters and moments as the DTensors the rule tables place, for the
sharded checkpoint and for inspection.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from . import mesh as mesh_lib
from .sharding import (P, _entry_axes, gather_shard, local_shard,
                       opt_state_sharding_tree, shard_params, to_dtensor,
                       tree_map)

TENSOR = "tensor"


def _tree_of(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _without(spec, axes) -> P:
    """``spec`` with ``axes`` removed (their dims left whole)."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _entry_axes(entry) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return P(*out)


def _is_split(spec) -> bool:
    return any(entry is not None for entry in spec)


def _split_dims(spec, axis: str) -> List[int]:
    return [d for d, entry in enumerate(spec) if axis in _entry_axes(entry)]


class _DenseSplit:
    """A Dense on its tensor-axis block of columns or rows."""

    def __init__(self, mesh, kind: str, bias_local: bool):
        self.mesh, self.kind, self.bias_local = mesh, kind, bias_local

    def __call__(self, layer, x):
        from ._compat import all_gather, axis_slice, psum, pvary
        from ..core.module import promote
        if self.kind == "column":
            x, w = promote(pvary(x, TENSOR, mesh=self.mesh), layer.W)
            y = x @ w
            if layer.bias:
                b = layer.b if self.bias_local else axis_slice(
                    layer.b, TENSOR, dim=0, mesh=self.mesh)
                y = y + b
            y = all_gather(y, TENSOR, dim=-1, mesh=self.mesh)
        else:
            x = axis_slice(x, TENSOR, dim=-1, mesh=self.mesh)
            x, w = promote(x, layer.W)
            y = psum(x @ w, TENSOR, mesh=self.mesh)
            if layer.bias:
                y = y + layer.b
        if layer.activation is not None:
            y = layer.activation(y)
        return y


class StatePlan:
    """The placement of ``params`` (the model's parameters, whose key
    paths in the params tree are ``paths``) on ``mesh`` under
    ``strategy`` and ``tp_rules``."""

    def __init__(self, model, params: Sequence[torch.Tensor],
                 paths: Sequence[tuple], mesh, strategy: str,
                 tp_rules=None, fsdp_min_size: int = 2 ** 14):
        self.mesh = mesh
        self.params = list(params)
        self.paths = [tuple(p) for p in paths]
        spec_tree = shard_params(_tree_of(self.paths, self.params), mesh,
                                 strategy, tp_rules=tp_rules,
                                 fsdp_min_size=fsdp_min_size)
        self.specs: List[P] = [_at(spec_tree, p) for p in self.paths]
        self.spec_tree = spec_tree
        with torch.no_grad():
            self.masters = [local_shard(p.detach(), spec, mesh)
                            if _is_split(spec) else p
                            for p, spec in zip(self.params, self.specs)]
        self.dp = mesh_lib.dp_size(mesh)
        self.dp_group = mesh_lib.group_over(mesh, mesh_lib.DATA_AXES)
        # the groups of every axis set a leaf is split over, made now on
        # every rank in the same order (making a group is collective)
        for spec in self.specs:
            axes = self._axes(spec)
            if axes:
                mesh_lib.group_over(mesh, axes)
        #: parameter index -> the spec of its use tensor (its tensor-axis
        #: block, whole over the other axes), for the layers computing
        #: on their blocks; layer -> its split
        self.local_use: Dict[int, P] = {}
        self._splits: list = []
        if mesh_lib.axis_sizes(mesh).get(TENSOR, 1) > 1:
            self._plan_tensor_layers(model)

    def _axes(self, spec) -> tuple:
        used = {a for entry in spec for a in _entry_axes(entry)}
        return tuple(a for a in self.mesh.mesh_dim_names if a in used)

    # ---- tensor-parallel layers ----
    def _plan_tensor_layers(self, model):
        from ..pipeline.api.keras.layers.attention import (
            MultiHeadSelfAttention)
        from ..pipeline.api.keras.layers.core import Dense
        index = {id(p): i for i, p in enumerate(self.params)}

        def spec_of(t):
            return self.specs[index[id(t)]] if id(t) in index else None

        def only(spec, dim):
            return _split_dims(spec, TENSOR) == [dim]

        for layer in model.modules():
            # exact types: a subclass may compute otherwise
            if type(layer) is Dense and "W" in layer._parameters:
                if (getattr(layer, "W_regularizer", None) is not None
                        or getattr(layer, "b_regularizer", None)
                        is not None):
                    continue  # a penalty needs the whole kernel
                ws = spec_of(layer.W)
                bs = spec_of(layer.b) if layer.bias else P()
                if ws is None or bs is None:
                    continue
                if only(ws, 1) and (not _split_dims(bs, TENSOR)
                                    or only(bs, 0)):
                    split = _DenseSplit(self.mesh, "column",
                                        bool(_split_dims(bs, TENSOR)))
                    local = [layer.W] + ([layer.b] if split.bias_local
                                         else [])
                elif only(ws, 0) and not _split_dims(bs, TENSOR):
                    split = _DenseSplit(self.mesh, "row", False)
                    local = [layer.W]
                else:
                    continue
                self._splits.append((layer, split))
            elif type(layer) is MultiHeadSelfAttention \
                    and "Wq" in layer._parameters:
                specs = [spec_of(getattr(layer, w))
                         for w in ("Wq", "Wk", "Wv", "Wo")]
                if any(s is None for s in specs) or not (
                        all(only(s, 1) for s in specs[:3])
                        and only(specs[3], 0)):
                    continue
                self._splits.append((layer, self.mesh))
                local = [getattr(layer, w) for w in ("Wq", "Wk", "Wv", "Wo")]
            else:
                continue
            for t in local:
                i = index[id(t)]
                self.local_use[i] = _without(self.specs[i], (TENSOR,))

    @contextlib.contextmanager
    def tensor_layers(self):
        """The forward of a training step: the planned layers compute
        on their tensor-axis blocks."""
        for layer, split in self._splits:
            layer._tensor_split = split
        try:
            yield
        finally:
            for layer, _ in self._splits:
                layer._tensor_split = None

    def use_tensors(self) -> Dict[int, torch.Tensor]:
        """Parameter index -> the tensor-axis block a planned layer
        computes with this step: a leaf that takes its gradient."""
        out = {}
        with torch.no_grad():
            for i, spec in self.local_use.items():
                t = gather_shard(self.masters[i], spec, self.mesh)
                out[i] = t.detach().requires_grad_(
                    self.params[i].requires_grad)
        return out

    # ---- the step ----
    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Gradients of the use tensors -> gradients of the masters: the
        mean over the data axes (one all-reduce of every gradient
        flattened), then each master's block."""
        if self.dp_group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.dp_group)
            flat.div_(self.dp)
            out, at = [], 0
            for g in grads:
                out.append(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
            grads = out
        result = []
        for i, g in enumerate(grads):
            spec = self.specs[i]
            if i in self.local_use:
                # a tensor-axis block already: cut the other axes
                if _is_split(self.local_use[i]):
                    g = local_shard(g, self.local_use[i], self.mesh)
            elif _is_split(spec):
                g = local_shard(g, spec, self.mesh)
            result.append(g)
        return result

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's mean loss from this rank's."""
        if self.dp_group is None:
            return loss
        loss = loss.clone()
        dist.all_reduce(loss, group=self.dp_group)
        return loss / self.dp

    def sq_sums(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's squared sum over the whole leaf, from the blocks
        in ``tensors`` (one a master): a split leaf's block sums are
        added over the axes that split it, so every element counts
        once."""
        sums = [torch.sum(t * t) for t in tensors]
        by_axes: Dict[tuple, List[int]] = {}
        for i, spec in enumerate(self.specs):
            axes = self._axes(spec)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            group = mesh_lib.group_over(self.mesh, axes)
            if group is None:
                continue
            stacked = torch.stack([sums[i] for i in idx])
            dist.all_reduce(stacked, group=group)
            for k, i in enumerate(idx):
                sums[i] = stacked[k]
        return sums

    @torch.no_grad()
    def pull_module(self) -> None:
        """Take the module's tensors into the masters of the split
        parameters (weights set on the model since the last step)."""
        for p, m, spec in zip(self.params, self.masters, self.specs):
            if _is_split(spec):
                m.copy_(local_shard(p.detach(), spec, self.mesh))

    @torch.no_grad()
    def refresh_module(self) -> None:
        """Refill the module's tensors of the split parameters from the
        masters (all-gather over each leaf's axes)."""
        for p, m, spec in zip(self.params, self.masters, self.specs):
            if _is_split(spec):
                p.copy_(gather_shard(m, spec, self.mesh))

    # ---- DTensor views ----
    def params_tree(self) -> dict:
        """{layer: {param: DTensor}} of the masters."""
        return _tree_of(self.paths, [to_dtensor(m, s, self.mesh) for m, s
                                     in zip(self.masters, self.specs)])

    def opt_tree(self, opt_tree) -> dict:
        """The optimizer's state tree (blocks of the masters' shapes)
        with each moment as a DTensor placed with its parameter
        (``opt_state_sharding_tree``); other leaves as they are."""
        local = _tree_of(self.paths, self.masters)
        specs = opt_state_sharding_tree(opt_tree, local, self.spec_tree,
                                        self.mesh)
        return tree_map(lambda leaf, spec: to_dtensor(leaf, spec, self.mesh)
                        if isinstance(leaf, torch.Tensor) else leaf,
                        opt_tree, specs)
