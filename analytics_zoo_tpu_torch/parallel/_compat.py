"""The collectives of the parallel layer, over one mesh axis.

Counterpart of ``analytics_zoo_tpu/parallel/_compat.py``'s ``axis_size``
and of the ``lax`` collectives the JAX package's parallel modules call
inside ``shard_map``.  The JAX file's ``shard_map`` shim has no
counterpart: in the port every rank already runs its own shard of the
program, so a function that JAX maps over a mesh is called directly, on
the rank's local tensors, and each collective here names the mesh axis
it acts over (on the active mesh unless ``mesh`` is given).

Every collective is differentiable.  The rule for its backward follows
from the port's convention that a value every rank of an axis holds
alike (a replicated value) also has the same cotangent on every rank:

* ``ppermute``: the cotangents travel back along the inverse
  permutation;
* ``all_to_all``: the cotangents go back by the transposed all_to_all;
* ``psum`` / ``pmean``: the result is replicated, so each rank's input
  gets the (common) cotangent as it is (``pmean``: over the axis size);
* ``pvary`` (identity; the backward sums the cotangents over the axis):
  marks a replicated value that each rank goes on to use differently;
* ``all_gather`` / ``axis_slice``: concatenate the ranks' blocks into
  the replicated whole, and take this rank's block of it; each is the
  other's backward.

On an axis of size 1 every collective is the identity and moves no
data.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from .mesh import get_active_mesh
    mesh = get_active_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or run under "
                         "parallel.mesh.active_mesh(...)")
    return mesh


def axis_size(axis_name: str, mesh=None) -> int:
    from .mesh import axis_sizes
    return axis_sizes(_mesh(mesh)).get(axis_name, 1)


def axis_index(axis_name: str, mesh=None) -> int:
    from .mesh import axis_index as _index
    return _index(_mesh(mesh), axis_name)


def _group(axis_name: str, mesh):
    from .mesh import group_over
    return group_over(_mesh(mesh), (axis_name,))


def _global_rank(group, index: int) -> int:
    import torch.distributed as dist
    return dist.get_process_group_ranks(group)[index]


def _send_recv(x: torch.Tensor, group, dst: Optional[int],
               src: Optional[int]) -> torch.Tensor:
    """Send ``x`` to the axis index ``dst`` and receive from ``src``
    (either None: that half is skipped; nothing received gives zeros)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x, _global_rank(group, dst),
                              group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, src),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _permute(x, group, me: int, perm):
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    return _send_recv(x, group, dst[0] if dst else None,
                      src[0] if src else None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, perm):
        ctx.group, ctx.me = group, me
        ctx.inverse = [(d, s) for s, d in perm]
        return _permute(x, group, me, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.me, ctx.inverse), None, None, None


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]], mesh=None) -> torch.Tensor:
    """``lax.ppermute``: the rank at axis index ``s`` sends ``x`` to the
    one at ``d`` for each ``(s, d)`` of ``perm``; a rank no one sends to
    gets zeros."""
    group = _group(axis_name, mesh)
    perm = [(int(s), int(d)) for s, d in perm]
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, axis_index(axis_name, mesh), perm)


def _all_to_all(x, group, n: int):
    """Row ``j`` of ``x`` (leading dim ``n``) to the rank at index ``j``;
    row ``j`` of the result from it."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _all_to_all(x, group, n)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose
        return _all_to_all(g, *ctx.args), None, None


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, mesh=None) -> torch.Tensor:
    """``lax.all_to_all`` (untiled): ``x.shape[split_axis]`` equals the
    axis size; slice ``j`` along ``split_axis`` goes to the rank at index
    ``j``, and the slices received are stacked along ``concat_axis`` in
    source order (that dim then has the axis size)."""
    n = axis_size(axis_name, mesh)
    if x.shape[split_axis] != n:
        raise ValueError(
            f"all_to_all needs dim {split_axis} ({x.shape[split_axis]}) "
            f"to equal the {axis_name!r} axis size ({n})")
    group = _group(axis_name, mesh)
    x = x.movedim(split_axis, 0)
    if group is not None:
        x = _AllToAll.apply(x, group, n)
    return x.movedim(0, concat_axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        import torch.distributed as dist
        ctx.scale = scale
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1 else g), None, None


def psum(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """``lax.psum``: the sum over the axis, on every rank of it."""
    group = _group(axis_name, mesh)
    return x if group is None else _PSum.apply(x, group, 1)


def pmean(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """``lax.pmean``: the mean over the axis, on every rank of it."""
    group = _group(axis_name, mesh)
    if group is None:
        return x
    return _PSum.apply(x, group, 1.0 / axis_size(axis_name, mesh))


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def pvary(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """The identity on a replicated ``x`` that each rank of the axis
    goes on to use for its own part of the work; the backward sums the
    ranks' partial cotangents into the whole one."""
    group = _group(axis_name, mesh)
    return x if group is None else _PVary.apply(x, group)


def group_sum(x: torch.Tensor, group, scale: float = 1.0) -> torch.Tensor:
    """The sum (times ``scale``) over the ranks of a process ``group``
    of an ``x`` each rank computed from its own rows of a split batch,
    on every rank: ``psum`` of ``pvary``, so the backward adds the ranks'
    cotangents (times ``scale``), and the trainer's gradient mean over
    the ranks gives the global batch's gradient."""
    return _PSum.apply(_PVary.apply(x, group), group, scale)


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`group_sum` over the group's size: the mean over its ranks,
    whose backward is the mean of the ranks' cotangents."""
    import torch.distributed as dist
    return group_sum(x, group, 1.0 / dist.get_world_size(group))


def _gather(x, group, n: int, dim: int):
    import torch.distributed as dist
    x = x.contiguous()
    # the blocks concatenated on dim 0 (the layout gloo and NCCL take)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    # torch 2.13 renames the call; the card's torch has the old name
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n, dim=0), dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, dim):
        ctx.args = (n, me, dim)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        n, me, dim = ctx.args
        return g.chunk(n, dim=dim)[me].contiguous(), None, None, None, None


class _AxisSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, dim):
        ctx.args = (group, n, dim)
        return x.chunk(n, dim=dim)[me].contiguous()

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _gather(g, group, n, dim), None, None, None, None


def all_gather(x: torch.Tensor, axis_name: str, dim: int = 0,
               mesh=None) -> torch.Tensor:
    """The ranks' blocks of the axis concatenated along ``dim`` in axis
    order (``lax.all_gather(tiled=True)``), on every rank."""
    group = _group(axis_name, mesh)
    if group is None:
        return x
    return _AllGather.apply(x, group, axis_size(axis_name, mesh),
                            axis_index(axis_name, mesh), dim)


def axis_slice(x: torch.Tensor, axis_name: str, dim: int = 0,
               mesh=None) -> torch.Tensor:
    """This rank's block of a replicated ``x``: ``dim`` split into
    axis-size equal blocks, the one at this rank's axis index."""
    group = _group(axis_name, mesh)
    if group is None:
        return x
    n = axis_size(axis_name, mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) is not divisible by "
                         f"the {axis_name!r} axis size ({n})")
    return _AxisSlice.apply(x, group, n, axis_index(axis_name, mesh), dim)


__all__ = ["axis_size", "axis_index", "ppermute", "all_to_all", "psum",
           "pmean", "pvary", "group_sum", "group_mean", "all_gather",
           "axis_slice"]
