"""Pipeline parallelism: GPipe microbatches over the ``pipe`` mesh axis.

Counterpart of ``analytics_zoo_tpu/parallel/pipeline.py``.  Stage ``s``
of a homogeneous layer stack runs on the rank at index ``s`` of the
``pipe`` axis; microbatches flow stage to stage by ``ppermute``, so at
steady state every stage works on a different microbatch: the GPipe
fill, steady state and drain of ``n_micro + n_stages - 1`` steps.

Constraints (the JAX package's): every stage runs the same
``stage_fn`` with its own slice of the parameters (leaves with a leading
``n_stages`` axis), and activations keep one shape across stages.

Every rank runs the same sequence of operations, whatever its stage
(selections by mask, as the JAX body's ``jnp.where``): the backward's
collectives then meet in the same order on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ._compat import axis_index, axis_size, axis_slice, ppermute, psum, pvary
from .sharding import flatten_with_path, tree_map


def _pipeline_local(x, params, stage_fn: Callable, n_micro: int,
                    axis_name: str, mesh=None):
    """One rank's part: ``x`` the whole input, ``params`` this stage's
    slice (leading axis of size 1)."""
    n_stages = axis_size(axis_name, mesh)
    stage = axis_index(axis_name, mesh)
    local_params = tree_map(lambda p: p[0], params)
    mb = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    recv = torch.zeros_like(mb[0])
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    n_steps = n_micro + n_stages - 1
    outs = []
    for t in range(n_steps):
        inp = torch.where(first, mb[min(t, n_micro - 1)], recv)
        y = stage_fn(local_params, inp)
        if t >= n_stages - 1:
            # the last stage finishes microbatch t - (n_stages - 1) now
            outs.append(y)
        if t < n_steps - 1:
            recv = ppermute(y, axis_name, perm, mesh=mesh)
    last = 1.0 if stage == n_stages - 1 else 0.0
    # only the last stage's outputs are real; the sum over the axis puts
    # them on every stage
    out = psum(torch.stack(outs) * last, axis_name, mesh=mesh)
    return out.reshape(x.shape)


def pipeline_apply(stage_fn: Callable, stage_params, x, mesh,
                   axis_name: str = "pipe",
                   n_microbatches: Optional[int] = None):
    """Run ``x`` through ``n_stages`` copies of ``stage_fn`` pipelined
    over the mesh's ``axis_name`` axis.

    ``x`` and ``stage_params`` are GLOBAL: every rank of the axis passes
    the whole input and the whole parameter tree (leaves with a leading
    ``n_stages`` axis; stage ``s`` uses ``leaf[s]``).  ``stage_fn(
    params_slice, x) -> y`` with ``y.shape == x.shape``.  Returns the
    whole output on every rank of the axis (the JAX function's output,
    replicated over ``pipe``); gradients reach ``x`` and every stage's
    parameters whole on every rank.  ``n_microbatches`` defaults to the
    stage count."""
    from .mesh import axis_sizes
    n_stages = axis_sizes(mesh).get(axis_name, 1)
    leaves = [l for _, l in flatten_with_path(stage_params)]
    if not leaves or leaves[0].shape[0] != n_stages:
        raise ValueError(
            f"stage_params leaves need leading axis {n_stages} "
            f"(the {axis_name!r} mesh axis); got "
            f"{tuple(leaves[0].shape) if leaves else 'no leaves'}")
    n_micro = n_stages if n_microbatches is None else n_microbatches
    if n_micro < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_micro}")
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch ({x.shape[0]}) is not divisible by n_microbatches "
            f"({n_micro})")
    local = tree_map(lambda p: axis_slice(p, axis_name, dim=0, mesh=mesh),
                     stage_params)
    return _pipeline_local(pvary(x, axis_name, mesh=mesh), local, stage_fn,
                           n_micro, axis_name, mesh=mesh)

