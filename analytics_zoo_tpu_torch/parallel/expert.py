"""Switch-routed mixture of experts on one device.

Counterpart of the single-device part of
``analytics_zoo_tpu/parallel/expert.py``: top-1 routing with a capacity
``C`` a expert, tokens past it dropped (their output is 0, which a
residual turns into a pass-through), each expert a two-layer relu FFN,
and the Switch load-balancing loss ``E * sum(f * p)`` (``f`` the share
of tokens each expert was picked for, ``p`` its mean router
probability).

Routing (``_route``) is the JAX package's: f32 logits and softmax, the
first index at ties, and queue positions from an integer cumsum (exact
at any token count, where a bf16 one is not past 256).  The JAX package
dispatches and combines with einsums against a dense (tokens, experts,
C) one-hot; a one-hot product adds exact zeros, so :func:`switch_moe`
moves the same values by index instead: each kept token is copied into
row ``expert * C + position`` of the (E*C, d) expert blocks, a dropped
one into a discard row past them, and each token's output is gathered
back from its row and scaled by its gate probability (0 when dropped).
Every shape depends on the token count only, never on the routing, and
nothing reads back to the host, so a decode step through it can be
captured in a CUDA graph.  :func:`switch_moe_plain` is the dense
formulation, the plain version the tests hold it to.

Data parallelism (``group``, the process group of the data axes while
the Trainer's plan splits the batch): the experts are replicated and
no token moves, but routing is the global batch's, as the JAX package
routes the whole batch under ``jit``.  Each rank all-gathers its
per-expert token counts (E integers); a token is kept when its
rank-major global position in its expert's queue (the earlier ranks'
counts plus its own position) is below the capacity of the global token
count, the order :func:`switch_moe` gives the concatenated batch.  The
aux loss takes ``f`` and ``p`` as means over the ranks before their
product; ``p``'s backward is the mean of the ranks' cotangents, so that
the trainer's gradient mean gives the global loss's gradient.

Expert parallelism (:func:`moe_sharded`): experts split over the
``expert`` mesh axis, tokens too; each rank routes its tokens against
every expert, an all_to_all ships the dispatched blocks to the experts'
owners, the local experts run, and a second all_to_all brings the
results home.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.module import promote
from ._compat import (all_gather, all_to_all, axis_size, axis_slice,
                      group_mean, pmean, pvary)


class MoEParams(NamedTuple):
    """Weights of a switch-MoE FFN block.

    gate:  (d_model, n_experts)
    w1:    (n_experts, d_model, d_hidden)
    b1:    (n_experts, d_hidden)
    w2:    (n_experts, d_hidden, d_model)
    b2:    (n_experts, d_model)
    """

    gate: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, dtype=torch.float32) -> MoEParams:
    """Normal draws scaled by 1/sqrt(fan-in), zero biases, on the
    generator's device (the JAX package's recipe; its stream differs)."""
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev) * scale

    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    return MoEParams(
        gate=normal((d_model, n_experts), s1),
        w1=normal((n_experts, d_model, d_hidden), s1),
        b1=torch.zeros((n_experts, d_hidden), dtype=dtype, device=dev),
        w2=normal((n_experts, d_hidden, d_model), s2),
        b2=torch.zeros((n_experts, d_model), dtype=dtype, device=dev))


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    return max(1, int(math.ceil(n_tokens / n_experts * capacity_factor)))


class Routing(NamedTuple):
    """Top-1 routing of T tokens: ``expert`` (T,) int64 (argmax, first
    index at ties), ``position`` (T,) int64 in that expert's queue,
    ``keep`` (T,) bool (position < capacity), ``gate`` (T,) f32 (the
    picked expert's probability), and the load statistics ``f`` and
    ``p`` (E,) of the aux loss."""

    expert: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    f: torch.Tensor
    p: torch.Tensor


def _queue_offsets(counts, group):
    """Each expert's tokens on the ranks before this one (rank-major over
    ``group``): an all-gather of every rank's (E,) counts."""
    import torch.distributed as dist
    every = [torch.empty_like(counts)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, counts, group=group)
    me = dist.get_group_rank(group, dist.get_rank())
    offset = torch.zeros_like(counts)
    for c in every[:me]:
        offset = offset + c
    return offset


def _route(x, gate_w, n_experts: int, capacity: int,
           group=None) -> Routing:
    a, w = promote(x, gate_w)
    probs = torch.softmax((a @ w).float(), dim=-1)          # (T, E)
    expert = torch.argmax(probs, dim=-1)                    # (T,)
    one_hot = (expert[:, None] == torch.arange(
        n_experts, device=x.device)).to(torch.int32)        # (T, E)
    # queue positions in exact integer arithmetic
    position = (torch.cumsum(one_hot, dim=0) - 1).gather(
        1, expert[:, None])[:, 0]
    f, p = one_hot.float().mean(dim=0), probs.mean(dim=0)
    if group is None:
        keep = position < capacity
    else:
        # the position in the global batch's queue decides; the local
        # one stays the token's row in this rank's expert blocks
        offset = _queue_offsets(one_hot.sum(dim=0), group)
        keep = position + offset.gather(0, expert) < capacity
        f, p = group_mean(f, group), group_mean(p, group)
    return Routing(expert=expert, position=position, keep=keep,
                   gate=probs.gather(1, expert[:, None])[:, 0], f=f, p=p)


def _apply_experts(blocks, w1, b1, w2, b2):
    """blocks (E, C, d) through each expert's 2-layer relu FFN."""
    blocks, w1, b1, w2, b2 = promote(blocks, w1, b1, w2, b2)
    h = torch.relu(torch.bmm(blocks, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def _capacity(t: int, n_experts: int, capacity_factor: float,
              capacity: Optional[int]) -> int:
    return capacity if capacity is not None else expert_capacity(
        t, n_experts, capacity_factor)


def switch_moe(x, params: MoEParams, capacity_factor: float = 1.25,
               capacity: Optional[int] = None, group=None):
    """x (tokens, d_model) -> (out, aux_loss), dispatched by index.
    Dropped (over-capacity) tokens give 0: add the residual outside.
    ``group``: ``x`` is this rank's block of a batch split over the
    group's ranks, each holding as many tokens; routing, capacity and
    the aux loss are the global batch's (module docstring)."""
    t, d = x.shape
    n_experts = params.gate.shape[-1]
    if capacity is None and group is not None:
        import torch.distributed as dist
        capacity = expert_capacity(t * dist.get_world_size(group),
                                   n_experts, capacity_factor)
    c = _capacity(t, n_experts, capacity_factor, capacity)
    r = _route(x, params.gate, n_experts, c, group)
    aux = n_experts * torch.sum(r.f * r.p)
    outs = _apply_experts(_dispatch(x, r, n_experts, c), params.w1,
                          params.b1, params.w2, params.b2)
    return _combine(outs, r, c), aux


def switch_moe_plain(x, params: MoEParams, capacity_factor: float = 1.25,
                     capacity: Optional[int] = None):
    """The JAX package's dense formulation of :func:`switch_moe`:
    dispatch and combine as einsums against the (T, E, C) one-hot."""
    t, d = x.shape
    n_experts = params.gate.shape[-1]
    c = _capacity(t, n_experts, capacity_factor, capacity)
    r = _route(x, params.gate, n_experts, c)
    aux = n_experts * torch.sum(r.f * r.p)
    ar_e = torch.arange(n_experts, device=x.device)
    ar_c = torch.arange(c, device=x.device)
    dispatch = ((r.expert[:, None, None] == ar_e[None, :, None])
                & (r.position[:, None, None] == ar_c[None, None, :])
                & r.keep[:, None, None]).to(x.dtype)
    combine = dispatch * r.gate.to(x.dtype)[:, None, None]
    blocks = torch.einsum("tec,td->ecd", dispatch, x)
    outs = _apply_experts(blocks, params.w1, params.b1, params.w2,
                          params.b2)
    return torch.einsum("tec,ecd->td", combine, outs), aux


def _dispatch(x, r: Routing, n_experts: int, capacity: int):
    """(E, C, d) expert blocks of the kept tokens, by index."""
    rows = n_experts * capacity
    slot = r.expert * capacity + r.position
    blocks = x.new_zeros((rows + 1, x.shape[1])).index_copy(
        0, torch.where(r.keep, slot, rows), x)
    return blocks[:rows].view(n_experts, capacity, x.shape[1])


def _combine(outs, r: Routing, capacity: int):
    """Each token's row of the (E, C, d) expert outputs, scaled by its
    gate (0 when dropped)."""
    d = outs.shape[-1]
    slot = r.expert * capacity + r.position
    picked = outs.reshape(-1, d).index_select(
        0, torch.where(r.keep, slot, 0))
    scale = torch.where(r.keep, r.gate, 0.0).to(picked.dtype)
    return picked * scale[:, None]


def _moe_local(x, params: MoEParams, n_experts: int, capacity: int,
               axis_name: str, mesh=None):
    """One rank's part (the JAX body under ``shard_map``): ``x`` this
    rank's token block, ``params.gate`` every expert's gate columns and
    ``w1``/``b1``/``w2``/``b2`` this rank's experts."""
    n = axis_size(axis_name, mesh)
    e_local = n_experts // n
    r = _route(x, params.gate, n_experts, capacity)
    # the aux loss of the GLOBAL routing statistics (means over the axis
    # before the product), as one device would see them
    f = pmean(r.f, axis_name, mesh=mesh)
    p = pmean(r.p, axis_name, mesh=mesh)
    aux = n_experts * torch.sum(f * p)
    d = x.shape[-1]
    blocks = _dispatch(x, r, n_experts, capacity).reshape(
        n, e_local, capacity, d)
    # to the experts' owners; axis 0 is then the SOURCE rank, folded
    # into each local expert's queue
    blocks = all_to_all(blocks, axis_name, 0, 0, mesh=mesh)
    blocks = blocks.transpose(0, 1).reshape(e_local, n * capacity, d)
    outs = _apply_experts(blocks, params.w1, params.b1, params.w2,
                          params.b2)
    outs = outs.reshape(e_local, n, capacity, d).transpose(0, 1)
    outs = all_to_all(outs, axis_name, 0, 0, mesh=mesh)
    # axis 0 is the expert's owner: global expert = owner * E_local + e
    outs = outs.reshape(n_experts, capacity, d)
    return _combine(outs, r, capacity), aux


def moe_sharded(x, params: MoEParams, mesh, axis_name: str = "expert",
                capacity_factor: float = 1.25):
    """Expert-parallel switch MoE: tokens and experts split over
    ``axis_name`` (the experts along ``w1``/``b1``/``w2``/``b2``'s
    leading dim), the gate replicated.

    ``x`` (tokens, d_model) and ``params`` are GLOBAL: every rank of the
    axis passes them whole.  Each rank takes its token block and its
    experts, with the capacity of a LOCAL token block (the same queue
    depth on every rank).  Returns ``(out, aux)``: the whole (tokens,
    d_model) output and the aux loss, on every rank, as the JAX function
    returns its global arrays; gradients reach ``x`` and ``params`` whole
    on every rank."""
    from .mesh import axis_sizes
    n = axis_sizes(mesh).get(axis_name, 1)
    t = x.shape[0]
    n_experts = params.gate.shape[-1]
    if n_experts % n:
        raise ValueError(
            f"n_experts ({n_experts}) is not divisible by the "
            f"{axis_name!r} axis size ({n})")
    if t % n:
        raise ValueError(
            f"tokens ({t}) are not divisible by the {axis_name!r} "
            f"axis size ({n})")
    capacity = expert_capacity(t // n, n_experts, capacity_factor)
    local = MoEParams(
        gate=pvary(params.gate, axis_name, mesh=mesh),
        **{k: axis_slice(getattr(params, k), axis_name, dim=0, mesh=mesh)
           for k in ("w1", "b1", "w2", "b2")})
    y, aux = _moe_local(axis_slice(x, axis_name, dim=0, mesh=mesh), local,
                        n_experts, capacity, axis_name, mesh=mesh)
    return all_gather(y, axis_name, dim=0, mesh=mesh), aux
