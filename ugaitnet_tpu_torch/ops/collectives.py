"""Differentiable collectives over ``torch.distributed`` process groups,
and the gradient average of a data-parallel step.

The ops, the models and the train step take a group from here; the mesh,
the ranks' start and the step's data-parallel entry points live in
``parallel/``.  Every function is the identity for ``group=None`` (one
process), so the one-device path runs the same code.

Each backward is an all-reduce-sum of the cotangent (the gather then keeps
its own rows): the transpose of the collective when every rank computes
the same global loss.  After such a backward, ``average_gradients`` makes
every rank's gradient the mean over the world.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

DATA_AXIS = "data"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.rows = (dist.get_rank(group) * x.shape[0], x.shape[0])
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        start, n = ctx.rows
        return g[start:start + n], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (identity for ``group=None``).
    Backward: the sum of the cotangents."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over the group's ranks (identity for ``group=None``);
    the JAX ``pmean``."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0 in rank order (every rank's
    rows must have the same shape); identity for ``group=None``.  Backward:
    the sum of the cotangents, of which this rank keeps its own rows."""
    if group is None:
        return x
    return _AllGatherRows.apply(x, group)


def gather_rows_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_rows`` for tensors without a gradient (labels, counts)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def _flat_all_reduce(tensors: List[torch.Tensor], group, scale: float
                     ) -> None:
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.mul_(scale)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def average_gradients(model: torch.nn.Module, mesh) -> None:
    """Every parameter's gradient after a backward through the collectives
    above, on a ``parallel.sharding.Mesh``: replicated parameters sum over
    all ranks, expert shards (``parallel/expert.py``) over their data
    ranks, and both divide by the world."""
    rep, shards = [], []
    for p in model.parameters():
        if p.grad is None:
            continue
        (shards if getattr(p, "expert_shard", False) else rep).append(p.grad)
    _flat_all_reduce(rep, dist.group.WORLD, 1.0 / mesh.world)
    _flat_all_reduce(shards, mesh.group(DATA_AXIS), 1.0 / mesh.world)
