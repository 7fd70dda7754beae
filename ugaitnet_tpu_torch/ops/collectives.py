"""Differentiable collectives over ``torch.distributed`` process groups,
and the gradient average of a multi-device step.

The ops, the models and the train step take a group from here; the mesh,
the ranks' start and the steps' multi-device entry points live in
``parallel/``.  Every function is the identity for ``group=None`` (one
process), so the one-device path runs the same code.

Data axis: each backward is an all-reduce-sum of the cotangent (the gather
then keeps its own rows), the transpose of the collective when every rank
computes the same global loss.  After such a backward,
``average_gradients`` makes every rank's gradient the mean over the data
ranks.

Model axis (``parallel/tensor.py``): Megatron's pair, under which the loss
counts once per model group and the cotangent of an activation that every
model rank holds whole is the same on each of them.  ``copy_in`` (forward
the identity, backward an all-reduce-sum) goes before a layer split by its
output; ``reduce_out`` (forward an all-reduce-sum, backward the identity)
closes a layer split by its input; ``gather_parts`` (forward an all-gather
along a dimension, backward this rank's slice) joins strips before a layer
held whole.
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


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * x.shape[dim]
        return gather_along(x.detach(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """Model axis: ``x`` as it is; backward, the sum of the model ranks'
    cotangents (each rank's layer saw only its share of the outputs)."""
    if group is None:
        return x
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """Model axis: the sum of the model ranks' partial ``x``; backward, the
    cotangent as it is (every rank holds the whole one)."""
    if group is None:
        return x
    return _ReduceOut.apply(x, group)


def gather_parts(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Model axis: the ranks' strips of ``x`` joined along ``dim`` in rank
    order; backward, this rank's strip of the (whole) cotangent."""
    if group is None:
        return x
    return _GatherParts.apply(x, group, dim)


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` joined along ``dim`` in rank order, without a
    gradient."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


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
    return gather_along(x, group, 0)


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


MODEL_AXIS = "model"


def average_gradients(model: torch.nn.Module, mesh) -> None:
    """Every parameter's gradient after a backward through the collectives
    above, on a ``parallel.sharding.Mesh``: replicated parameters sum over
    all ranks, expert shards (``parallel/expert.py``) over their data
    ranks, and both divide by the world.  On a mesh with a model axis
    every gradient, of a shard or of a tensor each model rank holds whole
    (and computes identically), is already the model group's: it sums over
    the data ranks only and divides by their count."""
    if MODEL_AXIS in mesh.axis_names:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        _flat_all_reduce(grads, mesh.group(DATA_AXIS),
                         1.0 / mesh.size(DATA_AXIS))
        return
    rep, shards = [], []
    for p in model.parameters():
        if p.grad is None:
            continue
        (shards if getattr(p, "expert_shard", False) else rep).append(p.grad)
    _flat_all_reduce(rep, dist.group.WORLD, 1.0 / mesh.world)
    _flat_all_reduce(shards, mesh.group(DATA_AXIS), 1.0 / mesh.world)
