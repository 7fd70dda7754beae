"""Mixture-of-experts part projection: top-1 token-choice routing.

Port of ``ugaitnet_tpu/ops/moe.py``: E shared expert matrices (C, D) and a
learned router over (batch, part) tokens, Switch-style top-1 routing with
a static capacity, router math in float32 whatever the compute dtype.
Tokens past an expert's capacity are dropped (their output row is 0).  The
load-balance loss is ``E * sum_e f_e * p_e``, with ``f_e`` the share of
tokens routed to e and ``p_e`` the mean router probability of e.

The JAX module dispatches and combines with three dense einsums over a
(N, E, Cap) one-hot tensor.  Here the dispatch copies each kept token into
its (expert, slot) row and the combine reads that row back, times the
gate: the same values, since each slot holds at most one token, without
the (N, E, Cap) tensors or a host sync.  Dropped tokens go to one spare
row past the last slot, which no output reads.

Two groups extend it to several ranks (``parallel/``):

  * ``group``: the data ranks of the global form, whose tokens are routed
    as one token set, in the global order ``b * P + p`` of the ranks'
    rows: a token's queue position counts every earlier token of lower
    ranks (an exclusive scan of the per-expert counts), the capacity is the
    caller's for the global token count, and ``f`` and ``p`` are global
    means.
  * ``expert_group``: expert parallelism; ``expert_w`` holds experts
    [``expert_start``, ``expert_start`` + its E), every rank of the group
    routes the same tokens, computes its experts' rows, and the outputs are
    summed over the group.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ugaitnet_tpu_torch.ops.collectives import (all_reduce_sum,
                                                gather_rows_nograd)


def moe_capacity(num_tokens: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Static per-expert slot count (>= 1)."""
    return max(1, int(num_tokens * capacity_factor / num_experts + 0.999999))


def moe_project(tokens: torch.Tensor, router_w: torch.Tensor,
                expert_w: torch.Tensor, capacity: int, group=None,
                expert_group=None, expert_start: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route (N, C) tokens through the experts (E_local, C, D).

    Returns (out (N, D) float32, aux loss scalar, kept (N,) 0/1 float32).
    The expert product takes ``expert_w``'s dtype in and accumulates in
    float32."""
    n, c = tokens.shape
    e = router_w.shape[-1]
    e_local, _, d = expert_w.shape

    logits = tokens.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                   # (N, E)
    gate = probs.amax(dim=-1)                               # (N,)
    choice = torch.argmax(probs, dim=-1)                    # first max
    onehot = F.one_hot(choice, e).to(torch.float32)         # (N, E)

    counts = onehot.sum(dim=0)
    n_all = n
    below = torch.zeros_like(counts)
    if group is not None:
        every = gather_rows_nograd(counts[None], group)     # (ranks, E)
        me = dist.get_rank(group)
        below = every[:me].sum(dim=0)
        counts = every.sum(dim=0)
        n_all = n * every.shape[0]
    frac = counts / n_all
    mean_p = all_reduce_sum(probs.sum(dim=0), group) / n_all
    aux = e * torch.sum(frac * mean_p)

    # 1-based queue position in the chosen expert, then drop past capacity
    pos = torch.sum((torch.cumsum(onehot, dim=0) + below) * onehot, dim=-1)
    kept = (pos <= capacity).to(torch.float32)
    local = (choice >= expert_start) & (choice < expert_start + e_local)
    spare = e_local * capacity
    row = torch.where((kept > 0) & local,
                      (choice - expert_start) * capacity
                      + pos.to(torch.long) - 1,
                      torch.full_like(choice, spare))
    dtype = expert_w.dtype
    xe = tokens.new_zeros((spare + 1, c), dtype=dtype).index_copy(
        0, row, tokens.to(dtype))[:spare]
    ye = torch.bmm(xe.reshape(e_local, capacity, c).to(torch.float32),
                   expert_w.to(torch.float32))              # (E_l, Cap, D)
    ye = torch.cat([ye.reshape(spare, d), ye.new_zeros((1, d))])
    out = gate[:, None] * ye[row]
    return all_reduce_sum(out, expert_group), aux, kept
