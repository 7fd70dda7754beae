"""Triplet losses over gait signatures.

Port of ``ugaitnet_tpu/ops/triplet.py``: ``pairwise_dist`` and
``batch_all_triplet_loss`` are the plain PyTorch version (the CPU path, and
the oracle that ``chip_smoke.py`` holds the CUDA kernel to).
``make_triplet_loss`` picks the CUDA kernel (``ops/cuda/triplet_kernel.py``)
for the ``batch_all`` kinds.  ``semi_hard_triplet_loss`` (tfa's
TripletSemiHardLoss, the BothDatasets nets), ``hard_triplet_loss`` (tfa's
TripletHardLoss) and ``contrastive_aux_loss`` are XLA ops in the JAX
package and plain torch here.  They take tfa's masked max / min forms, not
+-inf sentinels, so degenerate batches stay finite, and the reductions are
``amax`` / ``amin``, which share the gradient among ties as XLA's do.
"""

from __future__ import annotations

import functools

import torch

_PART_CHUNK = 8     # parts per (chunk, B, B, B) hinge tensor


def pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix with the reference's zero guard.

    x: (..., B, D) -> (..., B, B).  d2 = |xi|^2 + |xj|^2 - 2 xi.xj, clamped
    at 0; 1e-16 goes under the sqrt exactly where d2 <= 0 and those entries
    are then zeroed, so the gradient there is 0 rather than inf.

    The diagonal d2[i, i] = 2|xi|^2 - 2 xi.xi is identically 0 and is set
    to exactly 0.  The JAX formula leaves a float32 rounding residue there,
    up to ~1e-6 on batch-normalized signatures, i.e. ~1e-3 after the sqrt:
    enough to flip the a == p triplets whose negative sits within 1e-3 of
    the margin, each flip moving single gradient entries by 1/count.  The
    CUDA kernel's diagonal is exactly 0 too, so the two flip together.
    """
    x = x.to(torch.float32)
    sq = torch.sum(x * x, dim=-1)
    dot = torch.matmul(x, x.transpose(-1, -2))
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * dot
    eye = torch.eye(d2.shape[-1], dtype=torch.bool, device=d2.device)
    d2 = torch.clamp_min(d2.masked_fill(eye, 0.0), 0.0)
    zero = d2 <= 0.0
    d = torch.sqrt(d2 + zero.to(d2.dtype) * 1e-16)
    return torch.where(zero, torch.zeros_like(d), d)


def _as_parts_major(embeddings: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (1, B, D); (B, P, D) -> (P, B, D)."""
    if embeddings.ndim == 2:
        return embeddings[None]
    return embeddings.transpose(0, 1)


def batch_all_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                           margin: float = 0.2) -> torch.Tensor:
    """Batch-all triplet loss, reference semantics.

    embeddings: (B, D) or batch-major parts (B, P, D); labels: (B,) ints.

    Per part: the mean over ACTIVE triplets of margin + d(a,p) - d(a,n),
    where (a,p) ranges over same-label pairs INCLUDING a == p and (a,n) over
    different-label pairs; a triplet is active when that hinge is > 0.  A
    part with no active triplet contributes 0; the loss is the mean over
    parts.  Parts go in chunks so the (chunk, B, B, B) tensor stays bounded.
    """
    emb = _as_parts_major(embeddings).to(torch.float32)
    labels = labels.reshape(-1)
    same = labels[:, None] == labels[None, :]
    valid = (same[:, :, None] & ~same[:, None, :]).to(torch.float32)
    per_part = []
    for e in torch.split(emb, _PART_CHUNK, dim=0):
        dist = pairwise_dist(e)                          # (chunk, B, B)
        t = margin + dist[:, :, :, None] - dist[:, :, None, :]
        t = torch.clamp_min(t, 0.0) * valid
        s = torch.sum(t, dim=(1, 2, 3))
        n = torch.sum((t > 0.0).to(torch.float32), dim=(1, 2, 3))
        per_part.append(torch.where(n > 0.0, s / torch.clamp_min(n, 1.0),
                                    torch.zeros_like(s)))
    return torch.mean(torch.cat(per_part))


def semi_hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                           margin: float = 1.0) -> torch.Tensor:
    """tfa's TripletSemiHardLoss (L2, non-squared distances), per part, then
    the mean over parts: ``semi_hard_from_dist`` on ``pairwise_dist``."""
    emb = _as_parts_major(embeddings).to(torch.float32)
    return semi_hard_from_dist(pairwise_dist(emb), labels, margin)


def semi_hard_from_dist(dist: torch.Tensor, labels: torch.Tensor,
                        margin: float = 1.0) -> torch.Tensor:
    """The semi-hard loss of (P, B, B) distances, the mean over parts.

    For each anchor-positive pair (a != p): the negative is the nearest one
    farther than the positive ("outside"), else the farthest negative
    ("inside", tfa's masked maximum: row min + max((d - row min) * mask),
    which degrades to the row min for an anchor without negatives); the
    loss is the mean over those pairs of max(margin + d_ap - d_an, 0).
    Parts go in chunks, so the (chunk, B, B, B) selection stays bounded."""
    labels = labels.reshape(-1)
    b = labels.shape[0]
    adj = labels[:, None] == labels[None, :]
    adj_not = ~adj
    mask_pos = (adj & ~torch.eye(b, dtype=torch.bool, device=adj.device)
                ).to(torch.float32)
    num_pos = torch.clamp_min(mask_pos.sum(), 1e-16)
    big = torch.tensor(1e30, dtype=torch.float32, device=dist.device)
    per_part = []
    for d in torch.split(dist.to(torch.float32), _PART_CHUNK, dim=0):
        # mask[c, a, p, n]: n is a negative of a AND d(a, n) > d(a, p)
        mask = adj_not[None, :, None, :] & (d[:, :, None, :]
                                            > d[:, :, :, None])
        outside = torch.amin(torch.where(mask, d[:, :, None, :], big), dim=3)
        amin = torch.amin(d, dim=2, keepdim=True)
        inside = torch.amax((d - amin) * adj_not.to(d.dtype), dim=2) \
            + amin[..., 0]
        semi = torch.where(mask.any(dim=3), outside, inside[:, :, None])
        loss = torch.clamp_min((margin + d - semi) * mask_pos, 0.0)
        per_part.append(loss.sum(dim=(1, 2)) / num_pos)
    return torch.mean(torch.cat(per_part))


def hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                      margin: float = 1.0, soft: bool = False
                      ) -> torch.Tensor:
    """tfa's TripletHardLoss per part, then the mean over parts:
    ``hard_from_dist`` on ``pairwise_dist``."""
    emb = _as_parts_major(embeddings).to(torch.float32)
    return hard_from_dist(pairwise_dist(emb), labels, margin, soft)


def hard_from_dist(dist: torch.Tensor, labels: torch.Tensor,
                   margin: float = 1.0, soft: bool = False) -> torch.Tensor:
    """The hard loss of (P, B, B) distances: per anchor the hardest
    positive (a != p) against the hardest negative, max(d_ap - d_an +
    margin, 0) (or log1p(exp(d_ap - d_an)) when ``soft``), the mean over
    anchors, then over parts.  tfa's masked forms: an anchor without
    positives takes its row min (0), one without negatives its row max."""
    labels = labels.reshape(-1)
    b = labels.shape[0]
    adj = labels[:, None] == labels[None, :]
    mask_pos = (adj & ~torch.eye(b, dtype=torch.bool, device=adj.device))
    d = dist.to(torch.float32)
    amin = torch.amin(d, dim=2, keepdim=True)
    hard_pos = torch.amax((d - amin) * mask_pos.to(d.dtype), dim=2) \
        + amin[..., 0]
    amax = torch.amax(d, dim=2, keepdim=True)
    hard_neg = torch.amin((d - amax) * (~adj).to(d.dtype), dim=2) \
        + amax[..., 0]
    if soft:
        per_part = torch.mean(torch.log1p(torch.exp(hard_pos - hard_neg)),
                              dim=1)
    else:
        per_part = torch.mean(torch.clamp_min(hard_pos - hard_neg + margin,
                                              0.0), dim=1)
    return torch.mean(per_part)


def contrastive_aux_loss(embeddings: torch.Tensor, labels: torch.Tensor
                         ) -> torch.Tensor:
    """The reference's aux "contrastive" loss: the mean anchor-positive
    distance over valid (a, p, n) triplets (all distinct, lab[p] == lab[a]
    != lab[n]) on the per-sample flattened embedding.  Labels carry a x100
    camera / condition code, stripped by floor division."""
    emb = embeddings.to(torch.float32)
    if emb.ndim == 3:
        emb = emb.reshape(emb.shape[0], -1)
    labels = torch.div(labels.reshape(-1), 100, rounding_mode="floor")
    b = labels.shape[0]
    d = pairwise_dist(emb)
    neq = ~torch.eye(b, dtype=torch.bool, device=d.device)
    eq = labels[:, None] == labels[None, :]
    valid = (neq[:, :, None] & neq[:, None, :] & neq[None, :, :]
             & eq[:, :, None] & ~eq[:, None, :])
    t = torch.clamp_min(d[:, :, None] * valid.to(d.dtype), 0.0)
    num_pos = torch.sum((t > 1e-16).to(torch.float32))
    return torch.sum(t) / (num_pos + 1e-16)


def make_triplet_loss(kind: str = "batch_all", margin: float = 0.2):
    """``batch_all`` / ``batch_all_pallas``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``batch_all_xla``: always
    the plain version.  ``semi_hard`` / ``hard``: plain torch."""
    if kind in ("batch_all", "batch_all_pallas"):
        from ugaitnet_tpu_torch.ops.cuda.triplet_kernel import (
            batch_all_triplet_loss_cuda)
        return functools.partial(batch_all_triplet_loss_cuda, margin=margin)
    if kind == "batch_all_xla":
        return functools.partial(batch_all_triplet_loss, margin=margin)
    if kind == "semi_hard":
        return functools.partial(semi_hard_triplet_loss, margin=margin)
    if kind == "hard":
        return functools.partial(hard_triplet_loss, margin=margin)
    raise ValueError(f"unknown triplet kind: {kind}")
