"""Batch-all triplet loss over gait signatures.

Port of ``ugaitnet_tpu/ops/triplet.py``: ``pairwise_dist`` and
``batch_all_triplet_loss`` are the plain PyTorch version (the CPU path, and
the oracle that ``chip_smoke.py`` holds the CUDA kernel to).
``make_triplet_loss`` picks the CUDA kernel (``ops/cuda/triplet_kernel.py``)
for the ``batch_all`` kinds.
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


def make_triplet_loss(kind: str = "batch_all", margin: float = 0.2):
    """``batch_all`` / ``batch_all_pallas``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``batch_all_xla``: always
    the plain version."""
    if kind in ("batch_all", "batch_all_pallas"):
        from ugaitnet_tpu_torch.ops.cuda.triplet_kernel import (
            batch_all_triplet_loss_cuda)
        return functools.partial(batch_all_triplet_loss_cuda, margin=margin)
    if kind == "batch_all_xla":
        return functools.partial(batch_all_triplet_loss, margin=margin)
    if kind in ("semi_hard", "hard"):
        raise NotImplementedError(
            f"triplet kind {kind!r} is not ported yet (ROADMAP.md, "
            "'The remaining model and loss surface')")
    raise ValueError(f"unknown triplet kind: {kind}")
