"""Modality gating and fusion ops (port of ``ugaitnet_tpu/ops/fusion.py``).

Branch embeddings are batch-major: (B, D) for dense branches and (B, P, D)
for GaitSet part embeddings.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ugaitnet_tpu_torch.ops.collectives import all_reduce_sum


def gate(embedding: torch.Tensor, use_flag: torch.Tensor) -> torch.Tensor:
    """Multiply per-sample embeddings by a binary presence flag.

    embedding: (B, D) or (B, P, D); use_flag: (B,) or (B, 1) of {0., 1.}.
    """
    flag = use_flag.reshape(use_flag.shape[0], *([1] * (embedding.ndim - 1)))
    return embedding * flag.to(embedding.dtype)


def merge_max(embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
    out = embeddings[0]
    for e in embeddings[1:]:
        out = torch.maximum(out, e)
    return out


def merge_average(embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(embeddings) / float(len(embeddings))


def merge_sign_max(embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
    """Signed max: element-wise pick the value of largest magnitude; the
    earliest branch wins ties (``keep = |best| >= |e|``), as tf.argmax does
    in the reference lambda."""
    best = embeddings[0]
    for e in embeddings[1:]:
        best = torch.where(best.abs() >= e.abs(), best, e)
    return best


MERGES = {
    "max": merge_max,
    "maximum": merge_max,
    "average": merge_average,
    "sign_max": merge_sign_max,
}


def l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """tf.math.l2_normalize parity: x * rsqrt(max(sum(x^2), eps))."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, eps))


def signature(fused: torch.Tensor, l2_mode: str = "reference",
              group=None) -> torch.Tensor:
    """L2-normalize the fused embedding into the gait signature.

    For a rank-3 (B, P, D) input, ``l2_mode="reference"`` normalizes over
    the BATCH axis 0: the reference applies l2_normalize(axis=1) to its
    parts-major (P, B, D) tensor.  ``"feature"`` normalizes each per-part
    vector.  ``group``: the data ranks whose rows make up the batch (the
    global data-parallel form); the batch-axis sum of squares is summed
    over them, so each rank holds its rows of the one-process signature.
    """
    if fused.ndim == 2:
        return l2_normalize(fused, dim=1)
    if l2_mode == "reference":
        sq = all_reduce_sum(torch.sum(fused * fused, dim=0, keepdim=True),
                            group)
        return fused * torch.rsqrt(torch.clamp_min(sq, 1e-12))
    return l2_normalize(fused, dim=-1)


def fuse(embeddings: Sequence[torch.Tensor],
         use_flags: Sequence[torch.Tensor], merge: str = "max",
         norm_before_merge: bool = False,
         l2_mode: str = "reference") -> torch.Tensor:
    """gate -> (optional per-branch L2) -> merge -> signature L2-norm."""
    gated = []
    for e, u in zip(embeddings, use_flags):
        if norm_before_merge:
            e = l2_normalize(e, dim=-1)
        gated.append(gate(e, u))
    return signature(MERGES[merge](gated), l2_mode=l2_mode)
