"""Classification losses (port of ``ugaitnet_tpu/ops/losses.py``, the parts
the flagship train step uses)."""

from __future__ import annotations

import torch


def softmax_crossentropy_logits(logits: torch.Tensor, onehot: torch.Tensor,
                                label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean over the batch of -sum(onehot * log_softmax(logits)); smoothing
    mixes the one-hot target with uniform mass."""
    logits = logits.to(torch.float32)
    onehot = onehot.to(torch.float32)
    if label_smoothing > 0.0:
        n = onehot.shape[-1]
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.sum(onehot * logp, dim=-1))


def accuracy(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax (first index on ties) is the label."""
    hit = torch.argmax(probs, -1) == torch.argmax(onehot, -1)
    return hit.to(torch.float32).mean()
