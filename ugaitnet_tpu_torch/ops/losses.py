"""Classification and pair / verification losses (port of
``ugaitnet_tpu/ops/losses.py``).

  * categorical cross-entropy over probabilities (Keras clip) and over
    logits, both with label smoothing;
  * sigmoid focal cross-entropy (tfa.losses.SigmoidFocalCrossEntropy, the
    BothDatasets nets' id loss);
  * the VerifLossLayer margin contrastive pair loss and the smooth-L1
    PairLossLayer of the Siamese nets.
"""

from __future__ import annotations

from typing import Optional

import torch


def _smooth(onehot: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    """Mix the one-hot target with uniform mass."""
    onehot = onehot.to(torch.float32)
    if label_smoothing > 0.0:
        n = onehot.shape[-1]
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n
    return onehot


def categorical_crossentropy(probs: torch.Tensor, onehot: torch.Tensor,
                             label_smoothing: float = 0.0,
                             eps: float = 1e-7) -> torch.Tensor:
    """Keras CCE over probabilities: clip to [eps, 1 - eps], then the mean
    over the batch of -sum(onehot * log(probs))."""
    probs = torch.clamp(probs.to(torch.float32), eps, 1.0 - eps)
    onehot = _smooth(onehot, label_smoothing)
    return torch.mean(-torch.sum(onehot * torch.log(probs), dim=-1))


def softmax_crossentropy_logits(logits: torch.Tensor, onehot: torch.Tensor,
                                label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean over the batch of -sum(onehot * log_softmax(logits))."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.mean(-torch.sum(_smooth(onehot, label_smoothing) * logp,
                                 dim=-1))


def sigmoid_focal_crossentropy(probs: torch.Tensor, onehot: torch.Tensor,
                               alpha: Optional[float] = 0.25,
                               gamma: float = 2.0,
                               from_logits: bool = False) -> torch.Tensor:
    """tfa's SigmoidFocalCrossEntropy: per class alpha_t (1 - p_t)^gamma
    times the binary cross-entropy, summed over classes, then the mean over
    the batch.  ``probs`` are probabilities (clipped to [1e-7, 1 - 1e-7])
    unless ``from_logits``."""
    y = onehot.to(torch.float32)
    if from_logits:
        x = probs.to(torch.float32)
        p = torch.sigmoid(x)
        bce = (torch.clamp_min(x, 0.0) - x * y
               + torch.log1p(torch.exp(-x.abs())))
    else:
        p = torch.clamp(probs.to(torch.float32), 1e-7, 1.0 - 1e-7)
        bce = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    p_t = y * p + (1.0 - y) * (1.0 - p)
    alpha_f = (y * alpha + (1.0 - y) * (1.0 - alpha)
               if alpha is not None else 1.0)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    return torch.mean(torch.sum(alpha_f * modulating * bce, dim=-1))


def verif_pair_loss(emb1: torch.Tensor, emb2: torch.Tensor,
                    labels: torch.Tensor, margin: float = 0.5
                    ) -> torch.Tensor:
    """VerifLossLayer: 0.5 * the summed squared distance of the positive
    pairs (label 1), plus 0.5 * max(0, margin - sqrt(r))^2 where r is the
    squared residual pooled over ALL negative pairs (label 0): a
    batch-level margin, as the reference has it.  1e-12 under the sqrt
    keeps the gradient finite for a batch without negatives."""
    res2 = torch.sum(torch.square(emb1.to(torch.float32)
                                  - emb2.to(torch.float32)), dim=-1)
    labels = labels.reshape(-1)
    pos = (labels == 1).to(torch.float32)
    neg = (labels == 0).to(torch.float32)
    xpos = 0.5 * torch.sum(res2 * pos)
    xneg = 0.5 * torch.square(torch.clamp_min(
        margin - torch.sqrt(torch.sum(res2 * neg) + 1e-12), 0.0))
    return xpos + xneg


def smooth_l1_pair_loss(emb1: torch.Tensor, emb2: torch.Tensor,
                        delta: float = 0.5) -> torch.Tensor:
    """PairLossLayer: Huber-style smooth L1 of emb1 - emb2, summed over
    every element."""
    x = (emb1.to(torch.float32) - emb2.to(torch.float32)).abs()
    return torch.sum(torch.where(x < delta, 0.5 * x * x,
                                 delta * (x - 0.5 * delta)))


def accuracy(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax (first index on ties) is the label."""
    hit = torch.argmax(probs, -1) == torch.argmax(onehot, -1)
    return hit.to(torch.float32).mean()
