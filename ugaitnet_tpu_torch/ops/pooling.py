"""2x2 max pooling in the reshape + max form, and the GaitSet stage tail.

Port of ``ugaitnet_tpu/ops/pooling.py``'s off-TPU form.  ``torch.amax``
splits the gradient evenly among tied maxima, as ``jnp.max`` does, whereas
``F.max_pool2d`` routes it to one element.  The noise-filled volumes of a
dropped modality are constant, so every window there is a tie and the two
rules give different weight gradients; this form keeps gradient parity with
the JAX package.
"""

from __future__ import annotations

import torch


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2x2/stride-2 max pool over the trailing (H, W) dims
    of an NCHW tensor; odd extents drop their last row/column (VALID)."""
    h, w = x.shape[-2:]
    x = x[..., : h // 2 * 2, : w // 2 * 2]
    r = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return torch.amax(r, dim=(-3, -1))


def stage_tail(x: torch.Tensor, batch: int, alpha: float = 0.3):
    """The GaitSet frame stream's stage tail, plain: a 2x2 max pool and the
    leaky ReLU ``max(p, alpha p)`` per frame, and the set max over T.
    x: (B*T, C, H, W) with T = rows / batch -> (a (B*T, C, H/2, W/2),
    s (B, C, H/2, W/2)).  The plain version of the CUDA kernels of
    ``ops/cuda/stage_tail.py``; its gradient splits ties evenly, in the
    window and over T, as ``max_pool_2x2`` does."""
    p = max_pool_2x2(x)
    a = torch.maximum(p, alpha * p)
    return a, torch.amax(a.reshape(batch, -1, *a.shape[1:]), dim=1)
