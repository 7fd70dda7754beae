"""2x2 max pooling in the reshape + max form.

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
