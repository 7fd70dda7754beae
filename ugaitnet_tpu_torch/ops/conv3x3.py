"""The 3x3 "SAME" convolution in bfloat16, plain.

The function of the TPU prototypes ``benchmarks/proto_conv.py:_p1_kernel``
(a_conv6's shape) and ``_p2_kernel`` (a_conv2's): bfloat16 operands,
float32 accumulation (their ``preferred_element_type=f32``), one rounding
of the sum to bfloat16.  The plain version of the CUDA kernel of
``ops/cuda/conv3x3.py``: the CPU tests use it, and so does the dispatcher
for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, Ci, H, W) bfloat16, w (Co, Ci, 3, 3) -> (N, Co, H, W)
    bfloat16: zero padding 1, stride 1, no bias.  Products and sums in
    float32 (a bf16 x bf16 product is exact there), rounded once."""
    wb = w.to(torch.bfloat16)
    return F.conv2d(x.to(torch.bfloat16).float(), wb.float(),
                    padding=1).to(torch.bfloat16)
