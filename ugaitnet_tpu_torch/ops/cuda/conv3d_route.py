"""The one autograd path of a VALID 3D conv whose gradients the hand kernels
take: dx from ``conv3d_dgrad`` (``csrc/conv3d_dgrad.cu``), dW and db from
``conv3d_wgrad`` (``csrc/conv3d_wgrad.cu``).

``hand_grads(x, weight, bias, padding)`` is where the two kernels' rules are
read, once a call: (dx, dW and db) from the hand kernels.  What both
kernels ask is checked here, once: a VALID conv with a bias (the kernels
compute VALID convs; DeepGaitV2's padded, bias-free convs and its 1 x 1 x 1
shortcuts stay on cuDNN) and ``engages``: x on a card, and ``fits``: a 5-D
weight, float32 x and weight, grad mode on, no ``torch.compile`` /
``torch.export`` trace.  Then each kernel's own ``fits`` decides.

``conv3d(x, weight, bias, stride, hand)`` is cuDNN's forward, and a backward
that takes each gradient from the route ``hand`` fixed at the forward and
whatever is left from ``torch.ops.aten.convolution_backward`` with an
output mask for exactly those gradients.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ugaitnet_tpu_torch.ops.cuda import conv3d_dgrad as CD
from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW


def fits(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """What both kernels ask of a conv but its device: a 5-D weight,
    float32 x and weight, grad mode on, no compile / export trace."""
    return (weight.ndim == 5 and x.dtype == torch.float32
            and weight.dtype == torch.float32 and torch.is_grad_enabled()
            and not torch.compiler.is_compiling())


def engages(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether a conv of x with ``weight`` may take a hand gradient: on a
    card, where ``fits`` says so."""
    return x.is_cuda and fits(x, weight)


def hand_grads(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor],
               padding: int) -> Tuple[bool, bool]:
    """Whether dx, and dW with db, of the conv of x with ``weight`` come
    from the hand kernels."""
    if padding != 0 or bias is None or not engages(x, weight):
        return False, False
    return CD.fits(x, weight), CW.fits(x, weight)


class _Conv3d(torch.autograd.Function):
    """cuDNN's forward; dx by ``conv3d_dgrad`` where ``hand[0]``, dW and db
    by ``conv3d_wgrad`` where ``hand[1]``, the rest (of what is asked for)
    by ``convolution_backward`` alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, hand):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.hand = stride, hand
        return F.conv3d(x, weight, bias, stride=stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        hand_dx, hand_dw = ctx.hand
        gx = dw = db = None
        if need[0] and hand_dx:
            gx = CD.conv3d_dgrad(gy, weight, x.shape[2:], ctx.stride)
        if (need[1] or need[2]) and hand_dw:
            dw, db = CW.conv3d_wgrad(x, gy, weight.shape[2:], ctx.stride)
        mask = [need[0] and gx is None, need[1] and dw is None,
                need[2] and db is None]
        if any(mask):
            rest = torch.ops.aten.convolution_backward(
                gy, x, weight, [weight.shape[0]] if mask[2] else None,
                list(ctx.stride), [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1,
                mask)
            gx, dw, db = (r if m else g for r, m, g in zip(
                rest, mask, (gx, dw, db)))
        return (gx, dw if need[1] else None, db if need[2] else None,
                None, None)


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride: Sequence[int],
           hand: Tuple[bool, bool]) -> torch.Tensor:
    """``F.conv3d(x, weight, bias, stride=stride)`` (VALID), whose input
    gradient comes from the hand kernel where ``hand[0]`` and whose weight
    and bias gradients come from the other where ``hand[1]``."""
    return _Conv3d.apply(x, weight, bias, tuple(stride),
                         tuple(map(bool, hand)))
