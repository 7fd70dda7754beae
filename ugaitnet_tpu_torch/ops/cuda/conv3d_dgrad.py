"""The input gradient of a VALID strided 3D conv, by a hand float32 kernel
(``csrc/conv3d_dgrad.cu``, header note: design and bounds).

cuDNN sends the input gradient of the 3D CNN's strided 3 x 3 x 3 convs to a
direct, non-GEMM engine far from the card's FFMA rate, and that of its
stride-1 conv4 to an implicit GEMM 25x over its bound.  The kernel splits
dx by stride phase into dense implicit GEMMs on the CUDA cores.  The
autograd Function that routes each gradient of a conv is
``ops/cuda/conv3d_route.py:conv3d``; where ``conv3d_route.hand_grads``
finds what both hand kernels ask (a VALID float32 conv with a bias on a
card, in grad mode, outside a compile / export trace), ``fits`` says when
its dx comes from here: x requires a gradient, in the NCDHW layout (the
layout whose rows the kernel copies a warp at a time), and
``shape_rule``: dx of at least ``MIN_TILES`` of the kernel's 128 x 64
tiles.  That is the shape rule that per-conv timings on an H100
set (``chip_smoke.py`` phase 1f, the 3D CNN's conv1-conv5 at N = 120): the
kernel beat cuDNN at conv1-conv4 (dx of 16,905, 6,654, 1,350 and 120 tiles)
by 2.3x, 1.2x, 1.3x and 2.7x, and lost at conv5 (15 tiles: 8 CTAs on a card
of 132 SMs) by 1.7x.

``conv3d_dgrad(gy, weight, size, stride)`` takes gy (N, Co, To, Ho, Wo)
float32 in whatever strides it has and returns dx (N, Ci, *size),
contiguous: on the CPU the plain version (``dgrad_plain``: one matmul a
tap, added into its strided slice), on a card one launch of the weight pack
and the kernel, or it raises.  ``launches`` counts the launches of this
process; each also counts ``conv3d.dgrad_hand`` in the span registry
(``obsv/spans.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ugaitnet_tpu_torch.obsv import spans

launches = 0

# the shape rule: dx spans at least this many of the kernel's tiles of 128
# positions x 64 input channels (csrc/conv3d_dgrad.cu: BM, BN)
MIN_TILES = 64
TILE = 128 * 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def dgrad_plain(gy: torch.Tensor, weight: torch.Tensor, size: Sequence[int],
                stride: Sequence[int]) -> torch.Tensor:
    """dx (N, Ci, *size): for each tap (a, b, c), gy times W[:, :, a, b, c]
    added into dx[:, :, a::st, b::sh, c::sw] over the output's extent."""
    n, ci = gy.shape[0], weight.shape[1]
    to, ho, wo = gy.shape[2:]
    st, sh, sw = stride
    dx = gy.new_zeros((n, ci, *size))
    g = gy.permute(0, 2, 3, 4, 1)                     # (N, To, Ho, Wo, Co)
    for a in range(weight.shape[2]):
        for b in range(weight.shape[3]):
            for c in range(weight.shape[4]):
                dx[:, :, a:a + st * (to - 1) + 1:st, b:b + sh * (ho - 1) + 1:sh,
                   c:c + sw * (wo - 1) + 1:sw] += (
                    g @ weight[:, :, a, b, c]).permute(0, 4, 1, 2, 3)
    return dx


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("conv3d_dgrad")
    if not getattr(lib, "_typed", False):
        lib.conv3d_dgrad.argtypes = [_P, _P, _P, _P, _P, _P] + [_I] * 12 \
            + [_P]
        lib.conv3d_dgrad.restype = _I
        lib.conv3d_dgrad_packed_floats.argtypes = [_I] * 3
        lib.conv3d_dgrad_packed_floats.restype = _L
        lib._typed = True
    return lib


def conv3d_dgrad(gy: torch.Tensor, weight: torch.Tensor,
                 size: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """dx (N, Ci, *size) of the VALID conv with ``weight`` (Co, Ci, kT, kH,
    kW) and ``stride`` whose output gradient is gy (N, Co, To, Ho, Wo)."""
    global launches
    size, stride = tuple(size), tuple(stride)
    kernel = tuple(weight.shape[2:])
    if gy.ndim != 5 or weight.ndim != 5 or len(size) != 3 \
            or len(stride) != 3 or gy.shape[1] != weight.shape[0] \
            or min(s - k for s, k in zip(size, kernel)) < 0 \
            or tuple(gy.shape[2:]) != tuple(
                (s - k) // st + 1 for s, k, st in zip(size, kernel, stride)):
        raise ValueError(f"conv3d_dgrad: gy {tuple(gy.shape)}, weight "
                         f"{tuple(weight.shape)}, size {size}, stride "
                         f"{stride} do not make a VALID conv")
    if gy.device.type == "cpu":
        return dgrad_plain(gy, weight, size, stride)
    if gy.device.type != "cuda" or weight.device != gy.device:
        raise ValueError(f"the CUDA conv3d_dgrad needs gy and the weight on "
                         f"one card; got {gy.device}, {weight.device}")
    if gy.dtype != torch.float32 or weight.dtype != torch.float32:
        raise ValueError(f"conv3d_dgrad takes float32, got {gy.dtype}, "
                         f"{weight.dtype}")
    n = gy.shape[0]
    co, ci = weight.shape[:2]
    dev = gy.device
    lib = _lib()
    weight = weight.contiguous()
    with torch.cuda.device(dev):
        wp = torch.empty(lib.conv3d_dgrad_packed_floats(
            ci, co, math.prod(kernel)), dtype=gy.dtype, device=dev)
        dx = torch.empty((n, ci, *size), dtype=gy.dtype, device=dev)
        rc = lib.conv3d_dgrad(
            gy.data_ptr(), (_L * 5)(*gy.stride()), weight.data_ptr(),
            wp.data_ptr(), dx.data_ptr(), (_L * 5)(*dx.stride()), n, ci, co,
            *size, *kernel, *stride,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_dgrad: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")
    launches += 1
    spans.count("conv3d.dgrad_hand")
    return dx


def shape_rule(x_shape: Sequence[int]) -> bool:
    """Whether the kernel beats cuDNN at the input gradient of a conv whose
    input has shape ``x_shape`` (N, Ci, T, H, W): dx fills MIN_TILES of its
    tiles, about half a wave of CTAs on an H100."""
    return math.prod(x_shape) >= MIN_TILES * TILE


def fits(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """This kernel's own rule, past ``conv3d_route.hand_grads``' shared
    one: an NCDHW x that needs a gradient, ``shape_rule``."""
    return x.requires_grad and x.is_contiguous() and shape_rule(x.shape)
