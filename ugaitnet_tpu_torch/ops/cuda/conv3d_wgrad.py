"""The weight and bias gradient of a VALID strided 3D conv, by a hand
float32 kernel (``csrc/conv3d_wgrad.cu``, header note: design and bounds).

cuDNN sends the weight gradient of the 3D CNN's first conv (few input
channels: 2 optical-flow or 1 gray, 3 x 5 x 5 taps, stride 1 x 2 x 2) to a
direct, grouped kernel far from the card's FFMA rate.  The autograd
Function that routes each gradient of a conv is
``ops/cuda/conv3d_route.py:conv3d``; where ``conv3d_route.hand_grads``
finds what both hand kernels ask (a VALID float32 conv with a bias on a
card, in grad mode, outside a compile / export trace), ``fits`` says when
its dW and db come from here: the weight requires a gradient and has at
most ``MAX_TAPS`` taps a output channel (Ci kT kH kW).  The kernel holds
all of a block's taps in one CTA, and deeper layers run well on cuDNN's
implicit GEMM.

``conv3d_wgrad(x, gy, kernel, stride)`` takes x (N, Ci, T, H, W) and gy
(N, Co, To, Ho, Wo) float32 in whatever strides they have (nothing is
copied): on the CPU the plain version (``wgrad_plain``: im2col and one
matmul), on a card one launch of the kernel and its reduction, whose grid
and scratch the C side plans (``conv3d_wgrad_plan``), or it raises.  ``launches`` counts the launches of this process; each also counts
``conv3d.wgrad_hand`` in the span registry (``obsv/spans.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from ugaitnet_tpu_torch.obsv import spans

launches = 0

MAX_TAPS = 255          # Ci kT kH kW (csrc/conv3d_wgrad.cu: MAX_TAPS)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def out_size(size: Sequence[int], kernel: Sequence[int],
             stride: Sequence[int]) -> Tuple[int, ...]:
    return tuple((s - k) // st + 1 for s, k, st in zip(size, kernel, stride))


def wgrad_plain(x: torch.Tensor, gy: torch.Tensor, kernel: Sequence[int],
                stride: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW (Co, Ci, kT, kH, kW) and db (Co): the kernel's GEMM, gy (Co x Q)
    times the im2col of x (Q x Ci kT kH kW), with one matmul."""
    kt, kh, kw = kernel
    st, sh, sw = stride
    ci, co = x.shape[1], gy.shape[1]
    To, Ho, Wo = gy.shape[2:]
    cols = x.unfold(2, kt, st).unfold(3, kh, sh).unfold(4, kw, sw)
    cols = cols[:, :, :To, :Ho, :Wo].permute(0, 2, 3, 4, 1, 5, 6, 7)
    cols = cols.reshape(-1, ci * kt * kh * kw)
    g = gy.permute(0, 2, 3, 4, 1).reshape(-1, co)
    return (g.t() @ cols).reshape(co, ci, kt, kh, kw), g.sum(0)


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("conv3d_wgrad")
    if not getattr(lib, "_typed", False):
        lib.conv3d_wgrad.argtypes = [_P, _P, _P, _P, _P, _P, _P] + [_I] * 13 \
            + [_P]
        lib.conv3d_wgrad.restype = _I
        lib.conv3d_wgrad_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I),
                                                     ctypes.POINTER(_L)]
        lib.conv3d_wgrad_plan.restype = _I
        lib._typed = True
    return lib


def _check(rc: int, what: str, dev: torch.device) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")


def _strides(t: torch.Tensor) -> ctypes.Array:
    return (_L * 5)(*t.stride())


def conv3d_wgrad(x: torch.Tensor, gy: torch.Tensor, kernel: Sequence[int],
                 stride: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) of the VALID conv of x (N, Ci, T, H, W) with stride
    ``stride`` whose output gradient is gy (N, Co, To, Ho, Wo)."""
    global launches
    kernel, stride = tuple(kernel), tuple(stride)
    if x.ndim != 5 or gy.ndim != 5 or len(kernel) != 3 or len(stride) != 3 \
            or gy.shape[0] != x.shape[0] or tuple(gy.shape[2:]) != out_size(
                x.shape[2:], kernel, stride):
        raise ValueError(f"conv3d_wgrad: x {tuple(x.shape)}, gy "
                         f"{tuple(gy.shape)}, kernel {kernel}, stride "
                         f"{stride} do not make a VALID conv")
    if x.device.type == "cpu":
        return wgrad_plain(x, gy, kernel, stride)
    if x.device.type != "cuda" or gy.device != x.device:
        raise ValueError(f"the CUDA conv3d_wgrad needs x and gy on one "
                         f"card; got {x.device}, {gy.device}")
    if x.dtype != torch.float32 or gy.dtype != torch.float32:
        raise ValueError(f"conv3d_wgrad takes float32, got {x.dtype}, "
                         f"{gy.dtype}")
    n, ci = x.shape[:2]
    co = gy.shape[1]
    taps = ci * math.prod(kernel)
    if taps > MAX_TAPS:
        raise ValueError(f"conv3d_wgrad: {taps} taps (Ci kT kH kW), at "
                         f"most {MAX_TAPS}")
    dev = x.device
    lib = _lib()
    grid, size = _I(0), _L(0)
    with torch.cuda.device(dev):
        _check(lib.conv3d_wgrad_plan(n, co, *gy.shape[2:], taps,
                                     ctypes.byref(grid), ctypes.byref(size)),
               "conv3d_wgrad plan", dev)
        dw = torch.empty((co, ci, *kernel), dtype=x.dtype, device=dev)
        db = torch.empty(co, dtype=x.dtype, device=dev)
        part = torch.empty(size.value, dtype=x.dtype, device=dev)
        rc = lib.conv3d_wgrad(
            x.data_ptr(), _strides(x), gy.data_ptr(), _strides(gy),
            part.data_ptr(), dw.data_ptr(), db.data_ptr(), n, ci, co,
            *gy.shape[2:], *kernel, *stride, grid.value,
            torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, "conv3d_wgrad", dev)
    launches += 1
    spans.count("conv3d.wgrad_hand")
    return dw, db


def fits(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """This kernel's own rule, past ``conv3d_route.hand_grads``' shared
    one: a weight that requires a gradient, of at most MAX_TAPS taps a
    output channel."""
    return weight.requires_grad and weight[0].numel() <= MAX_TAPS
