"""CUDA 3x3 "SAME" convolution in bfloat16 (float32 accumulation), forward
only.

Replaces the Pallas TPU kernels ``_p1_kernel`` and ``_p2_kernel`` of
``benchmarks/proto_conv.py``, which compute this one function at a_conv6's
and a_conv2's shapes.  The kernel is in ``csrc/conv3x3.cu``, whose header
note gives the semantics, the design and what bounds it on the card;
``plan`` chooses its launch geometry in Python.

The kernel is the custom op ``ugaitnet::conv3x3``, with a CUDA
implementation that launches it and a fake one that gives the output shape
(and refuses what the kernel refuses), so that ``torch.export`` records the
op and an exported bf16 program calls the kernel.  It has no autograd: it
is an inference kernel, which the GaitSet branch routes to only where no
gradient is recorded (``models/gaitset.py``).

``conv3x3_cuda`` runs the plain version (``ops/conv3x3.py:conv3x3``) for a
CPU tensor and the op for any other; it has no other fallback, and a failed
build or launch raises.  ``launches`` counts the kernel launches of this
process (``reset_launch_counts`` sets it to 0).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ugaitnet_tpu_torch.ops.conv3x3 import conv3x3

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int

# Mirrors of the constants of csrc/conv3x3.cu (256 threads a CTA).
TILE_PIXELS = 128       # output pixels a CTA (kBM)
CI_STAGE = 32           # input channels a stage (kKC)
_ROW = CI_STAGE + 8     # shared row stride in bf16 (kKS)


def reset_launch_counts() -> None:
    global launches
    launches = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry for one (N, Ci, Co, H, W): each CTA computes a tile
    of ``tr`` rows x ``tw`` columns of one frame (tr * tw <= 128 pixels)
    for ``bn`` output channels; ``grid`` CTAs, ``smem`` bytes of dynamic
    shared memory each, and ``wp_numel`` bf16 of packed weights."""
    tr: int
    tw: int
    bn: int
    grid: int
    smem: int
    wp_numel: int


def plan(n: int, ci: int, co: int, h: int, w: int) -> Plan:
    """Whole rows of a frame per CTA where a row fits (a_conv6's 16x16: 8
    rows, a_conv2's 64x64: 2), else a 128-column segment of one row; the
    narrowest of 32, 64 and 128 output channels that covers Co (more than
    128 take several CTAs)."""
    tw = min(w, TILE_PIXELS)
    tr = max(1, min(TILE_PIXELS // tw, h))
    bn = 32 if co <= 32 else 64 if co <= 64 else 128
    tiles = -(-h // tr) * -(-w // tw)
    co_pad = -(-co // bn) * bn
    ci_pad = -(-ci // CI_STAGE) * CI_STAGE
    smem = (9 * bn + (tr + 2) * (tw + 2)) * _ROW * 2
    return Plan(tr=tr, tw=tw, bn=bn, grid=n * tiles * (co_pad // bn),
                smem=smem, wp_numel=9 * co_pad * ci_pad)


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("conv3x3")
    if not getattr(lib, "_typed", False):
        lib.conv3x3_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
        lib.conv3x3_fwd.restype = _I
        lib._typed = True
    return lib


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raises on what the kernel does not take."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv3x3 takes x (N, Ci, H, W) and w (Co, Ci, 3, "
                         f"3), got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the conv3x3 kernel takes bfloat16, got {x.dtype} "
                         f"and {w.dtype}")
    n, ci, h, wd = x.shape
    if tuple(w.shape[1:]) != (ci, 3, 3) or w.shape[0] < 1 or \
            min(n, ci, h, wd) < 1:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (N, Ci, H, W) and (Co, "
                         f"Ci, 3, 3)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous (NCHW, OIHW)")
    if w.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch (weight packing + conv kernel): y (N, Co, H, W) bf16."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA conv3x3 needs CUDA tensors; x is on "
                         f"{x.device}")
    _check_operands(x, w)
    n, ci, h, wd = x.shape
    co = w.shape[0]
    p = plan(n, ci, co, h, wd)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    wp = torch.empty(p.wp_numel, dtype=x.dtype, device=x.device)
    # the runtime launches on its current device, which must be x's
    with torch.cuda.device(x.device):
        rc = _lib().conv3x3_fwd(
            x.data_ptr(), w.data_ptr(), wp.data_ptr(), y.data_ptr(), n, ci,
            co, h, wd, p.tr, p.tw, p.bn, p.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_fwd: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    launches += 1
    return y


@torch.library.custom_op("ugaitnet::conv3x3", mutates_args=(),
                         device_types="cuda")
def conv3x3_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y from the kernel."""
    return launch(x, w)


@conv3x3_op.register_fake
def _(x, w):
    _check_operands(x, w)
    return x.new_empty((x.shape[0], w.shape[0], x.shape[2], x.shape[3]))


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``ops.conv3x3.conv3x3``: x (N, Ci, H, W) bf16, w (Co,
    Ci, 3, 3) -> (N, Co, H, W) bf16.  A CPU tensor takes the plain version;
    any other goes to the op (w cast to bf16 first, as the plain version
    casts it), whose kernel raises on a dtype, shape or layout it does not
    take."""
    if x.device.type == "cpu":
        return conv3x3(x, w)
    return conv3x3_op(x, w.to(torch.bfloat16))
