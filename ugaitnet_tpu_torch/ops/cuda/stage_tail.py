"""CUDA GaitSet stage tail: 2x2 max pool + leaky ReLU + set max over T,
forward and backward.

Replaces the Pallas TPU kernel ``_tail_kernel`` of
``benchmarks/proto_tail.py`` (forward only there).  The kernels are in
``csrc/stage_tail.cu``, whose header note gives the semantics, the tie rule
of the backward and what bounds them on the card.

The kernel pair is the custom op ``ugaitnet::stage_tail`` (backward:
``ugaitnet::stage_tail_backward``), with a CUDA implementation that
launches the kernel, a fake one that gives the output shapes, and its
autograd.  ``torch.export`` records the op as it records an aten op, so an
exported program calls the kernels; a process that loads such a program
imports this module (which registers the ops and builds nothing) and no
model code.

``stage_tail_cuda`` runs the op for a CUDA tensor and the plain version
(``ops/pooling.py:stage_tail``) for a CPU tensor; it has no other
fallback.  ``fwd_launches`` / ``bwd_launches`` count the kernel launches of
this process (``reset_launch_counts`` sets them to 0).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ugaitnet_tpu_torch.ops.pooling import stage_tail

fwd_launches = 0
bwd_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("stage_tail")
    if not getattr(lib, "_typed", False):
        lib.stage_tail_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _F, _P]
        lib.stage_tail_fwd.restype = _I
        lib.stage_tail_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _F, _P]
        lib.stage_tail_bwd.restype = _I
        lib._typed = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _geometry(x: torch.Tensor, batch: int):
    """(B, T, C, H, W) of a (B*T, C, H, W) input; raises on what the
    kernels do not take."""
    if x.ndim != 4:
        raise ValueError(f"the stage tail takes (B*T, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if batch < 1 or n % batch or n == 0:
        raise ValueError(f"{n} frames do not split into a batch of {batch}")
    if c < 1 or h < 2 or w < 2:
        raise ValueError(f"empty pooled output for (C, H, W) = {(c, h, w)}")
    return batch, n // batch, c, h, w


def _validate(t: torch.Tensor, like: torch.Tensor, shape, name: str) -> None:
    """dtype, shape, layout and device of one operand (the launches also
    check that the device is a card)."""
    if t.dtype not in _DTYPES or t.dtype != like.dtype:
        raise ValueError(f"{name}: the kernels take float32 or bfloat16, all "
                         f"of one dtype; got {t.dtype} with {like.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != like.device:
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor "
                         f"on {like.device}, got {tuple(t.shape)}")


def _shapes(b, t, c, h, w):
    return (b * t, c, h // 2, w // 2), (b, c, h // 2, w // 2)


def _operands(x, batch, a=None, s=None, g_a=None, g_s=None):
    """Checks the operands of a launch; returns (geometry, a's shape, s's
    shape)."""
    geo = _geometry(x, batch)
    a_shape, s_shape = _shapes(*geo)
    for name, v, shape in (("x", x, x.shape), ("a", a, a_shape),
                           ("s", s, s_shape), ("g_a", g_a, a_shape),
                           ("g_s", g_s, s_shape)):
        if v is not None:
            _validate(v, x, shape, name)
    return geo, a_shape, s_shape


def _on_card(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA stage tail needs CUDA tensors; x is on "
                         f"{x.device}")


def launch_fwd(x: torch.Tensor, batch: int, alpha: float):
    """One forward launch: (a (B*T, C, H/2, W/2), s (B, C, H/2, W/2))."""
    global fwd_launches
    _on_card(x)
    (b, t, c, h, w), a_shape, s_shape = _operands(x, batch)
    a = torch.empty(a_shape, dtype=x.dtype, device=x.device)
    s = torch.empty(s_shape, dtype=x.dtype, device=x.device)
    # the runtime launches on its current device, which must be x's
    with torch.cuda.device(x.device):
        rc = _lib().stage_tail_fwd(
            x.data_ptr(), a.data_ptr(), s.data_ptr(), _DTYPES[x.dtype], b, t,
            c, h, w, float(alpha),
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "stage_tail_fwd")
    fwd_launches += 1
    return a, s


def launch_bwd(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
               g_a: torch.Tensor, g_s: torch.Tensor, batch: int,
               alpha: float) -> torch.Tensor:
    """One backward launch: dL/dx from the forward's a and s and the
    gradients of both outputs."""
    global bwd_launches
    _on_card(x)
    (b, t, c, h, w), _, _ = _operands(x, batch, a, s, g_a, g_s)
    # an odd extent's dropped row / column gets no gradient and no writer
    dx = torch.empty_like(x) if h % 2 == 0 and w % 2 == 0 \
        else torch.zeros_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stage_tail_bwd(
            x.data_ptr(), a.data_ptr(), s.data_ptr(), g_a.data_ptr(),
            g_s.data_ptr(), dx.data_ptr(), _DTYPES[x.dtype], b, t, c, h, w,
            float(alpha), torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "stage_tail_bwd")
    bwd_launches += 1
    return dx


@torch.library.custom_op("ugaitnet::stage_tail", mutates_args=(),
                         device_types="cuda")
def stage_tail_op(x: torch.Tensor, batch: int, alpha: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both outputs from the forward kernel."""
    return launch_fwd(x, batch, alpha)


@stage_tail_op.register_fake
def _(x, batch, alpha):
    _, a_shape, s_shape = _operands(x, batch)
    return x.new_empty(a_shape), x.new_empty(s_shape)


@torch.library.custom_op("ugaitnet::stage_tail_backward", mutates_args=(),
                         device_types="cuda")
def stage_tail_backward_op(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                           g_a: torch.Tensor, g_s: torch.Tensor, batch: int,
                           alpha: float) -> torch.Tensor:
    """dx from the backward kernel."""
    return launch_bwd(x, a, s, g_a, g_s, batch, alpha)


@stage_tail_backward_op.register_fake
def _(x, a, s, g_a, g_s, batch, alpha):
    _operands(x, batch, a, s, g_a, g_s)
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    # x and the outputs a and s (a is alive anyway: the next conv saves
    # it), never the pooled p or alpha * p
    x, batch, alpha = inputs
    a, s = output
    ctx.save_for_backward(x, a, s)
    ctx.batch, ctx.alpha = batch, alpha


def _backward(ctx, g_a, g_s):
    x, a, s = ctx.saved_tensors
    dx = stage_tail_backward_op(x, a, s, g_a.contiguous(), g_s.contiguous(),
                                ctx.batch, ctx.alpha)
    return dx, None, None


stage_tail_op.register_autograd(_backward, setup_context=_setup_context)


def stage_tail_cuda(x: torch.Tensor, batch: int, alpha: float = 0.3):
    """Drop-in for ``ops.pooling.stage_tail``: x (B*T, C, H, W) ->
    (a, s).  A CPU tensor takes the plain version; any other goes to the
    op, whose kernels raise on a dtype, shape or layout they do not take."""
    if x.device.type == "cpu":
        return stage_tail(x, batch, alpha)
    return stage_tail_op(x, int(batch), float(alpha))
