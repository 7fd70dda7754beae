"""CUDA 3x3 "SAME" convolution in bfloat16 (float32 accumulation), forward
only.

Replaces the Pallas TPU kernels ``_p1_kernel`` and ``_p2_kernel`` of
``benchmarks/proto_conv.py``, which compute this one function at a_conv6's
and a_conv2's shapes.  The kernels are in ``csrc/conv3x3.cu``, whose header
note gives the semantics, the design and what bounds it on the card: the
Hopper variant (TMA ring, ``wgmma``, persistent CTAs with resident
weights) for frames 16, 32 or 64 wide, the general variant (``mma.sync``)
for every other shape and for an ``x`` that does not start on a 16-byte
boundary (which TMA cannot address).  ``plan`` chooses the variant and
its launch geometry in Python.

The kernel is the custom op ``ugaitnet::conv3x3``, with a CUDA
implementation that launches it and a fake one that gives the output shape
(and refuses what the kernel refuses), so that ``torch.export`` records the
op and an exported bf16 program calls the kernel.  It has no autograd: it
is an inference kernel, which the GaitSet branch routes to only where no
gradient is recorded (``models/gaitset.py``).

``conv3x3_cuda`` runs the plain version (``ops/conv3x3.py:conv3x3``) for a
CPU tensor and the op for any other; it has no other fallback, and a failed
build or launch raises.  ``launches`` counts the kernel launches of this
process, ``variant_launches`` the same by variant (``reset_launch_counts``
sets both to 0).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ugaitnet_tpu_torch.ops.conv3x3 import conv3x3

launches = 0
variant_launches = {"hopper": 0, "general": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int

SMEM_LIMIT = 232_448    # dynamic shared memory of an H100 CTA, bytes
SMS = 132               # an H100 SXM's SMs; launch() reads the card's count

# Mirrors of the constants of csrc/conv3x3.cu.  General variant (256
# threads a CTA):
TILE_PIXELS = 128       # output pixels a CTA (kBM)
CI_STAGE = 32           # input channels a stage (kKC)
_ROW = CI_STAGE + 8     # shared row stride in bf16 (kKS)
# Hopper variant (384 threads: 2 consumer warpgroups, 1 producer):
HOPPER_W = (16, 32, 64)  # frame widths a TMA box row takes (32-128 bytes)
MAX_STAGES = 4          # ring depth, at most (even: half a consumer)


def reset_launch_counts() -> None:
    global launches
    launches = 0
    for k in variant_launches:
        variant_launches[k] = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry for one (N, Ci, Co, H, W).

    ``variant`` "hopper": each of ``grid`` persistent CTAs keeps the
    weights of ``bn`` output channels (Co tile ``cta % n_co``) and walks
    tiles of ``tr`` whole rows (``tw`` = W) with a ring of ``stages`` TMA
    stages of ``cc`` input channels.  "general": one CTA per tile of
    ``tr`` x ``tw`` pixels (at most 128) and Co tile; ``cc`` = 32,
    ``stages`` = 1 (synchronous).  ``smem`` bytes of dynamic shared
    memory a CTA, ``wp_numel`` bf16 of packed weights."""
    variant: str
    n: int
    tr: int
    tw: int
    bn: int
    cc: int
    n_co: int
    stages: int
    grid: int
    smem: int
    wp_numel: int
    tiles_h: int
    tiles_w: int


def _align1k(v: int) -> int:
    return -(-v // 1024) * 1024


def hopper_smem(tr: int, w: int, bn: int, cc: int, nch: int,
                stages: int) -> int:
    """csrc/conv3x3.cu:hv::layout: weights, ring, two band buffers,
    mbarriers, and 1 KB of alignment slack."""
    pm = (tr + 2) * (w + 2) * (cc + 8) * 2
    out = tr * bn * w * 2
    return (1024 + _align1k(9 * nch * bn * cc * 2)
            + stages * _align1k((tr + 2) * cc * w * 2)
            + 2 * _align1k(max(pm, out)) + 8 * (2 * stages + 1))


def plan(n: int, ci: int, co: int, h: int, w: int, sms: int = SMS,
         hopper: bool = True) -> Plan:
    """The Hopper variant where ``hopper`` (x starts on a 16-byte
    boundary), a frame row is one TMA box row (W in 16, 32, 64) and the
    weights fit beside a ring of at least 2 stages: 8 rows
    a tile at W 16, 4 at W 32 and at W 64 with Co <= 32, else 2 (tiles of
    128 or 256 pixels); 32 output channels a CTA where Co <= 32, else
    64 (Co tiles split across neighbouring CTAs); stages of 16 input
    channels where Ci <= 16, else 32; a ring of 4 stages (2 where 4 do
    not fit), half of it each consumer warpgroup's; one CTA an SM.

    Otherwise the general variant: whole rows of a frame per CTA where a
    row fits (128 pixels), else a 128-column segment of one row; the
    narrowest of 32, 64 and 128 output channels that covers Co (more than
    128 take several CTAs)."""
    if hopper and w in HOPPER_W:
        bn = 32 if co <= 32 else 64
        # 64 MT pixels a tile, MT x BN / 2 accumulator registers a thread:
        # MT = 4 only with BN = 32, so that ptxas fits the consumer in the
        # 168 registers of 384 threads without a spill
        tr = 8 if w == 16 else 4 if w == 32 or bn == 32 else 2
        cc = 16 if ci <= 16 else 32
        nch, n_co = -(-ci // cc), -(-co // bn)
        for stages in range(MAX_STAGES, 1, -2):
            smem = hopper_smem(tr, w, bn, cc, nch, stages)
            if smem <= SMEM_LIMIT:
                tiles_h = -(-h // tr)
                grid = min(max(sms // n_co, 1) * n_co, n * tiles_h * n_co)
                return Plan(variant="hopper", n=n, tr=tr, tw=w, bn=bn,
                            cc=cc, n_co=n_co, stages=stages, grid=grid,
                            smem=smem, wp_numel=9 * n_co * bn * nch * cc,
                            tiles_h=tiles_h, tiles_w=1)
    tw = min(w, TILE_PIXELS)
    tr = max(1, min(TILE_PIXELS // tw, h))
    bn = 32 if co <= 32 else 64 if co <= 64 else 128
    tiles_h, tiles_w = -(-h // tr), -(-w // tw)
    n_co = -(-co // bn)
    ci_pad = -(-ci // CI_STAGE) * CI_STAGE
    smem = (9 * bn + (tr + 2) * (tw + 2)) * _ROW * 2
    return Plan(variant="general", n=n, tr=tr, tw=tw, bn=bn, cc=CI_STAGE,
                n_co=n_co, stages=1, grid=n * tiles_h * tiles_w * n_co,
                smem=smem, wp_numel=9 * n_co * bn * ci_pad, tiles_h=tiles_h,
                tiles_w=tiles_w)


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("conv3x3")
    if not getattr(lib, "_typed", False):
        lib.conv3x3_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 13 + [_P]
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


def launch(x: torch.Tensor, w: torch.Tensor,
           general: bool = False) -> torch.Tensor:
    """One launch (weight packing + conv kernel, the variant of ``plan``):
    y (N, Co, H, W) bf16.  ``general`` takes the general variant at any
    shape (``chip_smoke.py`` times it beside the Hopper variant)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA conv3x3 needs CUDA tensors; x is on "
                         f"{x.device}")
    _check_operands(x, w)
    n, ci, h, wd = x.shape
    co = w.shape[0]
    p = plan(n, ci, co, h, wd, torch.cuda.get_device_properties(
        x.device).multi_processor_count,
        hopper=not general and x.data_ptr() % 16 == 0)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    wp = torch.empty(p.wp_numel, dtype=x.dtype, device=x.device)
    # the runtime launches on its current device, which must be x's
    with torch.cuda.device(x.device):
        rc = _lib().conv3x3_fwd(
            x.data_ptr(), w.data_ptr(), wp.data_ptr(), y.data_ptr(), n, ci,
            co, h, wd, int(p.variant == "hopper"), p.tr, p.tw, p.bn, p.cc,
            p.stages, p.grid, p.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_fwd ({p.variant}): error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    launches += 1
    variant_launches[p.variant] += 1
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
