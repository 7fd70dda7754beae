"""Two CUDA probes of the card: a bf16 GEMM at the conv stack's K and an
HBM copy.  No model path calls them; ``chip_smoke.py`` launches them to
measure the ceilings the conv kernels are held against.

- ``mm_fwd`` replaces the Pallas TPU kernel ``_mm_kernel`` of
  ``benchmarks/proto_mm.py``: x (M, K) bf16 times the prototype's weight
  blocks w (K // 128, 128, 128) -> (M, 128) bf16, float32 accumulation
  over the blocks; as in the prototype, x's columns past 128 (K // 128)
  (64 of them at its K = 576) are not read.
- ``scale2`` replaces ``_copy_kernel``: x * 2 over a contiguous bf16
  tensor, the prototype's (T*32*32*32, B) batch-minor view.

The kernels are in ``csrc/probes.cu`` (header note: design and bounds);
``mm_plan`` gives ``mm_fwd``'s persistent grid over 256-row tiles,
``scale2_plan`` ``scale2``'s variant and geometry: ``vec`` (16-byte
streaming loads and stores, one pass a CTA) where x and y lie at the same
offset from a 16-byte boundary, else ``scalar`` (single values).
For a CPU tensor each wrapper takes its plain version; for any other it
launches its kernel or raises.  ``mm_launches`` / ``scale2_launches``
count the launches of this process, ``scale2_variant_launches`` the
latter by variant (``reset_launch_counts`` sets all to 0).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

mm_launches = 0
scale2_launches = 0
scale2_variant_launches = {"vec": 0, "scalar": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

MM_ROWS = 256           # rows a tile (csrc/probes.cu: mm::kBM)
SCALE2_SPAN = 256       # 16-byte chunks (or values) a scale2 CTA


def reset_launch_counts() -> None:
    global mm_launches, scale2_launches
    mm_launches = 0
    scale2_launches = 0
    for k in scale2_variant_launches:
        scale2_variant_launches[k] = 0


@dataclasses.dataclass(frozen=True)
class MMPlan:
    """``grid`` persistent CTAs (one an SM at most) over ``tiles`` tiles of
    MM_ROWS rows of x (the last one ragged where MM_ROWS does not divide
    M); CTA c takes tiles c, c + grid, ..."""
    m: int
    tiles: int
    grid: int


def mm_plan(m: int, sms: int = 132) -> MMPlan:
    tiles = -(-m // MM_ROWS)
    return MMPlan(m=m, tiles=tiles, grid=min(sms, tiles))


@dataclasses.dataclass(frozen=True)
class Scale2Plan:
    """``scale2`` over n values.  vec: the values [head, head + 8 chunks)
    as 16-byte chunks, the ``head`` values before them and the ``tail``
    after (< 8 each) singly in CTA 0; CTA c takes chunks [c SCALE2_SPAN,
    (c + 1) SCALE2_SPAN).  scalar: CTA c takes the values [c SCALE2_SPAN,
    (c + 1) SCALE2_SPAN) singly (chunks = 0, tail = n)."""
    n: int
    variant: str
    head: int
    chunks: int
    tail: int
    grid: int


def scale2_plan(n: int, x_off: int = 0, y_off: int = 0) -> Scale2Plan:
    """The vec variant where x and y lie at the same offset from a 16-byte
    boundary (``x_off``, ``y_off``: their addresses // 2 mod 8) and a
    whole 16-byte chunk follows it; otherwise the scalar one."""
    if n < 1:
        raise ValueError(f"scale2: n = {n}")
    head = (8 - x_off % 8) % 8
    if x_off % 8 != y_off % 8 or n < head + 8:
        return Scale2Plan(n=n, variant="scalar", head=0, chunks=0, tail=n,
                          grid=-(-n // SCALE2_SPAN))
    chunks = (n - head) // 8
    return Scale2Plan(n=n, variant="vec", head=head, chunks=chunks,
                      tail=n - head - 8 * chunks,
                      grid=-(-chunks // SCALE2_SPAN))


def mm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ w (nb, 128, 128) bf16 -> (M, 128) bf16 over x's
    first 128 nb columns: float32 products and sums, one rounding."""
    kw = 128 * w.shape[0]
    return (x[:, :kw].float() @ w.reshape(kw, 128).float()).to(
        torch.bfloat16)


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """x * 2, rounded to x's dtype."""
    return x * 2


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("probes")
    if not getattr(lib, "_typed", False):
        lib.mm_fwd.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _P]
        lib.mm_fwd.restype = _I
        lib.scale2.argtypes = [_P, _P, _LL, _I, _I, _LL, _I, _P]
        lib.scale2.restype = _I
        lib._typed = True
    return lib


def _check(rc: int, what: str, dev: torch.device) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")


def _check_mm(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 3 or tuple(w.shape[1:]) != (128, 128) or \
            x.shape[1] // 128 != w.shape[0] or x.shape[1] % 8 or \
            x.shape[0] < 1 or w.shape[0] < 1:
        raise ValueError(f"mm_fwd takes x (M, K), K a multiple of 8, and w "
                         f"(K // 128, 128, 128), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"mm_fwd takes bfloat16, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()) or \
            x.device != w.device:
        raise ValueError("mm_fwd: x and w must be contiguous, on one device")


def mm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, 128) bf16 from the kernel (w packed K-major first, inside the
    call); the plain version on the CPU."""
    global mm_launches
    if x.device.type == "cpu":
        return mm_plain(x, w)
    _check_mm(x, w)
    y = torch.empty((x.shape[0], 128), dtype=x.dtype, device=x.device)
    wt = torch.empty(w.numel(), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        p = mm_plan(x.shape[0], torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        rc = _lib().mm_fwd(x.data_ptr(), w.data_ptr(), wt.data_ptr(),
                           y.data_ptr(), x.shape[0], 128 * w.shape[0],
                           x.shape[1], p.grid,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "mm_fwd", x.device)
    mm_launches += 1
    return y


def offset16(t: torch.Tensor) -> int:
    """t's first value's offset from a 16-byte boundary, in values."""
    return t.data_ptr() // 2 % 8


def scale2(x: torch.Tensor,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x * 2 (bf16, contiguous) into ``out`` (a new tensor if None): on
    the CPU the plain version; on a card one launch of the variant
    ``scale2_plan`` gives for x's and out's offsets."""
    global scale2_launches
    if x.device.type == "cpu":
        y = scale2_plain(x)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA scale2 needs CUDA tensors; x is on "
                         f"{x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"scale2 takes a non-empty contiguous bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    elif out.dtype != x.dtype or out.shape != x.shape or \
            not out.is_contiguous() or out.device != x.device:
        raise ValueError(f"scale2: out must be a contiguous bfloat16 "
                         f"{tuple(x.shape)} on {x.device}")
    plan = scale2_plan(x.numel(), offset16(x), offset16(out))
    with torch.cuda.device(x.device):
        rc = _lib().scale2(
            x.data_ptr(), out.data_ptr(), plan.n, int(plan.variant == "vec"),
            plan.head, plan.chunks, plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, f"scale2 ({plan.variant})", x.device)
    scale2_launches += 1
    scale2_variant_launches[plan.variant] += 1
    return out
