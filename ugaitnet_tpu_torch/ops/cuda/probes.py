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
``mm_plan`` gives ``mm_fwd``'s persistent grid over 256-row tiles.
For a CPU tensor each wrapper takes its plain version; for any other it
launches its kernel or raises.  ``mm_launches`` / ``scale2_launches``
count the launches of this process (``reset_launch_counts``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

mm_launches = 0
scale2_launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

MM_ROWS = 256           # rows a tile (csrc/probes.cu: mm::kBM)


def reset_launch_counts() -> None:
    global mm_launches, scale2_launches
    mm_launches = 0
    scale2_launches = 0


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
        lib.scale2.argtypes = [_P, _P, _LL, _P]
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


def scale2(x: torch.Tensor) -> torch.Tensor:
    """x * 2 from the kernel (bf16, contiguous); the plain version on the
    CPU."""
    global scale2_launches
    if x.device.type == "cpu":
        return scale2_plain(x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"scale2 takes a non-empty contiguous bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().scale2(x.data_ptr(), y.data_ptr(), x.numel(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "scale2", x.device)
    scale2_launches += 1
    return y
