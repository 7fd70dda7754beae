"""CUDA batch-all triplet loss: forward and analytic backward.

Replaces the Pallas TPU kernels of ``ugaitnet_tpu/ops/pallas/triplet_kernel.py``
(``_fwd_kernel`` / ``_bwd_kernel`` and their gridded variants for B > 128).
The kernels are in ``csrc/triplet_kernel.cu``, whose header note gives the
design and what bounds it on the card.  One path serves every batch size;
``plan`` chooses the launch geometry (tiles, grids, shared memory) for it.

``batch_all_triplet_loss_cuda`` runs the kernels for a CUDA tensor and the
plain version (``ops/triplet.py``) for a CPU tensor; it has no other
fallback.  ``fwd_launches`` / ``bwd_launches`` count the kernel launches of
this process (``reset_launch_counts`` sets them to 0).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ugaitnet_tpu_torch.ops.triplet import batch_all_triplet_loss

fwd_launches = 0
bwd_launches = 0

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# Mirrors of the constants of csrc/triplet_kernel.cu (every kernel runs 256
# threads).
D_CHUNK = 32            # triplet_fwd_kernel: D-chunk of a stage (kKC)
_ROW_STRIDE = D_CHUNK + 4   # triplet_fwd_kernel: shared row stride in floats (kKS)
GRAM_COLS = 128         # triplet_fwd_kernel: Gram columns per pass (kCB)
J_CHUNK = 32            # triplet_finish_kernel: x rows per stage (kJC)
COLS = 128              # triplet_finish_kernel: columns per CTA (kDC)
MAX_SMEM = 232_448      # dynamic shared memory a CTA may ask for on an H100
SMS = 132               # streaming multiprocessors of an H100 SXM


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry of the three kernels for one (P, B, D).

    triplet_fwd_kernel: one CTA per (part, tile of ``fwd_ta`` anchors), grid
    (``fwd_grid_x``, P), writing one (sum, count) partial per CTA.
    triplet_rows_kernel: one CTA per (part, tile of ``rows_ta`` anchors).
    triplet_finish_kernel: one CTA per (part, ``fin_ti`` rows, ``COLS`` columns),
    grid (``fin_grid_x``, ``fin_grid_y``, P).  The ``*_smem`` fields are the
    dynamic shared-memory bytes of each launch."""
    fwd_ta: int
    fwd_grid_x: int
    fwd_smem: int
    rows_ta: int
    rows_grid_x: int
    rows_smem: int
    fin_ti: int
    fin_grid_x: int
    fin_grid_y: int
    fin_smem: int


def fwd_smem_bytes(ta: int, b: int) -> int:
    """Stages [2][(ta + GRAM_COLS) rows], d rows [ta][B], norms [B], labels
    [B], warp partials [2][8]."""
    return 4 * (2 * (ta + GRAM_COLS) * _ROW_STRIDE + ta * b + 2 * b + 16)


def rows_smem_bytes(ta: int, b: int) -> int:
    """d rows [ta][B], labels [B], counts [ta][B]."""
    return 4 * (2 * ta * b + b)


def finish_smem_bytes(ti: int, b: int) -> int:
    """x stages [2][J_CHUNK][COLS], W rows [ti][B | 1]."""
    return 4 * (2 * J_CHUNK * COLS + ti * (b | 1))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pick(tiles, smem, ctas):
    """The largest tile that fits in shared memory and still gives every SM
    a CTA; else the smallest that fits (the most CTAs); None if none fits."""
    fits = [t for t in tiles if smem(t) <= MAX_SMEM]
    return next((t for t in fits if ctas(t) >= SMS), fits[-1] if fits else None)


@functools.lru_cache(maxsize=64)
def plan(p: int, b: int, d: int) -> Plan:
    """Tile sizes, grids and shared memory for (P, B, D); the tiles shrink as
    B grows so that every CTA asks for at most MAX_SMEM bytes."""
    if min(p, b, d) < 1:
        raise ValueError(f"empty triplet problem (P, B, D) = {(p, b, d)}")
    ta = _pick((32, 16, 8), lambda t: fwd_smem_bytes(t, b),
               lambda t: _cdiv(b, t) * p)
    # triplet_rows_kernel runs one warp per anchor: tiles under 8 idle warps, so
    # they are taken only where shared memory forces them
    ra = (_pick((16, 8), lambda t: rows_smem_bytes(t, b),
                lambda t: _cdiv(b, t) * p)
          or next((t for t in (4, 2, 1) if rows_smem_bytes(t, b) <= MAX_SMEM),
                  None))
    ti = _pick((32, 16, 8), lambda t: finish_smem_bytes(t, b),
               lambda t: _cdiv(b, t) * _cdiv(d, COLS) * p)
    if ta is None or ra is None or ti is None:
        raise ValueError(f"batch {b} is too large for the triplet kernels' "
                         f"shared memory ({MAX_SMEM} bytes a CTA)")
    return Plan(fwd_ta=ta, fwd_grid_x=_cdiv(b, ta),
                fwd_smem=fwd_smem_bytes(ta, b),
                rows_ta=ra, rows_grid_x=_cdiv(b, ra),
                rows_smem=rows_smem_bytes(ra, b),
                fin_ti=ti, fin_grid_x=_cdiv(b, ti), fin_grid_y=_cdiv(d, COLS),
                fin_smem=finish_smem_bytes(ti, b))


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def _lib() -> ctypes.CDLL:
    from ugaitnet_tpu_torch.ops.cuda.build import load
    lib = load("triplet_kernel")
    if not getattr(lib, "_typed", False):
        lib.triplet_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL,
                                    _F, _I, _I, _I, _P]
        lib.triplet_fwd.restype = _I
        lib.triplet_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _LL,
                                    _LL, _F, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.triplet_bwd.restype = _I
        lib._typed = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _geometry(x: torch.Tensor):
    """(P, B, D, part_stride, row_stride) of a contiguous (B, D) or
    (B, P, D) tensor; element (p, i, k) sits at p*part_stride +
    i*row_stride + k."""
    if x.ndim == 2:
        b, d = x.shape
        return 1, b, d, 0, d
    b, p, d = x.shape
    return p, b, d, d, p * d


def _validate(x: torch.Tensor, labels: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA triplet kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the kernel takes contiguous float32 embeddings")
    if x.ndim not in (2, 3) or min(x.shape) < 1:
        raise ValueError(f"embeddings must be (B, D) or (B, P, D), got "
                         f"{tuple(x.shape)}")
    if labels.shape != (x.shape[0],) or labels.dtype != torch.int32 \
            or labels.device != x.device or not labels.is_contiguous():
        raise ValueError("labels must be a contiguous int32 (B,) tensor on "
                         "the embeddings' device")


def fwd_outputs(pl: Plan, p: int, b: int, device):
    """The forward's outputs: dist (P, B, B) and one (sum, count) slot per
    CTA, (P, fwd_grid_x) each, which launch_fwd adds up over dim 1."""
    return (torch.empty((p, b, b), dtype=torch.float32, device=device),
            torch.empty((p, pl.fwd_grid_x), dtype=torch.float32, device=device),
            torch.empty((p, pl.fwd_grid_x), dtype=torch.int32, device=device))


def launch_fwd(x: torch.Tensor, labels: torch.Tensor, margin: float):
    """One forward launch: returns (dist (P, B, B), per-part sum (P,),
    per-part count (P,) float32)."""
    global fwd_launches
    _validate(x, labels)
    p, b, d, ps, rs = _geometry(x)
    pl = plan(p, b, d)
    dist, sums, counts = fwd_outputs(pl, p, b, x.device)
    # the runtime launches on its current device, which must be x's
    with torch.cuda.device(x.device):
        rc = _lib().triplet_fwd(
            x.data_ptr(), labels.data_ptr(), dist.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), p, b, d, ps, rs,
            float(margin), pl.fwd_ta, pl.fwd_grid_x, pl.fwd_smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "triplet_fwd")
    fwd_launches += 1
    return dist, sums.sum(1), counts.sum(1).to(torch.float32)


def launch_bwd(x: torch.Tensor, labels: torch.Tensor, dist: torch.Tensor,
               scale: torch.Tensor, margin: float):
    """One backward launch: returns (dL/dx in x's layout, the scaled
    distance gradient g (P, B, B)) from the per-part scale
    upstream / (count_p * P) (0 where count_p is 0)."""
    global bwd_launches
    _validate(x, labels)
    p, b, d, ps, rs = _geometry(x)
    if dist.shape != (p, b, b) or scale.shape != (p,) \
            or scale.dtype != torch.float32 or not scale.is_contiguous() \
            or not dist.is_contiguous():
        raise ValueError("dist must be (P, B, B) and scale (P,) float32")
    pl = plan(p, b, d)
    g = torch.empty((p, b, b), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().triplet_bwd(
            x.data_ptr(), labels.data_ptr(), dist.data_ptr(),
            scale.data_ptr(), g.data_ptr(), dx.data_ptr(), p, b, d, ps, rs,
            float(margin), pl.rows_ta, pl.rows_grid_x, pl.rows_smem,
            pl.fin_ti, pl.fin_grid_x, pl.fin_grid_y, pl.fin_smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "triplet_bwd")
    bwd_launches += 1
    return dx, g


def combine(per_sum: torch.Tensor, per_cnt: torch.Tensor) -> torch.Tensor:
    """Mean over parts of sum/count, 0 for a part with no active triplet."""
    per_part = torch.where(per_cnt > 0, per_sum / per_cnt.clamp_min(1.0),
                           torch.zeros_like(per_sum))
    return per_part.mean()


class TripletLoss(torch.autograd.Function):
    """Loss value from the forward kernel, gradient from the backward one.
    Saves the distances and per-part counts, as ``_triplet_vjp_fwd``
    saves its counts."""

    @staticmethod
    def forward(ctx, embeddings, labels, margin):
        x = embeddings.to(torch.float32).contiguous()
        lab = labels.reshape(-1).to(torch.int32).contiguous()
        dist, per_sum, per_cnt = launch_fwd(x, lab, margin)
        ctx.save_for_backward(x, lab, dist, per_cnt)
        ctx.margin = margin
        ctx.in_dtype = embeddings.dtype
        return combine(per_sum, per_cnt)

    @staticmethod
    def backward(ctx, grad):
        x, lab, dist, per_cnt = ctx.saved_tensors
        p = per_cnt.shape[0]
        scale = torch.where(per_cnt > 0, grad / (per_cnt.clamp_min(1.0) * p),
                            torch.zeros_like(per_cnt)).contiguous()
        dx, _ = launch_bwd(x, lab, dist, scale, ctx.margin)
        return dx.to(ctx.in_dtype), None, None


def batch_all_triplet_loss_cuda(embeddings: torch.Tensor,
                                labels: torch.Tensor,
                                margin: float = 0.2) -> torch.Tensor:
    """Drop-in for ``ops.triplet.batch_all_triplet_loss``.

    embeddings: (B, D) or batch-major (B, P, D), any float dtype (computed in
    float32, gradient returned in the input dtype); labels: (B,) ids >= 0.
    A CPU tensor takes the plain version; a CUDA tensor takes the kernels.
    """
    if embeddings.device.type == "cpu":
        return batch_all_triplet_loss(embeddings, labels, margin)
    if not embeddings.is_floating_point():
        raise ValueError(f"embeddings must be floating point, got "
                         f"{embeddings.dtype}")
    return TripletLoss.apply(embeddings, labels, float(margin))
