"""The plain input path: decode, augmentation, modality dropout.

The semantics are the UGaitNet reference generator's
(``data/mj_dataGeneratorMMUWYHsingle.py``: ``__load_dd``, the
``mj_transgenerator`` draws at :401-417, ``expand_level``) as the program
states them: OF planes are int16 x100 (ntype 2 scales by a further 0.1),
gray planes uint8 mapped to x / 255 - 0.5; 3/4 of the clips get one
shift / zoom (bilinear, edge-clamped) shared by both modalities, half of
those are mirrored (the OF x channel negated), gray also gets a channel
shift and a per-frame min-max rescale times a brightness factor; an
independent coin wipes OF values outside [50, 2300] (raw units) to 1e-8.
Expansion 3 follows each clip with a copy without one modality and a copy
without the other, the order drawn per clip; a dropped modality is filled
with 1e-9.

Rounding is the original pipeline's, as XLA compiles it: a division by a
constant is a multiply by the float32 reciprocal, and each interpolation
step ``a + w * (b - a)`` is one fused multiply-add, rounded once.  The
same float32 inputs on both sides matter: the train cells' gradient norms
move by up to ~1e-3 when the inputs move by an ulp (``PERF.md`` §6).

The draws follow the program's documented stream: batch ``i`` of epoch
``e`` draws from ``torch.Generator().manual_seed(hash((seed, e, i)) %
2**63)``, the modalities' transform parameters in turn, then the dropout
order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

SHIFTS = (-5.0, -3.0, 0.0, 3.0, 5.0)
CHANNELS = {"of": 2, "gray": 1}
GRAY_SCALE = float(np.float32(1.0) / np.float32(255.0))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the float64 product of two float32
    values is exact, so only the sum rounds."""
    return (a.double() * b.double() + c.double()).float()


def batch_generator(seed: int, epoch: int, index: int) -> torch.Generator:
    return torch.Generator().manual_seed(hash((seed, epoch, index)) % 2 ** 63)


def draw_params(g: torch.Generator, n: int, photometric: bool) -> Dict:
    """One modality's draws, in the stream's order."""
    u = lambda lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(n, generator=g)
    shifts = torch.tensor(SHIFTS)
    p = {"apply": u() < 0.75,
         "tx": shifts[torch.randint(len(SHIFTS), (n,), generator=g)],
         "ty": shifts[torch.randint(len(SHIFTS), (n,), generator=g)],
         "zx": u(0.96, 1.04), "zy": u(0.96, 1.04)}
    p["flip"] = p["apply"] & (u() < 0.5)
    if photometric:
        p["brightness"], p["shift"] = u(0.95, 1.05), u(-0.025, 0.025)
    p["clip"] = u() < 0.5
    return p


def _bilinear(x: torch.Tensor, zoom: torch.Tensor, shift: torch.Tensor,
              dim: int) -> torch.Tensor:
    """Resample x (B, T, C, H, W) along ``dim`` (-2 rows, -1 columns) at
    zoom * (i - c) + c + shift, c the centre, clamped to the edge."""
    n = x.shape[dim]
    c = (n - 1) / 2.0
    src = (zoom[:, None].double() * (torch.arange(n, device=x.device)
                                     - c).double() + c).float()
    src = src + shift[:, None]
    lo = src.floor().clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    wt = (src - lo).clamp(0.0, 1.0)
    shape = [x.shape[0], 1, 1, 1, 1]
    shape[dim] = n

    def take(idx):
        full = list(x.shape)
        return torch.gather(x, dim, idx.long().reshape(shape).expand(full))

    w = wt.reshape(shape)
    a, b = take(lo), take(hi)
    return fma(w, b - a, a)


def augment(x: torch.Tensor, p: Dict, is_of: bool) -> torch.Tensor:
    """x (B, T, C, H, W) float32."""
    pb = lambda v: v.reshape(-1, 1, 1, 1, 1).to(x.device)
    out = _bilinear(_bilinear(x, p["zy"].to(x.device), p["ty"].to(x.device),
                              -2),
                    p["zx"].to(x.device), p["tx"].to(x.device), -1)
    if not is_of:
        lo = out.amin(dim=(-2, -1), keepdim=True)
        hi = out.amax(dim=(-2, -1), keepdim=True)
        out = torch.minimum(torch.maximum(out + pb(p["shift"]), lo), hi)
        lo = out.amin(dim=(-3, -2, -1), keepdim=True)
        hi = out.amax(dim=(-3, -2, -1), keepdim=True)
        unit = (out - lo) / (hi - lo).clamp_min(1e-12)
        out = (unit * pb(p["brightness"])).clamp(0.0, 1.0) - 0.5
    x = torch.where(pb(p["apply"]), out, x)
    mirror = x.flip(-1)
    if is_of:
        mirror = torch.cat([-mirror[:, :, :1], mirror[:, :, 1:]], dim=2)
    return torch.where(pb(p["flip"]), mirror, x)


def decode(raw: torch.Tensor, modality: str) -> torch.Tensor:
    """(B, T*C, H, W) raw planes -> float32 planes."""
    if modality == "of":
        return raw.float() * (np.float32(1 / 100) * np.float32(0.1))
    return (raw.double() * GRAY_SCALE - 0.5).float()


def preprocess(raw: Dict[str, torch.Tensor], modalities: Sequence[str],
               g: torch.Generator, augmenting: bool, expand: int
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                          torch.Tensor]:
    """Raw batch on the device -> (volumes (B*E, T, H, W, C), flags, labels)
    with this batch's draws taken from ``g``."""
    labels = raw["labels"]
    n = labels.shape[0]
    params = None
    if augmenting:
        params = [draw_params(g, n, m != "of") for m in modalities]
        for p in params[1:]:
            for k in ("apply", "tx", "ty", "flip"):
                p[k] = params[0][k]
    vols, flags = [], []
    for i, m in enumerate(modalities):
        x = raw[f"raw_{m}"]
        if m == "of" and augmenting:
            x = x.float()
            wipe = (x.abs() > 2300) | (x.abs() < 50)
            clip = params[0]["clip"].to(x.device).reshape(-1, 1, 1, 1)
            x = torch.where(clip & wipe, torch.full_like(x, 1e-8), x)
        x = decode(x, m)
        c = CHANNELS[m]
        x = x.reshape(n, -1, c, *x.shape[-2:])           # (B, T, C, H, W)
        if augmenting:
            x = augment(x, params[i], m == "of")
        vols.append(x)
        flags.append(raw[f"present_{m}"].float())
    if expand > 1:
        choice = (torch.rand(n, generator=g) < 0.5).long()
        eye = torch.eye(2)
        copies = [torch.ones(n, 2), 1.0 - eye[choice], 1.0 - eye[1 - choice]]
        masks = torch.stack(copies[:expand], dim=1).to(labels.device)
    else:
        masks = torch.ones(n, 1, len(modalities), device=labels.device)
    out_v, out_f = [], []
    for i, x in enumerate(vols):
        u = flags[i].repeat_interleave(expand) * masks[:, :, i].reshape(-1)
        x = x.repeat_interleave(expand, dim=0)
        x = torch.where(u.reshape(-1, 1, 1, 1, 1) > 0, x,
                        torch.full_like(x, 1e-9))
        out_v.append(x.permute(0, 1, 3, 4, 2))            # frames last
        out_f.append(u)
    return out_v, out_f, labels.repeat_interleave(expand)
