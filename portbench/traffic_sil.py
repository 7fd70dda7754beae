"""The silhouette traffic: binary walking-figure clips made from
``--seed`` and a cell's parameters.

A clip is 25 frames of 60 x 60 uint8 silhouettes, 0 or 255, as OpenGait's
silhouette sets store them (Gait3D, GREW), before its 64 x 44 cut.  Each
subject has a body of its own (head, torso and two legs of drawn sizes and
place); each clip draws its gait's phase and cadence, a small shift, and
flips 1 % of the pixels, the speckle of real segmentation.  Every seed
gets the same work: a data set's shape is the cell's.  The clips are made
on ``device`` in chunks and gathered on the host, one gait code for all.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.traffic import mix

FRAMES, SIDE = 25, 60
CHUNK = 512
NOISE = 0.01


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def subject_bodies(seed: int, ids: int, device) -> Dict[str, torch.Tensor]:
    """Each subject's body, (ids,) tensors in pixels of the 60 x 60 frame."""
    g = torch.Generator(device=device).manual_seed(mix(seed, 11))
    u = lambda lo, hi: _uniform(g, ids, lo, hi, device)
    return {"top": u(3.0, 9.0), "foot": u(54.0, 59.0), "head": u(3.5, 5.5),
            "torso": u(4.5, 8.5), "hip": u(0.52, 0.60), "leg": u(1.8, 3.2),
            "swing": u(0.25, 0.45), "x": u(26.0, 34.0)}


def draw_clips(body: Dict[str, torch.Tensor], g: torch.Generator,
               device) -> torch.Tensor:
    """(n, FRAMES, SIDE, SIDE) uint8 clips of the n bodies given."""
    n = body["top"].shape[0]
    u = lambda lo, hi: _uniform(g, n, lo, hi, device)
    phase, period, dx = u(0.0, 2 * math.pi), u(9.0, 15.0), u(-3.0, 3.0)
    t = torch.arange(FRAMES, device=device, dtype=torch.float32)
    yy = torch.arange(SIDE, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(SIDE, device=device, dtype=torch.float32)[None, :]
    c = lambda v: v[:, None, None, None]                       # (n,1,1,1)
    ang = c(body["swing"]) * torch.sin(
        2 * math.pi * t[None, :, None, None] / c(period) + c(phase))
    cx = c(body["x"] + dx) + 0.8 * torch.sin(ang)               # sway
    top, foot = c(body["top"]), c(body["foot"])
    head_r = c(body["head"])
    hip = top + c(body["hip"]) * (foot - top)
    head_y = top + head_r
    head = (yy - head_y) ** 2 + (xx - cx) ** 2 <= head_r ** 2
    mid = (head_y + head_r + hip) / 2
    half = (hip - head_y - head_r) / 2 + 1.0
    torso = (((yy - mid) / half) ** 2
             + ((xx - cx) / c(body["torso"])) ** 2) <= 1.0
    sil = head | torso
    for side in (1.0, -1.0):
        # a leg: the segment from the hip to the foot at angle +-ang
        fx = cx + side * torch.sin(ang) * (foot - hip)
        fy = hip + torch.cos(ang) * (foot - hip)
        vx, vy = fx - cx, fy - hip
        s = (((xx - cx) * vx + (yy - hip) * vy) / (vx * vx + vy * vy)
             ).clamp(0.0, 1.0)
        d2 = (xx - cx - s * vx) ** 2 + (yy - hip - s * vy) ** 2
        sil = sil | (d2 <= c(body["leg"]) ** 2)
    flip = torch.rand(sil.shape, generator=g, device=device) < NOISE
    return ((sil ^ flip).to(torch.uint8) * 255)


def dataset_arrays(params: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Columns and raw clips of ``ids`` subjects x ``clips_per_id`` clips,
    subject-major, one video a clip, one gait code and camera."""
    ids, per = params["ids"], params["clips_per_id"]
    n = ids * per
    sub = np.arange(n) // per
    cols = {"labels": (params.get("first_label", 1) + sub).astype(np.int32),
            "video_ids": np.arange(n, dtype=np.int32),
            "gaits": np.zeros(n, np.int32), "cams": np.zeros(n, np.int32),
            "set_ids": np.ones(n, np.int32)}
    bodies = subject_bodies(seed, ids, device)
    who = torch.from_numpy(sub).to(device)
    raw = np.empty((n, FRAMES, SIDE, SIDE), np.uint8)
    for i, s in enumerate(range(0, n, CHUNK)):
        g = torch.Generator(device=device).manual_seed(mix(seed, 12, i))
        rows = who[s:s + CHUNK]
        part = draw_clips({k: v[rows] for k, v in bodies.items()}, g, device)
        torch.from_numpy(raw[s:s + len(rows)]).copy_(part)
    cols["raw_silhouette"] = raw
    return cols
