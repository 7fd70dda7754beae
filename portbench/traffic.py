"""The one generator of every traffic mix: data sets made from ``--seed``
and a cell's parameters.

Clips are CASIA-B-shaped: 25 frames of 60 x 60, OF as int16 planes (two a
frame, x100) and gray as uint8 planes, uniform noise in the ranges
``chip_smoke.py:raw_batch`` draws.  Each seed gets the same work: a data
set's shape is the cell's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FRAMES, SIDE = 25, 60
PLANES = {"of": 2 * FRAMES, "gray": FRAMES}
# CASIA-B's ten sequences a subject and camera: nm-01..06, bg-01..02,
# cl-01..02, coded 0 / 1 / 2
CASIAB_GAITS = (0, 0, 0, 0, 0, 0, 1, 1, 2, 2)
CHUNK = 1024


def mix(*parts: int) -> int:
    """A generator seed from several integers (any size)."""
    return hash(tuple(int(p) for p in parts)) % 2 ** 63


def clip_planes(g: torch.Generator, n: int, device) -> Dict[str, torch.Tensor]:
    """n raw clips on ``device``."""
    return {
        "of": torch.randint(-3000, 3000, (n, PLANES["of"], SIDE, SIDE),
                            generator=g, device=device, dtype=torch.int16),
        "gray": torch.randint(0, 255, (n, PLANES["gray"], SIDE, SIDE),
                              generator=g, device=device, dtype=torch.uint8),
    }


def make_clips(seed: int, n: int, device) -> Dict[str, np.ndarray]:
    """n raw clips made on ``device`` in chunks and gathered on the host."""
    out = {m: np.empty((n, p, SIDE, SIDE),
                       np.int16 if m == "of" else np.uint8)
           for m, p in PLANES.items()}
    for i, s in enumerate(range(0, n, CHUNK)):
        g = torch.Generator(device=device).manual_seed(mix(seed, 1, i))
        part = clip_planes(g, min(CHUNK, n - s), device)
        for m, v in part.items():
            torch.from_numpy(out[m][s:s + len(v)]).copy_(v)
    return out


def casiab_columns(ids: int, cameras: int, first_label: int
                   ) -> Dict[str, np.ndarray]:
    """Label, video, gait and camera columns of ids x sequences x cameras
    clips, one clip a video, in subject-major order."""
    seqs = len(CASIAB_GAITS)
    n = ids * seqs * cameras
    sub = np.arange(n) // (seqs * cameras)
    seq = (np.arange(n) // cameras) % seqs
    return {"labels": (first_label + sub).astype(np.int32),
            "video_ids": np.arange(n, dtype=np.int32),
            "gaits": np.asarray(CASIAB_GAITS, np.int32)[seq],
            "cams": (np.arange(n) % cameras).astype(np.int32),
            "set_ids": np.ones(n, np.int32)}


def dataset_arrays(params: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The data set of a train or encode mix: columns plus the raw
    volumes of every modality, all modalities present."""
    cols = casiab_columns(params["ids"], params["cameras"],
                          params.get("first_label", 1))
    cols.update({f"raw_{m}": v for m, v in
                 make_clips(seed, len(cols["labels"]), device).items()})
    return cols
