"""Filter and sprite image export.

Port of the image half of ``ugaitnet_tpu/utils/net_utils.py`` (the
reference's mj_save_filters / mj_save_sprite).  The freezing and soft-label
helpers of that module are not ported yet (ROADMAP.md section 1, item 12).

``save_filter_grid`` takes the port's conv weight, ``(cout, cin, kh, kw)``
(OIHW) or ``(cout, cin, kt, kh, kw)``, and draws the same grid as the JAX
package's call on the HWIO kernel that the weight bridge
(``utils/weights.py``) makes of it.  Writing a PNG needs PIL.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np


def _to_grid(images: Sequence[np.ndarray], pad: int = 1) -> np.ndarray:
    """Tile 2D images into a square grid, each min-max normalized to [0,255]."""
    n = len(images)
    grid = int(math.ceil(math.sqrt(n)))
    h, w = images[0].shape[:2]
    canvas = np.zeros((grid * (h + pad), grid * (w + pad)), np.uint8)
    for i, img in enumerate(images):
        lo, hi = float(img.min()), float(img.max())
        norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        r, c = divmod(i, grid)
        canvas[r * (h + pad):r * (h + pad) + h,
               c * (w + pad):c * (w + pad) + w] = np.uint8(norm * 255)
    return canvas


def filter_images(weight) -> list:
    """One (kh, kw) image per output channel: the mean over input channels
    (and, for a 3D conv, over time), computed on the HWIO layout exactly as
    the JAX package computes it."""
    w = np.asarray(weight, np.float32)
    # OIHW -> HWIO, OIDHW -> DHWIO: the bridge's transpose
    k = w.transpose(*range(2, w.ndim), 1, 0)
    if k.ndim == 5:
        k = k.mean(axis=0)
    return [k[:, :, :, o].mean(axis=2) for o in range(k.shape[-1])]


def save_filter_grid(weight, path: str) -> str:
    """Export conv filters as one grid PNG (mj_save_filters parity)."""
    canvas = _to_grid(filter_images(weight))
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(canvas).save(path)
    return path


def save_sprite(images: Sequence[np.ndarray], path: str,
                max_size: int = 8192) -> str:
    """TensorBoard projector sprite sheet (mj_save_sprite parity)."""
    from PIL import Image
    grid = int(math.sqrt(len(images))) + 1
    cell = max(int(max_size / grid), 1)
    big = Image.new("RGB", (cell * grid, cell * grid), (0, 0, 0))
    for i, img in enumerate(images):
        lo, hi = float(img.min()), float(img.max())
        norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        im = Image.fromarray(np.uint8(norm * 255)).resize((cell, cell))
        r, c = divmod(i, grid)
        big.paste(im, (c * cell, r * cell))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    big.save(path)
    return path
