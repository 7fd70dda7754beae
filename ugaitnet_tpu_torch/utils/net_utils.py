"""Network utilities: freezing, soft labels, filter/sprite image export.

Port of ``ugaitnet_tpu/utils/net_utils.py`` (the reference's
nets/mj_utils.py):

  mj_freezeModel (:13-26)      -> freeze_mask + frozen_optimizer
  mj_softlabel (:238-248)      -> soft_labels
  mj_save_filters/3d (:134-235)-> save_filter_grid
  mj_save_sprite (:95-131)     -> save_sprite

Freezing is in torch idiom: the predicate sees each parameter's path in the
JAX package's flax tree ('params/branch_of/a_conv1/kernel', from
``utils/weights.py:flax_path``), so the JAX predicates carry over, and
``frozen_optimizer`` builds the optimizer over the trainable parameters
only.  A frozen parameter then gets no update and keeps no optimizer state,
which is what ``optax.multi_transform`` with ``set_to_zero`` gives.

``save_filter_grid`` takes the port's conv weight, ``(cout, cin, kh, kw)``
(OIHW) or ``(cout, cin, kt, kh, kw)``, and draws the same grid as the JAX
package's call on the HWIO kernel that the weight bridge
(``utils/weights.py``) makes of it.  Writing a PNG needs PIL.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch

from ugaitnet_tpu_torch.utils.weights import flax_path


def freeze_mask(model: torch.nn.Module, predicate: Callable[[str], bool]
                ) -> Dict[str, str]:
    """{parameter name: 'frozen' where predicate(path) is True, else
    'trainable'}; predicate receives the parameter's '/'-joined flax path,
    like 'params/branch_of/a_conv1/kernel'."""
    return {name: "frozen" if predicate(flax_path(name)) else "trainable"
            for name, _ in model.named_parameters()}


def frozen_optimizer(
        tx: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
        model: torch.nn.Module, predicate: Callable[[str], bool]
) -> torch.optim.Optimizer:
    """The optimizer ``tx(params)`` makes (e.g.
    ``functools.partial(make_optimizer, tcfg)``) over the parameters that
    ``predicate`` leaves trainable: the ones it matches get no update and
    no optimizer state (freeze_convs / freeze_all parity,
    nets/mj_uwyhNets_ba.py:635-660)."""
    labels = freeze_mask(model, predicate)
    return tx([p for name, p in model.named_parameters()
               if labels[name] == "trainable"])


def freeze_convs_predicate(path: str) -> bool:
    return "conv" in path.lower()


def freeze_branches_predicate(path: str) -> bool:
    return "branch_" in path


def soft_labels(labels: Sequence[int], nclasses: int,
                epsilon: float = 0.1) -> np.ndarray:
    """mj_softlabel parity: target class gets 1 - eps*(C-1)/C, others eps/C."""
    labels = np.asarray(labels, int)
    the_class = 1.0 - epsilon * (nclasses - 1) / nclasses
    others = epsilon / nclasses
    out = np.full((len(labels), nclasses), others, np.float32)
    out[np.arange(len(labels)), labels] = the_class
    return out


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
