"""Device-side decode/normalization of packed gait volumes.

Port of ``ugaitnet_tpu/ops/preprocess.py``: raw int16/uint8 planes
``(B, T*C, H, W)`` become float32 frames ``(B, T, H, W, C)``.

Normalization rules (the reference generator's ``__load_dd``):
  * quantized data (compress_factor > 1, e.g. OF stored int16 x100):
    optional clip-augment (|x| outside [clip_min, clip_max] -> 1e-8), then
    / compress_factor, then *0.1 when ntype == 2.
  * uint8 silhouettes: / 255
  * other uint8 (gray/depth): / 255 - 0.5

Rounding: XLA compiles the JAX package's ``x / c`` into ``x * f32(1/c)``
(and folds the ``* 0.1`` into that constant), and fuses ``x * f32(1/255) -
0.5`` (and, with per-dataset standardization, the dequantize multiply and
the mean subtraction) into one fused multiply-add.  The port computes the same
single-rounded values, so the two packages agree bit for bit: the uint8
path in float64 (exact for 8-bit inputs) rounded once to float32, the
quantized path as one float32 multiply.

``planes_to_frames`` returns a permuted view: the memory stays in the plane
order ``(B, T, C, H, W)``, which is exactly the per-frame NCHW layout the
GaitSet convolutions read, so the model's permute back is free.
"""

from __future__ import annotations

import numpy as np
import torch


def _recip(c: float) -> float:
    """float32(1 / c) as a Python float (exact in float32)."""
    return float(np.float32(1.0) / np.float32(c))


def dequant_scale(compress_factor: float, ntype: int = 2) -> float:
    """The one float32 factor XLA folds ``/ compress_factor`` (and, for
    ntype 2, ``* 0.1``) into."""
    scale = np.float32(_recip(compress_factor))
    if ntype == 2:
        scale = scale * np.float32(0.1)
    return float(scale)


def clip_augment(x: torch.Tensor, clip_max: float,
                 clip_min: float) -> torch.Tensor:
    """OF magnitude clip-augment on raw values: |x| outside [clip_min,
    clip_max] -> 1e-8; clip_max <= 0 disables it, min-side wipe included."""
    x = x.to(torch.float32)
    if clip_max <= 0:
        return x
    return torch.where((x.abs() > clip_max) | (x.abs() < clip_min),
                       torch.tensor(1e-8, dtype=x.dtype, device=x.device), x)


def dequantize(raw: torch.Tensor, compress_factor: float, ntype: int = 2,
               clip_max: float = 0.0, clip_min: float = 0.0) -> torch.Tensor:
    """Quantized (e.g. int16 OF) planes -> float32, with optional clip-augment."""
    x = clip_augment(raw, clip_max, clip_min)
    return x * dequant_scale(compress_factor, ntype)


def normalize_uint8(raw: torch.Tensor, silhouette: bool = False) -> torch.Tensor:
    """uint8 planes -> x/255 (silhouettes) or x/255 - 0.5, rounded once."""
    x = raw.to(torch.float64) * _recip(255.0)
    if not silhouette:
        x = x - 0.5
    return x.to(torch.float32)


def normalize_volume(raw: torch.Tensor, modality: str, ntype: int = 2,
                     compress_factor: float = 100.0, clip_max: float = 0.0,
                     clip_min: float = 0.0) -> torch.Tensor:
    """The whole ``__load_dd`` normalization of one modality's planes."""
    if modality == "of":
        return dequantize(raw, compress_factor, ntype, clip_max, clip_min)
    return normalize_uint8(raw, silhouette=(modality == "silhouette"))


def planes_to_frames(x: torch.Tensor, channels: int) -> torch.Tensor:
    """(..., T*C, H, W) channel-planes -> (..., T, H, W, C) frames.

    OF planes are interleaved x0,y0,x1,y1,..., so plane 2t+c belongs to
    frame t channel c.
    """
    *lead, tc, h, w = x.shape
    x = x.reshape(*lead, tc // channels, channels, h, w)
    return x.movedim(-3, -1)


def frames_to_planes(x: torch.Tensor) -> torch.Tensor:
    """Inverse of planes_to_frames: (..., T, H, W, C) -> (..., T*C, H, W)."""
    *lead, t, h, w, c = x.shape
    return x.movedim(-1, -3).reshape(*lead, t * c, h, w)


def apply_modality_dropout(volumes: torch.Tensor, use_flags: torch.Tensor,
                           noise: float = 1e-9) -> torch.Tensor:
    """Replace disabled-modality volumes with the reference's tiny constant
    so the branch still runs and the gate zeroes its embedding."""
    flag = use_flags.reshape(use_flags.shape[0], *([1] * (volumes.ndim - 1)))
    fill = torch.tensor(noise, dtype=volumes.dtype, device=volumes.device)
    return torch.where(flag > 0, volumes, fill)
