"""Device-side augmentation of gait clip volumes.

Port of ``ugaitnet_tpu/ops/augment.py``: the reference's host-side
per-frame loops (``data/mj_augmentation.py``) as batched torch ops.

  * mirror_volume       <- mj_mirrorsequence (:12-32)
  * affine_volume       <- mj_transformsequence + Keras apply_affine_transform
                           (shift/zoom, bilinear, edge-clamp fill)
  * photometric_volume  <- Keras brightness + channel-shift branches
  * random_transform_params <- mj_transgenerator distributions (:53-66)

The JAX package's deliberate deviations hold here too: brightness is the
net effect of the reference's PIL uint8 round trip (per-frame min-max
rescale, times the factor, minus 0.5) without the 8-bit quantization, and
the mirror negates the OF x-channel only; ``negate_even_frames=True``
reproduces the reference's negation of every even plane for parity tests.

Public functions take frame-major volumes ``(T, H, W, C)`` with 0-d params,
or batches ``(B, T, H, W, C)`` with ``(B,)`` params.  Inside, the work runs
on ``(B, T, C, H, W)``, the plane order: a frames view made by
``ops/preprocess.py:planes_to_frames`` goes in and comes out without a copy.

Random draws come from a ``torch.Generator``; JAX key streams cannot be
reproduced, so parity with the JAX package is held by passing the same
``TransformParams`` to both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.obsv import spans


class TransformParams(NamedTuple):
    """Per-sample affine/photometric parameters, each a (B,) tensor."""
    apply: torch.Tensor          # bool: the affine applies (3/4 prob)
    tx: torch.Tensor             # horizontal shift in pixels (columns)
    ty: torch.Tensor             # vertical shift in pixels (rows)
    zx: torch.Tensor             # horizontal zoom factor
    zy: torch.Tensor             # vertical zoom factor
    flip: torch.Tensor           # bool: horizontal mirror (1/2 given apply)
    brightness: torch.Tensor     # multiplicative factor (non-OF; 1 = off)
    channel_shift: torch.Tensor  # additive intensity (non-OF; 0 = off)
    clip_of: torch.Tensor        # bool: OF magnitude clip-augment (1/2)


def generator_device(generator: Optional[torch.Generator]) -> torch.device:
    """The device a draw from ``generator`` must be made on (the default
    generator is the CPU's)."""
    return generator.device if generator is not None else torch.device("cpu")


def random_transform_params(generator: Optional[torch.Generator], batch: int,
                            shift_choices: Sequence[int] = (-5, -3, 0, 3, 5),
                            zoom_range: float = 0.04,
                            brightness_range=(0.95, 1.05),
                            channel_shift_range: float = 0.025,
                            photometric: bool = True,
                            augment_prob: float = 0.75,
                            flip_prob: float = 0.5,
                            clip_prob: float = 0.5,
                            device: DeviceLike = None) -> TransformParams:
    """Sample per-sample params with mj_transgenerator's distributions and
    the call-site probabilities (...single.py:401-417): 3/4 apply a
    transform, 1/2 of those flip; the OF clip-augment is an independent 1/2
    coin.  Drawn on ``generator``'s device, returned on ``device``."""
    dev = resolve_device(device)
    gdev = generator_device(generator)

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(batch, generator=generator, device=gdev)
        return lo + (hi - lo) * u

    choices = torch.tensor(shift_choices, dtype=torch.float32, device=gdev)

    def shift():
        return choices[torch.randint(len(shift_choices), (batch,),
                                     generator=generator, device=gdev)]

    apply = uniform() < augment_prob
    tx, ty = shift(), shift()
    zx = uniform(1.0 - zoom_range, 1.0 + zoom_range)
    zy = uniform(1.0 - zoom_range, 1.0 + zoom_range)
    flip = apply & (uniform() < flip_prob)
    if photometric:
        brightness = uniform(*brightness_range)
        channel_shift = uniform(-channel_shift_range, channel_shift_range)
    else:
        brightness = torch.ones(batch, device=gdev)
        channel_shift = torch.zeros(batch, device=gdev)
    clip_of = uniform() < clip_prob
    params = (apply, tx, ty, zx, zy, flip, brightness, channel_shift,
              clip_of)
    for t in params:
        spans.count_pageable("input.pageable_copies", t, dev)
    return TransformParams(*(t.to(dev, non_blocking=True) for t in params))


# --- (B, T, C, H, W) implementations ---------------------------------------

def _per_sample(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1, 1), to broadcast over (B, T, C, H, W)."""
    return v.reshape(-1, 1, 1, 1, 1)


def _mirror(x: torch.Tensor, is_of: bool,
            negate_even_frames: bool = False) -> torch.Tensor:
    out = torch.flip(x, dims=(-1,))
    t, c = x.shape[-4], x.shape[-3]
    if negate_even_frames:
        # the reference's plane stack has plane index t*C + c: negate the
        # even plane indices for ANY C
        plane = (torch.arange(t, device=x.device)[:, None] * c
                 + torch.arange(c, device=x.device)[None, :])
        return torch.where((plane % 2 == 0)[:, :, None, None], -out, out)
    if is_of:
        sign = torch.ones(c, dtype=x.dtype, device=x.device)
        sign[0] = -1.0
        out = out * sign[:, None, None]
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA contracts it into a fused
    multiply-add: float64 holds the float32 product exactly, so only the
    sum rounds (twice, f64 then f32, which can differ from one rounding by
    an ulp only when the f64 sum lands on a float32 midpoint)."""
    return (a.double() * b.double() + c).float()


def _gather(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """x[b, ..., index[b, i], ...] along ``dim`` (-2 rows, -1 columns)."""
    shape = [x.shape[0], 1, 1, 1, 1]
    shape[dim] = index.shape[1]
    size = list(x.shape)
    size[dim] = index.shape[1]
    return torch.gather(x, dim, index.reshape(shape).expand(size))


def _coords(n: int, zoom: torch.Tensor, shift: torch.Tensor):
    """Source coordinates of the inverse map, zoom centered at (n-1)/2:
    (low index, high index, weight of the high one), each (B, n)."""
    center = (n - 1) / 2.0
    grid = torch.arange(n, dtype=torch.float32, device=zoom.device)
    src = _fma(zoom[:, None], grid - center, center) + shift[:, None]
    lo = torch.clamp(torch.floor(src), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    wt = torch.clamp(src - lo, 0.0, 1.0)
    return lo.long(), hi.long(), wt


def _affine(x: torch.Tensor, tx, ty, zx, zy) -> torch.Tensor:
    """Bilinear inverse map with edge clamping (Keras fill_mode='nearest');
    (tx, zx) act on columns, (ty, zy) on rows, as the JAX package pins them
    against tf_keras."""
    h, w = x.shape[-2:]
    r0, r1, wr = _coords(h, zy, ty)
    c0, c1, wc = _coords(w, zx, tx)
    top, bot = _gather(x, -2, r0), _gather(x, -2, r1)
    xr = _fma(wr[:, None, None, :, None], bot - top, top)
    left, right = _gather(xr, -1, c0), _gather(xr, -1, c1)
    return _fma(wc[:, None, None, None, :], right - left, left)


def _photometric(x: torch.Tensor, brightness: torch.Tensor,
                 channel_shift: torch.Tensor) -> torch.Tensor:
    """Channel shift clipped to each frame's per-channel range, then the
    per-frame min-max rescale times the brightness, capped at 1, - 0.5."""
    cmin = torch.amin(x, dim=(-2, -1), keepdim=True)
    cmax = torch.amax(x, dim=(-2, -1), keepdim=True)
    x = torch.clamp(x + _per_sample(channel_shift), cmin, cmax)
    fmin = torch.amin(x, dim=(-3, -2, -1), keepdim=True)
    fmax = torch.amax(x, dim=(-3, -2, -1), keepdim=True)
    unit = (x - fmin) / torch.clamp_min(fmax - fmin, 1e-12)
    return torch.clamp(unit * _per_sample(brightness), 0.0, 1.0) - 0.5


def _augment(x: torch.Tensor, p: TransformParams, is_of: bool,
             photometric: bool) -> torch.Tensor:
    out = _affine(x, p.tx, p.ty, p.zx, p.zy)
    if photometric and not is_of:
        out = _photometric(out, p.brightness, p.channel_shift)
    x = torch.where(_per_sample(p.apply), out, x)
    return torch.where(_per_sample(p.flip), _mirror(x, is_of), x)


# --- frame-major public API ----------------------------------------------

def _frames_op(fn, x: torch.Tensor, *params):
    """Run ``fn`` on the (B, T, C, H, W) view of frame-major ``x``; a single
    (T, H, W, C) volume with 0-d params gets a batch of one."""
    single = x.ndim == 4
    if single:
        x = x[None]
        params = [torch.as_tensor(p, device=x.device).reshape(1)
                  for p in params]
    out = fn(x.movedim(-1, -3), *params).movedim(-3, -1)
    return out[0] if single else out


def mirror_volume(x: torch.Tensor, is_of: bool,
                  negate_even_frames: bool = False) -> torch.Tensor:
    """Horizontal mirror of (…, T, H, W, C) volumes.  For OF the x channel
    (channel 0) changes sign, since mirroring reverses horizontal motion."""
    return _frames_op(lambda v: _mirror(v, is_of, negate_even_frames), x)


def affine_volume(x: torch.Tensor, tx, ty, zx, zy) -> torch.Tensor:
    """Keras apply_affine_transform parity: one shift/zoom per volume,
    shared by all its frames and channels."""
    return _frames_op(_affine, x, tx, ty, zx, zy)


def photometric_volume(x: torch.Tensor, brightness,
                       channel_shift) -> torch.Tensor:
    """Channel shift then brightness, net-effect parity with the Keras
    path (see the module docstring)."""
    return _frames_op(_photometric, x, brightness, channel_shift)


def augment_volume(x: torch.Tensor, p: TransformParams, is_of: bool,
                   photometric: bool = True) -> torch.Tensor:
    """Full augmentation of one (T, H, W, C) volume given 0-d params."""
    return _frames_op(
        lambda v, *ps: _augment(v, TransformParams(*ps), is_of, photometric),
        x, *p)


def augment_batch(x: torch.Tensor, p: TransformParams, is_of: bool,
                  photometric: bool = True) -> torch.Tensor:
    """(B, T, H, W, C) batch variant; one set of (B,) params per sample."""
    out = _augment(x.movedim(-1, -3), p, is_of, photometric)
    return out.movedim(-3, -1)
