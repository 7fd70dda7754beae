"""Device-side preprocessing of a raw batch.

Port of ``ugaitnet_tpu/data/pipeline.py:preprocess_batch`` without
augmentation: dequantize/normalize -> frames -> expand-level modality
dropout.  Batch layout after expansion (the reference's interleaving): rows
``[i*E .. i*E+E-1]`` are sample i's original copy followed by its
modality-dropout copies, so P*K label blocks survive.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import DataConfig
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.ops.preprocess import (apply_modality_dropout,
                                                dequant_scale, dequantize,
                                                normalize_uint8,
                                                planes_to_frames)


def _dropout_masks(generator: Optional[torch.Generator], batch: int,
                   nmods: int, expand: int,
                   device: torch.device) -> torch.Tensor:
    """(B, E, nmods) 0/1 keep-masks for the expand copies (copy 0 = all 1).

    2-modality rule (the reference's expand_level): copy 1 disables a
    random modality, copy 2 the other; copies past 3 repeat copy 1.  The
    coin comes from ``generator``, so the masks differ from the JAX
    package's key stream; pass ``masks=`` to ``preprocess_batch`` to
    reproduce a given draw.
    """
    if expand <= 1:
        return torch.ones((batch, expand, nmods), dtype=torch.float32,
                          device=device)
    if nmods != 2:
        raise NotImplementedError(
            "modality-dropout masks for 3+ modalities are not ported yet "
            "(ROADMAP.md, 'Training augmentation')")
    choice = (torch.rand(batch, generator=generator) < 0.5).long().to(device)
    eye = torch.eye(nmods, dtype=torch.float32, device=device)
    copies = [torch.ones((batch, nmods), dtype=torch.float32, device=device),
              1.0 - eye[choice]]
    if expand > 2:
        copies.append(1.0 - eye[1 - choice])
    while len(copies) < expand:
        copies.append(copies[1])
    return torch.stack(copies, dim=1)


def _expand_rows(x: torch.Tensor, expand: int) -> torch.Tensor:
    """Repeat each row E times, interleaved: (B, ...) -> (B*E, ...)."""
    return torch.repeat_interleave(x, expand, dim=0)


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.array(v, copy=True, order="C")).to(device)


def preprocess_batch(raw: Dict[str, object], modalities: Tuple[str, ...],
                     channels: Tuple[int, ...],
                     compress_factors: Tuple[float, ...], ntype: int,
                     expand: int, augmenting: bool, cfg: DataConfig,
                     normalize: bool = False,
                     masks: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                torch.Tensor]:
    """dequant -> frames -> expand + modality dropout, on ``device``.

    raw: ``raw_<m>`` (B, T*C, H, W) int16/uint8, ``present_<m>`` (B,),
    ``labels`` (B,), and with ``normalize`` also ``source`` (B,) and
    ``norm_mean_<m>`` / ``norm_std_<m>`` (n_sources, T*C); numpy arrays or
    tensors.  masks: optional (B, E, nmods) keep-masks; by default they are
    drawn from ``generator``.

    Returns (volumes[(B*E, T, H, W, C_m)], use_flags[(B*E,)], labels (B*E,)).
    """
    if augmenting:
        raise NotImplementedError(
            "augmenting=True is not ported yet (ROADMAP.md, 'Training "
            "augmentation')")
    dev = resolve_device(device)
    labels = _as_tensor(raw["labels"], dev)
    batch = labels.shape[0]

    volumes, use_flags = [], []
    for mi, m in enumerate(modalities):
        x = _as_tensor(raw[f"raw_{m}"], dev)
        if normalize:
            # per-dataset per-plane standardization (BothDatasets regime)
            src = _as_tensor(raw["source"], dev).long()
            mean = _as_tensor(raw[f"norm_mean_{m}"], dev)[src][:, :, None, None]
            std = _as_tensor(raw[f"norm_std_{m}"], dev)[src][:, :, None, None]
        if compress_factors[mi] > 1.0 and normalize:    # quantized (OF)
            # one rounding for x * scale - mean, as XLA's fused multiply-add
            # (exact in float64 for int16 inputs)
            scale = dequant_scale(compress_factors[mi], ntype)
            x = (x.to(torch.float64) * scale - mean.to(torch.float64)
                 ).to(torch.float32)
        elif compress_factors[mi] > 1.0:
            x = dequantize(x, compress_factors[mi], ntype)
        else:
            x = normalize_uint8(x, silhouette=(m == "silhouette"))
            if normalize:
                x = x - mean
        if normalize:
            x = x / std
        volumes.append(x)
        use_flags.append(_as_tensor(raw[f"present_{m}"], dev)
                         .to(torch.float32))

    if masks is None:
        masks = _dropout_masks(generator, batch, len(modalities), expand, dev)
    else:
        masks = _as_tensor(masks, dev).to(torch.float32)
    out_vols, out_flags = [], []
    for mi in range(len(modalities)):
        u = _expand_rows(use_flags[mi], expand) * masks[:, :, mi].reshape(-1)
        v = apply_modality_dropout(_expand_rows(volumes[mi], expand), u,
                                   cfg.noise)
        # frames last: a view that keeps the plane order in memory, which
        # is the per-frame NCHW layout the GaitSet convolutions read
        out_vols.append(planes_to_frames(v, channels[mi]))
        out_flags.append(u)
    return out_vols, out_flags, _expand_rows(labels, expand)
