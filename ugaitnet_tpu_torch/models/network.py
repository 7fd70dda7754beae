"""UGaitNet: multimodal gated-fusion gait network.

Port of ``ugaitnet_tpu/models/network.py``: GaitSet, 2D CNN and 3D CNN
branches (``make_branch``), presence gating, the max / average / sign_max
merge, the L2 signature, ``flatten`` and the softmax id head.  Forward taps
are the JAX module's dict keys: ``branches``, ``fused``, ``signature``,
``flatten``, ``classprob_logits`` and ``classprob``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ugaitnet_tpu_torch.core.config import (NUM_FRAMES, BranchConfig,
                                            ModelConfig)
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.models.branches import Conv2DBranch, Conv3DBranch
from ugaitnet_tpu_torch.models.gaitset import GaitSetBranch, glorot_
from ugaitnet_tpu_torch.ops import fusion as F
from ugaitnet_tpu_torch.ops.preprocess import frames_to_planes

_ROADMAP = "(ROADMAP.md, 'The remaining model and loss surface')"
BRANCH_KINDS = ("gaitset", "conv2d", "conv3d")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def make_branch(cfg: BranchConfig, dtype: torch.dtype,
                generator: Optional[torch.Generator]) -> nn.Module:
    if cfg.kind == "gaitset":
        return GaitSetBranch(
            cfg.in_channels, channels=cfg.gaitset_channels,
            hpp_bins=cfg.hpp_bins, part_dim=cfg.part_dim,
            leaky_alpha=cfg.leaky_alpha, dtype=dtype,
            moe_experts=cfg.moe_experts, generator=generator)
    if cfg.kind == "conv2d":
        return Conv2DBranch(
            NUM_FRAMES * cfg.in_channels,
            filters_numbers=cfg.filters_numbers,
            filters_size=cfg.filters_size, ndense_units=cfg.ndense_units,
            dropout=cfg.dropout, activation=cfg.activation,
            leaky_alpha=cfg.leaky_alpha, dtype=dtype, generator=generator)
    if cfg.kind == "conv3d":
        return Conv3DBranch(
            cfg.in_channels, ndense_units=cfg.ndense_units,
            activation=cfg.activation, leaky_alpha=cfg.leaky_alpha,
            dtype=dtype, generator=generator)
    raise ValueError(f"unknown branch kind: {cfg.kind}")


def branch_input(bcfg: BranchConfig, volume: torch.Tensor) -> torch.Tensor:
    """Per-branch input adaptation: the 2D branch reads the (B, T*C, H, W)
    plane stack, the others the (B, T, H, W, C) volume."""
    if bcfg.kind == "conv2d":
        return frames_to_planes(volume)
    return volume


def _check_supported(cfg: ModelConfig) -> None:
    for b in cfg.branches:
        if b.kind not in BRANCH_KINDS:
            raise ValueError(f"unknown branch kind: {b.kind}")
        if b.kind == "gaitset" and b.flatten_output:
            raise NotImplementedError(
                f"gaitset flatten_output is not ported yet {_ROADMAP}")
    for name in ("extra_dense", "aux_losses"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} is not ported yet {_ROADMAP}")
    if cfg.seq_axis or cfg.remat:
        raise NotImplementedError(
            "seq_axis / remat are not ported yet (ROADMAP.md)")


def _head_forward(cfg: ModelConfig, embeddings: Sequence[torch.Tensor],
                  use_flags: Sequence[torch.Tensor],
                  classprob: Optional[nn.Linear]) -> Dict[str, object]:
    """Gating, merge, signature and the id head."""
    batch = embeddings[0].shape[0]
    gated = []
    for e, u in zip(embeddings, use_flags):
        if cfg.norm_before_merge:
            e = F.l2_normalize(e, dim=-1)
        gated.append(F.gate(e, u))

    if cfg.multimodal:
        fused = F.MERGES[cfg.merge](gated)
        sig = F.signature(fused, l2_mode=cfg.l2_mode)
    else:
        # reference quirk: single-modality nets emit the raw branch output
        # as the signature with NO L2 normalization
        fused = gated[0]
        sig = fused

    out: Dict[str, object] = {"branches": gated, "fused": fused,
                              "signature": sig}
    flat = sig.reshape(batch, -1)
    out["flatten"] = flat
    if classprob is not None:
        dt = compute_dtype(cfg)
        logits = torch.nn.functional.linear(
            flat.to(dt), classprob.weight.to(dt), classprob.bias.to(dt))
        logits = logits.to(torch.float32)
        out["classprob_logits"] = logits
        out["classprob"] = torch.softmax(logits, dim=-1)
    return out


class UGaitNet(nn.Module):
    """Branch ``i`` reads ``volumes[i]`` (B, T, H, W, C_i); parameters are
    made from ``seed`` on the CPU and moved to ``device`` (CUDA unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, config: ModelConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        _check_supported(config)
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        dt = compute_dtype(config)
        self.branches = nn.ModuleDict()
        for b in config.branches:
            self.branches[f"branch_{b.modality}"] = make_branch(b, dt, gen)
        self.classprob = None
        if config.nclasses > 0:
            n_in = config.signature_parts * config.signature_dim
            self.classprob = nn.Linear(n_in, config.nclasses)
            glorot_(self.classprob.weight, n_in, config.nclasses, gen)
            with torch.no_grad():
                self.classprob.bias.zero_()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, volumes: Sequence[torch.Tensor],
                use_flags: Optional[Sequence[torch.Tensor]] = None,
                train: Optional[bool] = None, key: Optional[int] = None
                ) -> Dict[str, object]:
        """use_flags[i]: (B,) presence flags (None => all present).
        train: dropout on (the JAX module's ``train``); None follows the
        module's training mode.  key: the dropout masks' key (the JAX
        module's dropout rng), needed where a train-mode branch drops."""
        cfg = self.config
        if train is None:
            train = self.training
        batch = volumes[0].shape[0]
        if use_flags is None:
            use_flags = [torch.ones((batch,), dtype=torch.float32,
                                    device=volumes[0].device)
                         for _ in cfg.branches]
        embeddings: List[torch.Tensor] = [
            self.branches[f"branch_{b.modality}"](
                branch_input(b, volumes[i]), train, key)
            for i, b in enumerate(cfg.branches)]
        return _head_forward(cfg, embeddings, use_flags, self.classprob)
