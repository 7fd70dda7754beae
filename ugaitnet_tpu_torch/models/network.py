"""UGaitNet: multimodal gated-fusion gait network.

Port of ``ugaitnet_tpu/models/network.py``: GaitSet (optionally flattened
per sample, the BothDatasets head), 2D CNN and 3D CNN branches
(``make_branch``), presence gating, the max / average / sign_max merge, the
L2 signature, the extra dense "code" head (casenet C) with its dropout,
the softmax id head and the per-branch aux heads, with remat of the
branches.  Forward taps are the JAX module's dict keys: ``branches``,
``fused``, ``signature``, ``code``, ``flatten``, ``classprob_logits``,
``classprob`` and ``aux_logits``, and ``moe_aux`` (the sum of the MoE
branches' load-balance losses) where a branch routes through experts.

Beyond the JAX module, the port's DeepGaitV2 branch and its BNNeck id head
(``models/deepgaitv2.py``): with a DeepGaitV2 branch and classes
(``ModelConfig.bnneck_scale`` > 0) the head ``bnneck`` takes
``classprob``'s place, ``classprob_logits`` are its scaled per-part cosine
logits (B, P, classes) and ``bnneck`` its normalized feature.

``ModelConfig.seq_axis`` names the mesh axis (``parallel/sequence.py``)
whose ranks each hold a slice of the frames: the model is built with that
mesh, and its GaitSet set pools close over the axis's group.  ``group`` in
``forward`` is the data ranks' group of the global data-parallel form
(``parallel/sharding.py``): the batch-axis L2 of the signature and MoE
routing then span the global batch.

Under tensor parallelism (``parallel/tensor.py:place_tp_model``) the net
carries ``tp`` (its model group) and each GaitSet branch returns this
rank's strip of parts.  The head keeps the strip where every op is local
to a part (gating, the merge, both signature L2 forms, and the id head,
whose ``classprob`` rows are split the same way and close with an
all-reduce), and joins the strips over the model group before a layer that
reads every part (``flatten_output``, ``extra_dense`` and its dropcode,
the aux heads).  ``tp_strips`` names the outputs that stay strips.

``UGaitHead`` is the head alone over branch embeddings (pipeline
parallelism, ``parallel/pipeline.py``), sharing a net's head layers.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence

import torch
import torch.nn.functional as TF
from torch import nn
from torch.utils.checkpoint import checkpoint

from ugaitnet_tpu_torch.core.config import (NUM_FRAMES, BranchConfig,
                                            ModelConfig)
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.models import deepgaitv2 as DG
from ugaitnet_tpu_torch.models.branches import (Conv2DBranch, Conv3DBranch,
                                                Dense, _act, draw_seed,
                                                keyed_dropout)
from ugaitnet_tpu_torch.models.gaitset import GaitSetBranch
from ugaitnet_tpu_torch.ops import fusion as F
from ugaitnet_tpu_torch.ops.collectives import (copy_in, gather_parts,
                                                reduce_out)
from ugaitnet_tpu_torch.ops.preprocess import frames_to_planes

BRANCH_KINDS = ("gaitset", "conv2d", "conv3d", "deepgaitv2")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def make_branch(cfg: BranchConfig, dtype: torch.dtype,
                generator: Optional[torch.Generator]) -> nn.Module:
    if cfg.kind == "gaitset":
        return GaitSetBranch(
            cfg.in_channels, channels=cfg.gaitset_channels,
            hpp_bins=cfg.hpp_bins, part_dim=cfg.part_dim,
            leaky_alpha=cfg.leaky_alpha, dtype=dtype,
            moe_experts=cfg.moe_experts,
            moe_capacity_factor=cfg.moe_capacity_factor, generator=generator)
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
    if cfg.kind == "deepgaitv2":
        return DG.DeepGaitV2Branch(
            cfg.in_channels, channels=cfg.stage_channels,
            blocks=cfg.stage_blocks, hpp_bins=cfg.hpp_bins,
            part_dim=cfg.part_dim, dtype=dtype, generator=generator)
    raise ValueError(f"unknown branch kind: {cfg.kind}")


def branch_input(bcfg: BranchConfig, volume: torch.Tensor) -> torch.Tensor:
    """Per-branch input adaptation: the 2D branch reads the (B, T*C, H, W)
    plane stack, the others the (B, T, H, W, C) volume."""
    if bcfg.kind == "conv2d":
        return frames_to_planes(volume)
    return volume


def _check_supported(cfg: ModelConfig, mesh) -> None:
    for b in cfg.branches:
        if b.kind not in BRANCH_KINDS:
            raise ValueError(f"unknown branch kind: {b.kind}")
    if any(b.kind == "deepgaitv2" for b in cfg.branches) and (
            cfg.multimodal or cfg.extra_dense or cfg.aux_losses):
        raise ValueError("a deepgaitv2 branch is a model of its own: one "
                         "branch, its BNNeck id head, no extra_dense or aux "
                         "heads")
    if cfg.remat:
        DG.refuse(cfg, "remat")
    if not cfg.seq_axis:
        return
    DG.refuse(cfg, "sequence parallelism")
    for b in cfg.branches:
        if b.kind != "gaitset":
            # conv2d reads the T*C plane stack densely and conv3d convolves
            # across time: on a slice of the frames either would silently
            # compute on a fraction of the clip
            raise ValueError(
                f"sequence parallelism requires gaitset branches (set-pool "
                f"frame separability); branch kind {b.kind!r} is not")
    if mesh is None or cfg.seq_axis not in mesh.axis_names:
        raise ValueError(f"seq_axis {cfg.seq_axis!r} needs a mesh with that "
                         "axis (parallel/sequence.py:make_mesh_dpsp)")


def branch_width(b: BranchConfig) -> int:
    """Width of a branch's per-sample flattened embedding."""
    if b.kind in ("gaitset", "deepgaitv2"):
        return b.num_parts * b.part_dim
    return b.ndense_units


def tp_strips(cfg: ModelConfig, tp) -> FrozenSet[str]:
    """The head's outputs that hold this model rank's strip of parts (dim
    1) under tensor parallelism ``tp`` (none without it, or where the part
    projection is whole or a branch flattens its parts)."""
    if tp is None or not tp.parts_split or any(
            b.kind == "gaitset" and b.flatten_output for b in cfg.branches):
        return frozenset()
    keys = {"branches", "fused"}
    if not (cfg.extra_dense and cfg.postriplet == 2):
        keys.add("signature")
    if not cfg.extra_dense:
        keys.add("flatten")
    return frozenset(keys)


def _id_logits(layer: Dense, x: torch.Tensor, x_strip: bool, tp
               ) -> torch.Tensor:
    """``layer(x)``; under tensor parallelism with the layer's input rows
    split (``tp_cols``), this rank's partial product summed over the model
    group.  ``x_strip``: x holds this rank's strip, the rows it needs."""
    cols = getattr(layer, "tp_cols", None)
    if tp is None or cols is None:
        if x_strip:
            x = gather_parts(x, tp.group)
        return layer(x)
    if not x_strip:
        x = copy_in(x, tp.group)[:, cols[0]:cols[1]]
    dt = layer.dtype
    return reduce_out(TF.linear(x.to(dt), layer.weight.to(dt)),
                      tp.group) + layer.bias.to(dt)


def _head_forward(cfg: ModelConfig, embeddings: Sequence[torch.Tensor],
                  use_flags: Sequence[torch.Tensor], net: nn.Module,
                  train: bool = False, key=None, group=None
                  ) -> Dict[str, object]:
    """Everything after the branches: gating, merge, signature, the extra
    dense head, the id head and the aux heads, with ``net``'s layers.
    ``key`` keys the dropcode mask in train mode; ``group`` spans the
    signature's batch-axis L2 over the data ranks."""
    tp = getattr(net, "tp", None)
    strips = tp_strips(cfg, tp)

    def whole(x):
        """A strip joined over the model group (the whole tensor as is)."""
        return gather_parts(x, tp.group) if strips else x

    batch = embeddings[0].shape[0]
    gated = []
    for e, u, bcfg in zip(embeddings, use_flags, cfg.branches):
        if bcfg.kind == "gaitset" and bcfg.flatten_output:
            # the BothDatasets variant: per-sample flatten + L2
            if tp is not None and tp.parts_split:
                e = gather_parts(e, tp.group)
            e = F.l2_normalize(e.reshape(batch, -1), dim=-1)
        if cfg.norm_before_merge:
            e = F.l2_normalize(e, dim=-1)
        gated.append(F.gate(e, u))

    if cfg.multimodal:
        fused = F.MERGES[cfg.merge](gated)
        sig = F.signature(fused, l2_mode=cfg.l2_mode, group=group)
    else:
        # reference quirk: single-modality nets emit the raw branch output
        # as the signature with NO L2 normalization
        fused = gated[0]
        sig = fused

    out: Dict[str, object] = {"branches": gated, "fused": fused}
    head_in = sig
    if cfg.extra_dense:
        act = _act(cfg.branches[0].activation, cfg.branches[0].leaky_alpha)
        if cfg.postriplet == 2:
            # the Dense before the triplet tap: its per-row L2 is "code"
            # and the signature
            x = act(net.extra_dense(whole(fused)))
            sig = F.l2_normalize(x, dim=-1)
            out["code"] = sig
        else:
            x = act(net.extra_dense(whole(sig)))
            out["code"] = x
        head_in = x
        if train and cfg.dropout_code > 0.0:
            head_in = keyed_dropout(x, cfg.dropout_code, net.dropcode_seed,
                                    key)

    out["signature"] = sig
    # the reference's Flatten (the typecode-3 tap) sits on the dropcode
    # output when extra_dense is set, not on the signature
    flat = head_in.reshape(batch, -1)
    out["flatten"] = flat

    if net.bnneck is not None:
        out["bnneck"], logits = net.bnneck(sig, train, key)
        out["classprob_logits"] = logits                  # (B, P, classes)
        out["classprob"] = torch.softmax(logits, dim=-1)
    elif net.classprob is not None:
        logits = _id_logits(net.classprob, flat, "flatten" in strips,
                            tp).to(torch.float32)
        out["classprob_logits"] = logits
        out["classprob"] = torch.softmax(logits, dim=-1)
        if cfg.aux_losses:
            out["aux_logits"] = [
                getattr(net, f"classprob_{b.modality}")(
                    whole(g).reshape(batch, -1)).to(torch.float32)
                for g, b in zip(gated, cfg.branches)]
    return out


class UGaitNet(nn.Module):
    """Branch ``i`` reads ``volumes[i]`` (B, T, H, W, C_i); parameters are
    made from ``seed`` on the CPU and moved to ``device`` (CUDA unless the
    caller passes ``device="cpu"``).  Head layers: ``extra_dense``,
    ``classprob`` and one ``classprob_<modality>`` per branch, named as
    the JAX module's param subtrees."""

    def __init__(self, config: ModelConfig, device: DeviceLike = None,
                 seed: int = 0, mesh=None):
        super().__init__()
        _check_supported(config, mesh)
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        dt = compute_dtype(config)
        self.branches = nn.ModuleDict()
        for b in config.branches:
            self.branches[f"branch_{b.modality}"] = make_branch(b, dt, gen)
            if config.seq_axis:
                self.branches[f"branch_{b.modality}"].seq_group = \
                    mesh.group(config.seq_axis)
        self.extra_dense = None
        flat_dim = config.signature_dim
        if config.extra_dense:
            width = config.extra_dense[0]
            self.extra_dense = Dense(config.signature_dim, width, dt, gen)
            self.dropcode_seed = draw_seed(gen)
            flat_dim = width
        self.classprob = self.bnneck = None
        self.tp = None
        if config.bnneck_scale > 0:
            self.bnneck = DG.BNNeck(config.signature_parts, flat_dim,
                                    config.nclasses, config.bnneck_scale, dt,
                                    gen)
        elif config.nclasses > 0:
            self.classprob = Dense(config.signature_parts * flat_dim,
                                   config.nclasses, dt, gen)
            if config.aux_losses:
                for b in config.branches:
                    setattr(self, f"classprob_{b.modality}",
                            Dense(branch_width(b), config.nclasses, dt, gen))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, volumes: Sequence[torch.Tensor],
                use_flags: Optional[Sequence[torch.Tensor]] = None,
                train: Optional[bool] = None, key=None, group=None
                ) -> Dict[str, object]:
        """use_flags[i]: (B,) presence flags (None => all present).
        train: dropout on (the JAX module's ``train``); None follows the
        module's training mode.  key: the dropout masks' key (the JAX
        module's dropout rng; an int or a ``ShardKey``), needed where a
        train-mode layer drops.  group: the data ranks of the global
        data-parallel form (None: this batch is the whole batch).

        With ``config.remat`` each branch runs under
        ``torch.utils.checkpoint`` when gradients are taken: its
        activations are recomputed in the backward instead of held.  Every
        dropout mask is drawn from a generator of (layer seed, key), never
        from the global RNG, so the recompute draws the same masks without
        ``preserve_rng_state``."""
        cfg = self.config
        if train is None:
            train = self.training
        batch = volumes[0].shape[0]
        if use_flags is None:
            use_flags = [torch.ones((batch,), dtype=torch.float32,
                                    device=volumes[0].device)
                         for _ in cfg.branches]
        remat = cfg.remat and train and torch.is_grad_enabled()
        embeddings: List[torch.Tensor] = []
        moe_aux = []
        for i, b in enumerate(cfg.branches):
            branch = self.branches[f"branch_{b.modality}"]
            args = (branch_input(b, volumes[i]), train, key)
            if b.kind == "gaitset":
                args += (group,)
            if remat:
                emb = checkpoint(branch, *args, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                emb = branch(*args)
            if b.moe_experts > 0:
                emb, aux = emb
                moe_aux.append(aux)
            embeddings.append(emb)
        out = _head_forward(cfg, embeddings, use_flags, self, train, key,
                            group)
        if moe_aux:
            out["moe_aux"] = sum(moe_aux)
        return out


class UGaitHead(nn.Module):
    """The post-branch stage over branch embeddings (pipeline parallelism,
    ``parallel/pipeline.py``): ``_head_forward`` with ``net``'s head layers,
    shared, under the same names, so one state_dict serves both and a step
    through the head trains the net's layers.  ``forward(embeddings,
    use_flags, train, key, group)`` gives the net's outputs on the same
    embeddings, dropcode masks included."""

    def __init__(self, net: UGaitNet):
        super().__init__()
        self.config = net.config
        self.extra_dense = net.extra_dense
        if net.extra_dense is not None:
            self.dropcode_seed = net.dropcode_seed
        self.classprob = net.classprob
        self.bnneck = net.bnneck
        if net.classprob is not None and net.config.aux_losses:
            for b in net.config.branches:
                name = f"classprob_{b.modality}"
                setattr(self, name, getattr(net, name))
        self.tp = None

    def forward(self, embeddings: Sequence[torch.Tensor],
                use_flags: Sequence[torch.Tensor],
                train: Optional[bool] = None, key=None, group=None
                ) -> Dict[str, object]:
        if train is None:
            train = self.training
        return _head_forward(self.config, embeddings, use_flags, self,
                             train, key, group)
