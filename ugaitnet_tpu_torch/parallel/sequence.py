"""Sequence parallelism: the gait set (time) axis split over ranks.

Port of ``ugaitnet_tpu/parallel/sequence.py``.  A (dp x sp) ("data",
"seq") mesh: data rank d holds rows d of the global batch, and seq rank s
of it frames [s T/sp, (s + 1) T/sp) of every clip.  The GaitSet trunk is
frame separable (every cross-frame interaction is a set max, and a global
max over T is the max of each rank's local max), so each rank convolves
its frames and the three set pools close over the seq group with a small
differentiable gather (``models/gaitset.py:_group_max``, after the stage
tail's local set max at stages 1 and 2); everything after the pools runs
on every seq rank alike.

The step is the per-shard form of ``parallel/sharding.py`` on the data
axis: the signature normalizes over the local batch, dropout keys fold the
data index only (the frames of one sample live on every seq rank, which
must draw the same masks), and the gradients are averaged over both axes.

T need not divide sp: ``pad_frames`` repeats the last frame, exact for a
max-pooled set (a duplicated element never changes a max).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ugaitnet_tpu_torch.parallel.sharding import (
    DATA_AXIS, Mesh, build_mesh, make_shardmap_train_step, shard_batch)

SEQ_AXIS = "seq"


def make_mesh_dpsp(dp: int, sp: int, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """(dp x sp) ("data", "seq") mesh over the process group's ranks."""
    return build_mesh([(DATA_AXIS, dp), (SEQ_AXIS, sp)], devices)


def sp_model_config(mcfg):
    """The model config of a sequence-parallel run: the set pools close
    over the seq axis.  Raises for a branch that is not GaitSet."""
    for b in mcfg.branches:
        if b.kind != "gaitset":
            raise ValueError(
                "sequence parallelism requires gaitset branches (set-pool "
                f"frame separability); branch kind {b.kind!r} is not")
    return dataclasses.replace(mcfg, seq_axis=SEQ_AXIS)


def pad_frames(volume: torch.Tensor, sp: int) -> torch.Tensor:
    """Pad (B, T, H, W, C) to T divisible by sp by repeating the last
    frame (exact under set-max pooling, not for a mean-pooled set)."""
    pad = (-volume.shape[1]) % sp
    if pad == 0:
        return volume
    return torch.cat([volume, volume[:, -1:].expand(
        -1, pad, *volume.shape[2:])], dim=1)


def shard_batch_sp(batch, mesh: Mesh):
    """This rank's part of a global ``Batch``: its data rows, and of the
    volumes, padded to a multiple of sp frames, its seq slice."""
    rows = shard_batch(batch, mesh)
    sp, s = mesh.size(SEQ_AXIS), mesh.index(SEQ_AXIS)

    def frames(v):
        v = pad_frames(v, sp)
        t = v.shape[1] // sp
        return v[:, s * t:(s + 1) * t]
    return type(batch)(volumes=tuple(frames(v) for v in rows.volumes),
                       use_flags=rows.use_flags, labels=rows.labels)


def make_sp_train_step(mcfg, tcfg, mesh: Mesh):
    """step(state, batch from ``shard_batch_sp``) -> (state, metrics): the
    per-shard data-parallel step over the ("data", "seq") mesh.  The
    state's model is built with ``sp_model_config(mcfg)`` and the mesh."""
    sp_model_config(mcfg)
    return make_shardmap_train_step(mcfg, tcfg, mesh)
