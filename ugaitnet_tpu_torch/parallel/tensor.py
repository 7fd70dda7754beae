"""Tensor parallelism: a ("data", "model") mesh, GaitSet convs split
Megatron-style over the model axis and the 62-part head by parts.

Port of ``ugaitnet_tpu/parallel/tensor.py``.  The JAX package annotates
the parameters and lets GSPMD partition the one-device step; the port runs
one process per rank and places the collectives itself.  Each rank keeps
only its shard of every leaf that ``leaf_dim`` splits (the JAX
``_leaf_spec``, in torch's names and layouts):

  a_conv1/3/5, b_conv1/3   (co, ci, k, k)  co split: their input goes
        through ``copy_in`` (``ops/collectives.py``: identity forward,
        all-reduce backward)
  a_conv2/4/6, b_conv2/4   (co, ci, k, k)  ci split: an all-reduce over the
        model group (``reduce_out``) restores the activation before the
        pool, set pool, residual add or leaky ReLU that follows
  part_proj                (62, c3, d)     parts split: rank r projects
        parts [r 62/mp, (r + 1) 62/mp) and its branch returns that strip
  classprob.weight         (ncls, 62 d)    input rows split (the flatten is
        parts-major, so a rank's rows are its strip's); the partial logits
        close with an all-reduce
  everything else          whole on every model rank

A leaf whose split dimension mp does not divide stays whole, as under
GSPMD (at mp = 4 the 62-part projection; the classifier's 62 d rows still
split).  2D / 3D CNN branches and MoE projections have no rule and run
whole on every model rank.  A whole leaf is computed identically on every
model rank, so its gradient is the model group's already: every gradient
sums over the data ranks only (``average_gradients``).

The batch splits over "data" only: the ranks of a model column hold the
same rows.  The step is the global form of ``parallel/sharding.py`` (the
JAX TP step partitions the one-device program): the batch-axis L2 sums over
the data ranks and triplets are mined over the gathered rows, both local
to a part strip.  Each model rank runs the triplet kernel on its strip,
(P_r, B, D); its term, P_r / 62 of the mean over parts, is summed over the
model group (``train/train_step.py:triplet_term``).  The JAX step swaps in
the XLA triplet only because GSPMD cannot partition a Mosaic call.

The optimizer, made after ``place_tp_model``, holds moments of the shards.
Checkpoints hold whole tensors (``core/checkpoint.py:full_snapshot`` /
``load_full``), so one serves one process, DP and TP alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from ugaitnet_tpu_torch.core.checkpoint import ShardSpec
from ugaitnet_tpu_torch.models import deepgaitv2 as DG
from ugaitnet_tpu_torch.ops.collectives import MODEL_AXIS
from ugaitnet_tpu_torch.parallel.sharding import (DATA_AXIS, Mesh,
                                                  build_mesh,
                                                  make_sharded_train_step)

# column-parallel convs (output channels split) and the row-parallel convs
# (input channels split) that follow each of them, pair by pair
_CO_SHARDED = ("a_conv1", "a_conv3", "a_conv5", "b_conv1", "b_conv3")
_CI_SHARDED = ("a_conv2", "a_conv4", "a_conv6", "b_conv2", "b_conv4")


@dataclasses.dataclass(frozen=True)
class TPInfo:
    """A tensor-parallel net's model group, and whether the GaitSet part
    projections are split by parts (the branches then return strips)."""
    group: Any
    parts_split: bool


def make_mesh2d(dp: int, mp: int, devices: Optional[Sequence] = None
                ) -> Mesh:
    """(dp x mp) ("data", "model") mesh over the process group's ranks,
    row-major: rank r sits at (r // mp, r % mp)."""
    return build_mesh([(DATA_AXIS, dp), (MODEL_AXIS, mp)], devices)


def leaf_dim(name: str, shape, mp: int) -> Optional[int]:
    """The dimension of state_dict entry ``name`` that the model axis
    splits, or None (whole).  Keyed on the trailing (module, leaf) names,
    as the JAX ``_leaf_spec``; a dimension is split only where mp divides
    it."""
    keys = name.split(".")
    leaf = keys[-1]
    parent = keys[-2] if len(keys) > 1 else ""
    nd = len(shape)

    def ok(dim):
        return shape[dim] % mp == 0

    if leaf == "part_proj" and nd == 3 and ok(0):
        return 0
    if leaf == "weight" and nd == 4:
        if parent in _CO_SHARDED and ok(0):
            return 0
        if parent in _CI_SHARDED and ok(1):
            return 1
    if name == "classprob.weight" and nd == 2 and ok(1):
        return 1
    return None


def place_tp_model(model, mesh: Mesh):
    """Keep this rank's shard of every split leaf, in place (before the
    optimizer is made), and wire the branches and the head to the model
    group."""
    DG.refuse(model.config, "tensor parallelism")
    mp, j = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    group = mesh.group(MODEL_AXIS)
    ranges = {}
    for name, p in list(model.named_parameters()):
        dim = leaf_dim(name, tuple(p.shape), mp)
        if dim is None:
            continue
        n = p.shape[dim] // mp
        owner, attr = name.rsplit(".", 1)
        shard = torch.nn.Parameter(p.detach().narrow(dim, j * n, n).clone())
        shard.shard_spec = ShardSpec(group, dim, j * n)
        setattr(model.get_submodule(owner), attr, shard)
        ranges[name] = (j * n, (j + 1) * n)
    split_parts = []
    for bname, br in model.branches.items():
        if not hasattr(br, "tp_split"):
            continue                    # 2D / 3D CNN: whole
        br.model_group = group
        br.tp_split = tuple(c for c in _CO_SHARDED + _CI_SHARDED
                            if f"branches.{bname}.{c}.weight" in ranges)
        for co, ci in zip(_CO_SHARDED, _CI_SHARDED):
            if (co in br.tp_split) != (ci in br.tp_split):
                raise AssertionError(f"{bname}: {co} and {ci} split apart")
        br.part_range = ranges.get(f"branches.{bname}.part_proj")
        if br.moe_experts == 0:
            split_parts.append(br.part_range is not None)
    if model.classprob is not None:
        model.classprob.tp_cols = ranges.get("classprob.weight")
    model.tp = TPInfo(group, bool(split_parts) and all(split_parts))
    return model


def make_tp_train_step(mcfg, tcfg, mesh: Mesh):
    """step(state, batch from ``shard_batch``) -> (state, metrics) over the
    ("data", "model") mesh; the state's model went through
    ``place_tp_model``."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError("tensor parallelism needs a mesh with a 'model' "
                         "axis (make_mesh2d)")
    return make_sharded_train_step(mcfg, tcfg, mesh)

