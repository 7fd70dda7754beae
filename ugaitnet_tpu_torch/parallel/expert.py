"""Expert parallelism: the MoE expert axis sharded over a ("data",
"expert") mesh.

Port of ``ugaitnet_tpu/parallel/expert.py``.  Each MoE branch's

  expert_proj  (E, C, D)   split on E over the "expert" axis when ep
                           divides E, whole on every rank otherwise
  router       (C, E)      replicated (every rank routes the same tokens)

Data rank d holds rows d of the global batch, the same on every rank of
its expert group.  Each rank computes only its experts' slots, and the
combine is an all-reduce-sum over the expert group
(``ops/moe.py:moe_project``): the simplest exchange that equals the JAX
package's GSPMD result, with no ``all_to_all``.  The step is the global
form of ``parallel/sharding.py`` (the JAX EP step partitions one traced
single-device program), so routing spans the global batch at dp > 1.

The optimizer, made after ``place_ep_model``, holds moments of the shard
only.  A checkpoint holds the whole ``expert_proj`` and its moments
(``core/checkpoint.py:full_snapshot`` gathers them; ``load_full`` takes
this rank's slice), so it resumes at any world size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ugaitnet_tpu_torch.core.checkpoint import ShardSpec
from ugaitnet_tpu_torch.parallel.sharding import (DATA_AXIS, Mesh,
                                                  build_mesh,
                                                  make_sharded_train_step)

EXPERT_AXIS = "expert"


def make_mesh_dpep(dp: int, ep: int, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """(dp x ep) ("data", "expert") mesh over the process group's ranks."""
    return build_mesh([(DATA_AXIS, dp), (EXPERT_AXIS, ep)], devices)


def _require_moe(mcfg) -> None:
    if not mcfg.has_moe:
        raise ValueError(
            "expert parallelism requires a branch with moe_experts > 0 "
            "(BranchConfig.moe_experts) — there is no expert axis to shard")


def place_ep_model(model, mesh: Mesh):
    """Keep this rank's experts of every MoE branch whose expert count the
    expert axis divides, in place (before the optimizer is made)."""
    _require_moe(model.config)
    ep, j = mesh.size(EXPERT_AXIS), mesh.index(EXPERT_AXIS)
    for br in model.branches.values():
        e = getattr(br, "moe_experts", 0)
        if e == 0 or e % ep != 0:
            continue
        n = e // ep
        shard = torch.nn.Parameter(br.expert_proj.detach()[j * n:(j + 1) * n]
                                   .clone())
        shard.expert_shard = True
        shard.shard_spec = ShardSpec(mesh.group(EXPERT_AXIS), 0, j * n)
        br.expert_proj = shard
        br.expert_group, br.expert_start = mesh.group(EXPERT_AXIS), j * n
    return model


def make_ep_train_step(mcfg, tcfg, mesh: Mesh):
    """step(state, batch from ``shard_batch``) -> (state, metrics) over the
    ("data", "expert") mesh; the state's model went through
    ``place_ep_model``."""
    _require_moe(mcfg)
    return make_sharded_train_step(mcfg, tcfg, mesh)
