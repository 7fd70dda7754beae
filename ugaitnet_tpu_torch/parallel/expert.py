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
(``full_snapshot`` gathers them; ``load_full`` takes this rank's slice), so
it resumes at any world size.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ugaitnet_tpu_torch.ops.collectives import gather_rows_nograd
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


def _sharded(model):
    """(parameter name, branch) of every expert_proj split over ranks."""
    return [(f"branches.{name}.expert_proj", br)
            for name, br in model.branches.items()
            if getattr(br, "expert_group", None) is not None]


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
        br.expert_proj = shard
        br.expert_group, br.expert_start = mesh.group(EXPERT_AXIS), j * n
    return model


def make_ep_train_step(mcfg, tcfg, mesh: Mesh):
    """step(state, batch from ``shard_batch``) -> (state, metrics) over the
    ("data", "expert") mesh; the state's model went through
    ``place_ep_model``."""
    _require_moe(mcfg)
    return make_sharded_train_step(mcfg, tcfg, mesh)


def _param_index(model) -> Dict[str, int]:
    return {name: i for i, (name, _) in enumerate(model.named_parameters())}


def full_snapshot(state, mesh: Mesh) -> Dict:
    """{"step", "model", "optimizer"} on the CPU with every expert shard
    and its moments gathered whole (every rank of the mesh calls it)."""
    from ugaitnet_tpu_torch.core.checkpoint import snapshot
    snap = snapshot(state)
    group = mesh.group(EXPERT_AXIS)
    index = _param_index(state.model)
    opt_state = state.optimizer.state_dict()["state"]
    for name, br in _sharded(state.model):
        snap["model"][name] = gather_rows_nograd(
            br.expert_proj.detach(), group).cpu()
        for k, v in opt_state.get(index[name], {}).items():
            if torch.is_tensor(v) and v.shape == br.expert_proj.shape:
                snap["optimizer"]["state"][index[name]][k] = \
                    gather_rows_nograd(v, group).cpu()
    return snap


def load_full(state, raw: Dict) -> None:
    """Load a whole checkpoint payload into an expert-placed state, each
    expert shard and its moments sliced to this rank's experts."""
    index = _param_index(state.model)
    model_sd = dict(raw["model"])
    opt_sd = raw.get("optimizer")
    for name, br in _sharded(state.model):
        n, start = br.expert_proj.shape[0], br.expert_start
        model_sd[name] = model_sd[name][start:start + n]
        if opt_sd is not None:
            for k, v in opt_sd["state"].get(index[name], {}).items():
                if torch.is_tensor(v) and v.ndim == 3:
                    opt_sd["state"][index[name]][k] = v[start:start + n]
    state.model.load_state_dict(model_sd)
    if opt_sd is not None:
        state.optimizer.load_state_dict(opt_sd)
    state.step = int(raw.get("step", state.step))
