"""Pipeline (branch-placement) parallelism: one device per modality branch.

Port of ``ugaitnet_tpu/parallel/pipeline.py``.  The per-modality branch
trunks are independent subgraphs (most of the step's work) joined only at
the small gating / merge / head stage, so the split is branch placement:
branch i's forward runs on device i, the head stage and the optimizer on
device 0, and only the (B, P, D) embeddings and their cotangents move
between devices.  One process drives every device, as the JAX step does.

Schedule per step:
  1. branch i's parameters (the masters live on device 0 with the
     optimizer) are copied to its device, which runs the branch forward;
  2. the embeddings move to device 0, where the head's loss, its gradients
     and d(embeddings) are taken (the explicit L2 terms of all parameters
     too, so the branch kernels' regularizer gradients come from here);
  3. each d(embedding) goes back to its branch's device for the branch
     backward;
  4. the branch gradients move to device 0 and add to the regularizer's
     (``add_branch_grads``), and one optimizer step runs there.

The branch backward runs on the autograd graph of step 1's forward; the
JAX step recomputes that forward instead (its rematerialized transpose).
The numerics are the same.  Devices may repeat, so one card can drive it;
a branch whose slot is the head's (i % n == 0) trains its masters
directly.  The triplet kernel
runs on device 0, once forward and once backward per step.

The head is ``models/network.py:UGaitHead``, sharing the net's head layers
and dropout seed; its dropcode masks are the one-process step's.  As in
JAX, branches with internal dropout (conv2d with dropout > 0) and MoE
branches are refused.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ugaitnet_tpu_torch.models import deepgaitv2 as DG
from ugaitnet_tpu_torch.models.network import UGaitHead, branch_input


def _branch_keys(mcfg) -> List[str]:
    return [f"branch_{b.modality}" for b in mcfg.branches]


def split_params(params: Mapping[str, torch.Tensor], mcfg
                 ) -> Tuple[List[Dict[str, torch.Tensor]],
                            Dict[str, torch.Tensor]]:
    """(branch views, head view) of a UGaitNet state_dict or named
    parameters: the entries of branch i keyed within the branch, and every
    other entry under its own name.  Disjoint, and together complete, so
    one checkpoint serves both modes."""
    branches = []
    taken = set()
    for key in _branch_keys(mcfg):
        prefix = f"branches.{key}."
        view = {k[len(prefix):]: v for k, v in params.items()
                if k.startswith(prefix)}
        taken.update(prefix + k for k in view)
        branches.append(view)
    head = {k: v for k, v in params.items() if k not in taken}
    return branches, head


def add_branch_grads(params, grads, device: torch.device) -> None:
    """Step 4: a branch's gradients, moved to the head device, added to
    what its masters hold from the head stage (the regularizer's part)."""
    for p, g in zip(params, grads):
        if g is None:
            continue
        g = g.to(device)
        p.grad = g if p.grad is None else p.grad + g


def _check_supported(mcfg, devices) -> None:
    DG.refuse(mcfg, "pipeline parallelism")
    for b in mcfg.branches:
        if b.kind == "conv2d" and b.dropout > 0:
            raise ValueError(
                "pipeline parallelism does not reproduce in-branch dropout "
                "streams (the JAX package folds its rngs per module path); "
                "set the conv2d branch dropout to 0 or train another way")
        if b.moe_experts > 0:
            raise ValueError(
                "pipeline parallelism does not collect the MoE "
                "load-balance aux loss from the trunk stages; train MoE "
                "models with the mesh steps (dp / parallel/expert.py)")
    if len(devices) < 2:
        raise ValueError("pipeline parallelism needs >= 2 devices")


def make_pipeline_train_step(model, optimizer, mcfg, tcfg,
                             devices: Optional[Sequence] = None):
    """step(state, batch) -> (state, metrics), the contract of
    ``make_train_step``, for the state that holds ``model`` and
    ``optimizer`` (on devices[0], the head device); branch i computes on
    devices[i % len(devices)].  ``devices`` default: the cards 0 and 1."""
    from ugaitnet_tpu_torch.train.train_step import losses_from_outputs
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else ("cuda:0", "cuda:1"))]
    _check_supported(mcfg, devs)
    head_dev = devs[0]
    if model.device != head_dev:
        raise ValueError(f"the model lives on {model.device}; the pipeline "
                         f"keeps it on the head device {head_dev}")
    bkeys = _branch_keys(mcfg)
    branch_dev = [devs[i % len(devs)] for i in range(len(bkeys))]
    # a branch placed on another device slot than the head's trains a copy
    # there (also where the slot names the head's device), refreshed from
    # the masters every step; one in the head's slot trains its masters
    replicas = [None if i % len(devs) == 0 else
                copy.deepcopy(model.branches[k]).to(dev)
                for i, (k, dev) in enumerate(zip(bkeys, branch_dev))]
    head = UGaitHead(model)

    def step(state, batch):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state's model and optimizer are not the "
                             "ones this step was made for")
        key = state.step
        model.train()
        optimizer.zero_grad(set_to_none=True)
        # 1. the trunk forwards, each on its device
        embs = []
        for i, (k, dev) in enumerate(zip(bkeys, branch_dev)):
            branch = model.branches[k]
            if replicas[i] is not None:
                with torch.no_grad():
                    for dst, src in zip(replicas[i].parameters(),
                                        branch.parameters()):
                        dst.copy_(src)
                branch = replicas[i]
                branch.train()
            bcfg = mcfg.branches[i]
            args = (branch_input(bcfg, batch.volumes[i].to(dev)), True, key)
            if mcfg.remat:
                embs.append(checkpoint(branch, *args, use_reentrant=False,
                                       preserve_rng_state=False))
            else:
                embs.append(branch(*args))
        # 2. the head's loss and gradients on the head device
        leaves = [e.detach().to(head_dev).requires_grad_(True) for e in embs]
        flags = [f.to(head_dev) for f in batch.use_flags]
        out = head(leaves, flags, train=True, key=key)
        local = type(batch)(batch.volumes, tuple(flags),
                            batch.labels.to(head_dev))
        total, metrics = losses_from_outputs(out, model, local, mcfg, tcfg)
        total.backward()
        # 3. the trunk backwards, each on its device, and 4. their gradients
        # join the regularizer's part on the masters
        for i, (k, dev) in enumerate(zip(bkeys, branch_dev)):
            trained = replicas[i] if replicas[i] is not None \
                else model.branches[k]
            grads = torch.autograd.grad(
                embs[i], list(trained.parameters()),
                grad_outputs=leaves[i].grad.to(dev), allow_unused=True)
            add_branch_grads(model.branches[k].parameters(), grads, head_dev)
        optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
