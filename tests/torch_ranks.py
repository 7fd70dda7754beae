"""Rank workers of the port's multi-device tests (tests/test_torch_*.py).

The tests start these with ``parallel.sharding.spawn`` as gloo CPU ranks.
This module imports torch and the port only, never JAX: each spawned rank
imports it fresh.  Inputs and results go through files (``torch.save`` of
numpy trees), one per rank or rank 0's.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import collectives as C
from ugaitnet_tpu_torch.parallel import sharding as S
from ugaitnet_tpu_torch.train.train_step import Batch, init_state
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)


def load(path):
    return torch.load(path, weights_only=False)


def save(path, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def batch_of(arrays) -> Batch:
    """A Batch of torch tensors from {"volumes", "flags", "labels"}."""
    return Batch(tuple(torch.from_numpy(np.ascontiguousarray(v))
                       for v in arrays["volumes"]),
                 tuple(torch.from_numpy(np.ascontiguousarray(f))
                       for f in arrays["flags"]),
                 torch.from_numpy(np.ascontiguousarray(arrays["labels"])))


def probe_state(mcfg, params=None, mesh=None, seed=0, ep_mesh=None):
    """A state whose optimizer keeps the parameters (SGD at lr 0), so a
    step leaves its averaged gradient in .grad; weights from a flax tree."""
    model = UGaitNet(mcfg, device="cpu", seed=seed, mesh=mesh)
    if params is not None:
        model.load_state_dict(flax_to_state_dict(params))
    if ep_mesh is not None:
        from ugaitnet_tpu_torch.parallel.expert import place_ep_model
        place_ep_model(model, ep_mesh)
    return init_state(model, tconfig.TrainConfig(optimizer="sgd", lr=0.0))


def grads_flax(state, full_experts=None):
    """The gradient as a flax tree of numpy arrays; with ``full_experts``
    (a mesh), expert shards are gathered whole."""
    sd = {}
    for name, p in state.model.named_parameters():
        g = p.grad.detach()
        if full_experts is not None and getattr(p, "expert_shard", False):
            g = C.gather_rows_nograd(g, full_experts.group("expert"))
        sd[name] = g
    return state_dict_to_flax(sd)


def metrics_of(m):
    return {k: float(v.detach()) for k, v in m.items()}


# ---------------------------------------------------------------- faults

FAULTS = ("gather without autograd", "local L2 in the global form",
          "no world factor")


@contextlib.contextmanager
def planted(name):
    """One of FAULTS planted in this rank's modules."""
    from ugaitnet_tpu_torch.ops import fusion
    from ugaitnet_tpu_torch.train import train_step as TS

    def own_rows_only(x, group):
        full = C.gather_rows_nograd(x.detach(), group)
        i, b = dist.get_rank(group), x.shape[0]
        return torch.cat([full[:i * b], x, full[(i + 1) * b:]])
    sig, avg = fusion.signature, TS.average_gradients

    def summed(model, mesh):
        avg(model, mesh)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(mesh.world)
    mod, attr, fn = {
        "gather without autograd": (TS, "all_gather_rows", own_rows_only),
        "local L2 in the global form": (
            fusion, "signature",
            lambda fused, l2_mode="reference", group=None:
            sig(fused, l2_mode)),
        "no world factor": (TS, "average_gradients", summed),
    }[name]
    old = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, old)


# ------------------------------------------------------------------ ranks

def form_steps(rank, work, n, variants):
    """One data-parallel step per (name, mcfg, form) of ``variants`` from
    the params in work/params.pt on the global batch work/batch.pt; rank
    0 saves {name: (metrics, grads)} to work/out.pt."""
    inp = load(os.path.join(work, "in.pt"))
    mesh = S.make_mesh(n)
    local = S.shard_batch(batch_of(inp["batch"]), mesh)
    out = {}
    for name, mcfg, form in variants:
        make = (S.make_sharded_train_step if form == "global"
                else S.make_shardmap_train_step)
        st = probe_state(mcfg, inp["params"])
        _, m = make(mcfg, tconfig.TrainConfig(**inp["tcfg"]), mesh)(st,
                                                                   local)
        out[name] = (metrics_of(m), grads_flax(st))
    if rank == 0:
        save(os.path.join(work, "out.pt"), out)


def augmented_batch(seed, expand, dcfg):
    """A raw batch made from a numpy seed, preprocessed with augmentation
    and expand-level modality dropout by a seeded generator: the same
    global batch on every rank."""
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    rng = np.random.RandomState(seed)
    b = 4
    raw = {"raw_of": torch.from_numpy(
               rng.randint(-3000, 3000, (b, 50, 60, 60)).astype(np.int16)),
           "raw_gray": torch.from_numpy(
               rng.randint(0, 255, (b, 25, 60, 60)).astype(np.uint8)),
           "present_of": torch.ones(b), "present_gray": torch.ones(b),
           "labels": torch.from_numpy(np.repeat(np.arange(2), 2)
                                      .astype(np.int32))}
    vols, flags, labels = preprocess_batch(
        raw, ("of", "gray"), (2, 1), (100.0, 1.0), 2, expand, True, dcfg,
        generator=torch.Generator().manual_seed(seed), device="cpu")
    return Batch(tuple(vols), tuple(flags), labels)


def own_batch_steps(rank, work, n, mcfg, faults):
    """Every rank makes the augmented global batch itself, takes its rows,
    and runs the global form with dropcode on: the correct step, then
    each planted fault of ``faults``.  Rank 0 saves {name: (metrics,
    grads, flatten)}, where flatten is every rank's dropcode output
    gathered (its zeros are the mask)."""
    mesh = S.make_mesh(n)
    batch = augmented_batch(3, 3, tconfig.DataConfig())
    local = S.shard_batch(batch, mesh)
    step = S.make_sharded_train_step(mcfg, tconfig.TrainConfig(), mesh)
    out = {}
    for name in ("correct",) + tuple(faults):
        st = probe_state(mcfg)
        taps = []
        hook = st.model.register_forward_hook(
            lambda mod, args, kw_out: taps.append(kw_out["flatten"]))
        with planted(name) if name != "correct" else \
                contextlib.nullcontext():
            _, m = step(st, local)
        hook.remove()
        flat = C.gather_rows_nograd(taps[0].detach(), mesh.group("data"))
        out[name] = (metrics_of(m), grads_flax(st), flat.numpy())
    if rank == 0:
        save(os.path.join(work, "out.pt"), out)


def sp_steps(rank, work, dp, sp):
    """The sequence-parallel step on a (dp, sp) mesh; rank 0 saves
    (metrics, grads)."""
    from ugaitnet_tpu_torch.parallel.sequence import (make_mesh_dpsp,
                                                       make_sp_train_step,
                                                       shard_batch_sp,
                                                       sp_model_config)
    inp = load(os.path.join(work, "in.pt"))
    mesh = make_mesh_dpsp(dp, sp)
    mcfg = inp["mcfg"]
    st = probe_state(sp_model_config(mcfg), inp["params"], mesh=mesh)
    local = shard_batch_sp(batch_of(inp["batch"]), mesh)
    _, m = make_sp_train_step(mcfg, tconfig.TrainConfig(**inp["tcfg"]),
                              mesh)(st, local)
    if rank == 0:
        save(os.path.join(work, "out.pt"),
             (metrics_of(m), grads_flax(st),
              [tuple(v.shape) for v in local.volumes]))


def ep_steps(rank, work, dp, ep):
    """The expert-parallel step on a (dp, ep) mesh; rank 0 saves (metrics,
    grads with the expert shards gathered whole)."""
    from ugaitnet_tpu_torch.parallel.expert import (make_ep_train_step,
                                                     make_mesh_dpep)
    inp = load(os.path.join(work, "in.pt"))
    mesh = make_mesh_dpep(dp, ep)
    mcfg = inp["mcfg"]
    st = probe_state(mcfg, inp["params"], ep_mesh=mesh)
    _, m = make_ep_train_step(mcfg, tconfig.TrainConfig(**inp["tcfg"]),
                              mesh)(st, S.shard_batch(batch_of(inp["batch"]),
                                                      mesh))
    shard = st.model.branches["branch_of"].expert_proj.shape[0]
    g = grads_flax(st, full_experts=mesh)
    if rank == 0:
        save(os.path.join(work, "out.pt"), (metrics_of(m), g, shard))


def collectives(rank, work):
    """Forward values and backward sums of the three collectives on 2
    ranks; each rank saves its own."""
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]]) * (rank + 1)
    x.requires_grad_(True)
    y = C.all_gather_rows(x, dist.group.WORLD)
    (y * torch.arange(8.0).reshape(4, 2)).sum().backward()
    s = torch.tensor([2.0 * (rank + 1)], requires_grad=True)
    t = C.all_reduce_sum(s, dist.group.WORLD)
    (3.0 * t).sum().backward()
    u = torch.tensor([2.0 * (rank + 1)], requires_grad=True)
    v = C.all_reduce_mean(u, dist.group.WORLD)
    (5.0 * v).sum().backward()
    mesh = S.make_mesh(2)
    rows = Batch((x.detach(),), (torch.ones(2),), torch.arange(2))
    same = S.shard_batch_multihost(rows, mesh) is rows
    try:   # rank 1 holds one row fewer
        S.shard_batch_multihost(Batch((x.detach()[:2 - rank],),
                                      (torch.ones(2 - rank),),
                                      torch.arange(2 - rank)), mesh)
        uneven = "accepted"
    except ValueError as e:
        uneven = str(e)
    save(os.path.join(work, f"coll{rank}.pt"),
         {"multihost_same": same, "multihost_uneven": uneven,
          "gather": y.detach().numpy(), "gather_grad": x.grad.numpy(),
          "sum": t.detach().numpy(), "sum_grad": s.grad.numpy(),
          "mean": v.detach().numpy(), "mean_grad": u.grad.numpy()})


def cli_with_fault(rank, argv, fault):
    """The port's train CLI as one rank of the spawned world, with one of
    FAULTS planted (the CLI trains on the process group it finds)."""
    from ugaitnet_tpu_torch.cli import train
    with planted(fault):
        train.main(argv)
