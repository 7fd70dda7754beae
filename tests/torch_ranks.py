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
from ugaitnet_tpu_torch.parallel.faults import tp_planted
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


def train_cli(rank, work, *argvs):
    """The port's train CLI run once per argv, in turn, as one rank of the
    spawned world (the CLI trains on the process group it finds); rank 0
    saves each run's (experiment dir, latest checkpoint step) to
    work/cli.pt."""
    from ugaitnet_tpu_torch.cli import train
    from ugaitnet_tpu_torch.core.checkpoint import latest_checkpoint_step
    runs = []
    for argv in argvs:
        d = train.main(list(argv))
        runs.append((d, latest_checkpoint_step(d)))
    if rank == 0:
        save(os.path.join(work, "cli.pt"), runs)


def in_turn(rank, work, *jobs):
    """Each (rank function, its further args) of ``jobs`` in turn, in the
    one world: a world costs a spawn, so several checks share it."""
    for fn, args in jobs:
        fn(rank, work, *args)


def cli_with_fault(rank, argv, fault):
    """The port's train CLI as one rank of the spawned world, with one of
    FAULTS planted (the CLI trains on the process group it finds)."""
    from ugaitnet_tpu_torch.cli import train
    with planted(fault):
        train.main(argv)


# ------------------------------------------------------- tensor parallel

def tp_state(mcfg, params, mesh, tcfg):
    """A state from a flax tree, its shards placed on ``mesh`` before the
    optimizer is made."""
    from ugaitnet_tpu_torch.parallel.tensor import place_tp_model
    model = UGaitNet(mcfg, device="cpu", seed=0)
    if params is not None:
        model.load_state_dict(flax_to_state_dict(params))
    place_tp_model(model, mesh)
    return init_state(model, tcfg)


def whole_grads(state):
    """Every gradient joined whole, as a flax tree."""
    sd = {}
    for name, p in state.model.named_parameters():
        spec = getattr(p, "shard_spec", None)
        g = p.grad.detach()
        sd[name] = g if spec is None else \
            C.gather_along(g, spec.group, spec.dim)
    return state_dict_to_flax(sd)


def tp_steps(rank, work, cases, faults=()):
    """One step of the TP form per (name, dp, mp, mcfg) of ``cases``, from
    the flax params work/in.pt["params"][name] on the global batch
    work/in.pt["batch"], with the optimizer of in.pt["tcfg"]; then, for
    the first case, each of ``faults`` planted.  Rank 0 saves {name:
    (metrics, whole gradient, whole params after the step, {param: shard
    shape}, {param: moment shapes})} to work/out.pt."""
    from ugaitnet_tpu_torch.core.checkpoint import full_snapshot
    from ugaitnet_tpu_torch.parallel.tensor import (make_mesh2d,
                                                     make_tp_train_step)
    inp = load(os.path.join(work, "in.pt"))
    tcfg = tconfig.TrainConfig(**inp["tcfg"])
    batch = batch_of(inp["batch"])
    out = {}
    runs = [(name, dp, mp, mcfg, None) for name, dp, mp, mcfg in cases]
    runs += [(f, *cases[0][1:], f) for f in faults]
    for name, dp, mp, mcfg, fault in runs:
        mesh = make_mesh2d(dp, mp)
        key = cases[0][0] if fault else name
        st = tp_state(mcfg, inp["params"][key], mesh, tcfg)
        with tp_planted(fault) if fault else contextlib.nullcontext():
            _, m = make_tp_train_step(mcfg, tcfg, mesh)(
                st, S.shard_batch(batch, mesh))
        shapes = {n: tuple(p.shape) for n, p in st.model.named_parameters()}
        moments = {n: [tuple(v.shape) for v in st.optimizer.state[p].values()
                       if torch.is_tensor(v) and v.ndim]
                   for n, p in st.model.named_parameters()}
        snap = full_snapshot(st)
        out[name] = (metrics_of(m), whole_grads(st),
                     state_dict_to_flax(snap["model"]), shapes, moments)
    if rank == 0:
        save(os.path.join(work, "out.pt"), out)


def tp_resume(rank, work, mcfg, dp, mp):
    """Two Adam steps of the TP form on the global batch of work/in.pt,
    uninterrupted, with a whole checkpoint published after the first
    (rank 0, under work/ckpt); then a fresh TP state that loads it and
    takes the second step.  Rank 0 saves (whole params uninterrupted,
    whole params resumed) to work/resume.pt."""
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.parallel.tensor import (make_mesh2d,
                                                     make_tp_train_step)
    inp = load(os.path.join(work, "in.pt"))
    tcfg = tconfig.TrainConfig()
    mesh = make_mesh2d(dp, mp)
    local = S.shard_batch(batch_of(inp["batch"]), mesh)
    step = make_tp_train_step(mcfg, tcfg, mesh)
    st = tp_state(mcfg, None, mesh, tcfg)
    step(st, local)
    snap = ckpt.full_snapshot(st)
    if rank == 0:
        ckpt.save_checkpoint(os.path.join(work, "exp"), 1, snap)
    dist.barrier()
    step(st, local)
    straight = ckpt.full_snapshot(st)["model"]
    again = tp_state(mcfg, None, mesh, tcfg)
    ckpt.load_full(again, ckpt.restore_raw(os.path.join(work, "exp"), 1))
    step(again, local)
    resumed = ckpt.full_snapshot(again)["model"]
    if rank == 0:
        save(os.path.join(work, "resume.pt"), (straight, resumed, snap))


# ------------------------------------------------------------- serving

def mesh_serving(rank, work, n):
    """Over a data mesh of ``n`` ranks, each rank: ``knn_predict_sharded``
    (float32, int8) on work/in.pt["knn"]; the mesh service against the
    one-device service (both built here) on the 30-clip synthetic set:
    identify_raw, then enroll (each code twice: exact ties), identify,
    remove, identify; and ``encode_dataset`` with the mesh and without.
    Each rank saves its results to work/serve<rank>.pt."""
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from ugaitnet_tpu_torch.eval.encode import encode_dataset
    from ugaitnet_tpu_torch.eval.serving import SignatureService
    from ugaitnet_tpu_torch.ops.knn import knn_predict_sharded
    inp = load(os.path.join(work, "in.pt"))
    mesh = S.make_mesh(n)
    out = {"knn": {dt: knn_predict_sharded(*inp["knn"], mesh, k=3,
                                           gallery_dtype=dt)
                   for dt in ("float32", "int8")}}
    ds = make_synthetic_dataset(num_subjects=5, videos_per_subject=2,
                                subseqs_per_video=3, seed=7)
    mods = ("of", "gray")
    raw = {f"raw_{m}": ds.modalities[m].volumes[:8] for m in mods}
    model = UGaitNet(inp["serve_cfg"], device="cpu")
    model.load_state_dict(flax_to_state_dict(inp["serve_params"]))
    ties = inp["ties"]
    for dt in ("float32", "int8"):
        res = {}
        for name, m in (("one", None), ("mesh", mesh)):
            svc = SignatureService(model, mods, knn=3, buckets=(4, 16),
                                   gallery_dtype=dt, mesh=m)
            svc.build_gallery(ds, batch_size=16)
            r = {"rows": int(svc._gallery_codes.shape[0]),
                 "capacity": svc._capacity,
                 "identify": svc.identify_raw(raw)}
            codes = svc.encode_raw(raw)
            ptr = svc._gallery_codes.data_ptr()
            svc.enroll(codes[:2], ds.labels[:2] + 100)      # in place
            r["in_place"] = svc._gallery_codes.data_ptr() == ptr
            r["enrolled"] = svc.identify_codes(codes)
            r["removed"] = svc.remove(int(ds.labels[0]) + 100)
            r["after_remove"] = svc.identify_codes(codes)
            svc.enroll(codes[2:], ds.labels[2:8] + 100)     # a rebuild
            r["capacity_after"] = svc._capacity
            r["rebuilt"] = svc.identify_codes(codes)
            # exact ties, one copy in each rank's block
            svc.set_gallery(ties["codes"], ties["labels"])
            r["ties"] = svc.identify_codes(ties["queries"])
            res[name] = r
        out[dt] = res
    enc = UGaitNet(inp["encode_cfg"], device="cpu")
    enc.load_state_dict(flax_to_state_dict(inp["encode_params"]))
    out["encode"] = {name: encode_dataset(enc, ds, mods, batch_size=8,
                                          mesh=m)[0]
                     for name, m in (("one", None), ("mesh", mesh))}
    save(os.path.join(work, f"serve{rank}.pt"), out)
