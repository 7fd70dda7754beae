"""One step of every ported multi-device training form over n ranks.

Port of ``__graft_entry__.py:dryrun_multichip`` of the JAX package:

    python -m ugaitnet_tpu_torch.parallel.dryrun [n] [--device cpu]

runs, at the tiny flagship (channels (8, 8, 16), part_dim 16, global batch
2n in pairs), one step each of the global data-parallel form, the per-shard
form, and at even n tensor parallelism on an (n/2, 2) mesh (whose loss must
equal the global form's), sequence parallelism on an (n/2, 2) mesh and
expert parallelism on an (n/2, 2) mesh with an MoE variant (4 experts),
whose loss must equal the one-process MoE step's on the same batch.  Rank 0
runs the pipeline step over the first two devices (one process), whose
loss must equal the global form's.  Then the deterministic parity block:
with dropout off and per-sample L2 (``l2_mode="feature"``) the global form,
the per-shard form and sequence parallelism compute one objective, and
must agree.  Last, the sharded kNN: a 99-row gallery (which n need not
divide) split over the n ranks, float32 and int8, must give the
one-device kNN's labels.  By default the ranks take cards 0..n-1 (NCCL)
and it raises with fewer cards; ``--device cpu`` runs CPU ranks on gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# the JAX dryrun's agreement limit for one objective computed two ways
PARITY_RTOL = 1e-3


def tiny_flagship(experts: int = 0, deterministic: bool = False):
    """``__graft_entry__._flagship_cfg(tiny=True)``, optionally with MoE
    part projections, or with dropout off and per-sample L2."""
    from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
    kw = dict(gaitset_channels=(8, 8, 16), part_dim=16,
              moe_experts=experts)
    if deterministic:
        kw["dropout"] = 0.0
    cfg = ModelConfig(
        branches=(BranchConfig(kind="gaitset", modality="of", **kw),
                  BranchConfig(kind="gaitset", modality="gray", **kw)),
        merge="sign_max", nclasses=74)
    if deterministic:
        cfg = dataclasses.replace(cfg, dropout_code=0.0, l2_mode="feature")
    return cfg


def dryrun_batch(b: int, device):
    from ugaitnet_tpu_torch.train.train_step import Batch
    rng = np.random.RandomState(0)
    return Batch(
        volumes=(torch.from_numpy(rng.randn(b, 25, 60, 60, 2)
                                  .astype(np.float32)).to(device),
                 torch.from_numpy(rng.randn(b, 25, 60, 60, 1)
                                  .astype(np.float32)).to(device)),
        use_flags=(torch.ones(b, device=device),
                   torch.ones(b, device=device)),
        labels=torch.from_numpy(np.repeat(np.arange(b // 2), 2)
                                .astype(np.int32)).to(device))


def _state(mcfg, tcfg, device, mesh=None, ep_mesh=None, tp_mesh=None):
    """A seed-0 state; with ``ep_mesh`` / ``tp_mesh`` its experts / its
    tensor-parallel shards placed on the mesh before the optimizer is
    made."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.parallel.expert import place_ep_model
    from ugaitnet_tpu_torch.parallel.tensor import place_tp_model
    from ugaitnet_tpu_torch.train.train_step import init_state
    model = UGaitNet(mcfg, device=device, seed=0, mesh=mesh)
    if ep_mesh is not None:
        place_ep_model(model, ep_mesh)
    if tp_mesh is not None:
        place_tp_model(model, tp_mesh)
    return init_state(model, tcfg)


def _close(a: float, b: float, what: str) -> None:
    if not abs(a - b) < PARITY_RTOL * max(1.0, abs(b)):
        raise AssertionError(f"{what}: {a} vs {b}")


def _rank(rank: int, n: int, devices: Sequence) -> None:
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.parallel.expert import (make_ep_train_step,
                                                     make_mesh_dpep)
    from ugaitnet_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from ugaitnet_tpu_torch.parallel.sequence import (make_mesh_dpsp,
                                                       make_sp_train_step,
                                                       shard_batch_sp,
                                                       sp_model_config)
    from ugaitnet_tpu_torch.parallel.tensor import (make_mesh2d,
                                                     make_tp_train_step)
    from ugaitnet_tpu_torch.train.train_step import make_train_step

    tcfg = TrainConfig(lr=1e-4, loss_weights=(1.0, 0.1))
    mcfg = tiny_flagship()
    mesh = S.make_mesh(n, devices)
    dev = mesh.device
    batch = dryrun_batch(2 * n, dev)
    local = S.shard_batch(batch, mesh)
    even = n % 2 == 0

    def loss_of(step, state, b):
        _, m = step(state, b)
        value = float(m["loss"])
        if not np.isfinite(value):
            raise FloatingPointError(f"non-finite loss {value}")
        return value

    loss = loss_of(S.make_sharded_train_step(mcfg, tcfg, mesh),
                   _state(mcfg, tcfg, dev), local)
    loss2 = loss_of(S.make_shardmap_train_step(mcfg, tcfg, mesh),
                    _state(mcfg, tcfg, dev), local)
    loss3 = loss4 = loss5 = loss6 = float("nan")
    if even:
        mesh_tp = make_mesh2d(n // 2, 2, devices)
        loss3 = loss_of(make_tp_train_step(mcfg, tcfg, mesh_tp),
                        _state(mcfg, tcfg, dev, tp_mesh=mesh_tp),
                        S.shard_batch(batch, mesh_tp))
        _close(loss3, loss, "TP vs the global form")
        mesh_sp = make_mesh_dpsp(n // 2, 2, devices)
        loss4 = loss_of(
            make_sp_train_step(mcfg, tcfg, mesh_sp),
            _state(sp_model_config(mcfg), tcfg, dev, mesh_sp),
            shard_batch_sp(batch, mesh_sp))
        mcfg_moe = tiny_flagship(experts=4)
        ref6 = loss_of(make_train_step(mcfg_moe, tcfg),
                       _state(mcfg_moe, tcfg, dev), batch)
        mesh_ep = make_mesh_dpep(n // 2, 2, devices)
        loss6 = loss_of(make_ep_train_step(mcfg_moe, tcfg, mesh_ep),
                        _state(mcfg_moe, tcfg, dev, ep_mesh=mesh_ep),
                        S.shard_batch(batch, mesh_ep))
        _close(loss6, ref6, "EP vs the one-process MoE step")

    if rank == 0:
        pp_devs = [torch.device(d) for d in devices[:2]]
        if len(pp_devs) < 2:
            pp_devs = pp_devs * 2
        st = _state(mcfg, tcfg, pp_devs[0])
        loss5 = loss_of(make_pipeline_train_step(st.model, st.optimizer,
                                                 mcfg, tcfg, pp_devs),
                        st, dryrun_batch(2 * n, pp_devs[0]))
        _close(loss5, loss, "PP vs the global form")

    # deterministic parity: dropout off, per-sample L2
    det = tiny_flagship(deterministic=True)
    det_g = loss_of(S.make_sharded_train_step(det, tcfg, mesh),
                    _state(det, tcfg, dev), local)
    det_s = loss_of(S.make_shardmap_train_step(det, tcfg, mesh),
                    _state(det, tcfg, dev), local)
    _close(det_s, det_g, "per-shard vs global (deterministic)")
    det_sp = float("nan")
    if even:
        det_sp = loss_of(
            make_sp_train_step(det, tcfg, mesh_sp),
            _state(sp_model_config(det), tcfg, dev, mesh_sp),
            shard_batch_sp(batch, mesh_sp))
        _close(det_sp, det_g, "SP vs global (deterministic)")
    # the sharded kNN against the one-device kNN, on a gallery size that
    # need not divide the world
    from ugaitnet_tpu_torch.ops.knn import knn_predict, knn_predict_sharded
    krng = np.random.RandomState(1)
    protos = krng.randn(11, 64).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    gal = np.repeat(protos, 9, 0) + krng.randn(99, 64).astype(
        np.float32) * 0.05
    glab = np.repeat(np.arange(11), 9)
    probes = np.repeat(protos, 2, 0) + krng.randn(22, 64).astype(
        np.float32) * 0.05
    serve_ref = knn_predict(probes, gal, glab, k=3, device=dev)
    for gdtype in ("float32", "int8"):
        got = knn_predict_sharded(probes, gal, glab, mesh, k=3,
                                  gallery_dtype=gdtype)
        if not np.array_equal(got, serve_ref):
            raise AssertionError(f"sharded {gdtype} kNN diverged from the "
                                 "one-device labels")
    if rank == 0:
        tp_txt = f"{loss3:.4f} (tp 2d)" if even else \
            "skipped (tp needs even n)"
        sp_txt = (f"{loss4:.4f} (sp 2d, local-batch norm + per-shard rng)"
                  if even else "skipped (sp needs even n)")
        ep_txt = f"{loss6:.4f} (ep 2d moe)" if even else \
            "skipped (ep needs even n)"
        print(f"dryrun_multichip({n}): step ok, loss={loss:.4f} (global) / "
              f"{loss2:.4f} (per-shard, local-batch norm + per-shard rng) /"
              f" {tp_txt} / {sp_txt} / {loss5:.4f} (pp) / {ep_txt}; "
              f"deterministic parity (dropout off, per-sample l2): "
              f"{det_g:.4f} (global) == {det_s:.4f} (per-shard)"
              + (f" == {det_sp:.4f} (sp)" if even else "")
              + f"; sharded serving f32+int8 label parity ok (G=99 over "
              f"{n} shards)", flush=True)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     threads: Optional[int] = 1) -> None:
    """One step of each ported form over ``n_devices`` ranks; raises if a
    rank fails or a parity check does not hold.  ``devices=None`` means
    cards 0..n-1 (``parallel/sharding.py:device_list``, which raises with
    fewer cards than ranks); CPU ranks on gloo must be asked for."""
    from ugaitnet_tpu_torch.parallel.sharding import device_list, spawn
    devices = list(devices) if devices is not None else \
        device_list(n_devices)
    spawn(_rank, n_devices, args=(n_devices, devices), devices=devices,
          threads=threads)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("ugaitnet-torch-dryrun")
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default=None,
                   help="cuda (the default: one card per rank) or cpu")
    args = p.parse_args(argv)
    from ugaitnet_tpu_torch.parallel.sharding import device_list
    dryrun_multichip(args.n, device_list(args.n, args.device))


if __name__ == "__main__":
    main()
