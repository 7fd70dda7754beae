"""Training entry point.

Port of ``ugaitnet_tpu/cli/train.py``: the same flags and the same
``configs_from_args``, plus ``--device`` (default ``cuda``; the CPU only
when asked for).  ``--ndevices N`` trains data-parallel on N ranks,
``--sp S`` / ``--ep E`` / ``--tp M`` on a (max(1, N) x S) sequence-,
expert- or tensor-parallel mesh (``parallel/``).  The command starts the
ranks itself, one process each (``--device cpu``: CPU ranks on gloo; else
one card each, NCCL, and an error when the host has fewer cards), or runs
as one rank under ``torchrun``.  ``--pp P`` trains with branch placement
in this one process over cards 0..P-1 (an error when the host has fewer),
or P CPU devices with ``--device cpu``.

Examples:
  # flagship CASIA-B 2-mod config (gaitset + sign_max)
  python -m ugaitnet_tpu_torch.cli.train --datadir /data/casiab_packed \\
      --mod0 of --mod1 gray --nclasses 74 --mergefun sign_max \\
      --bs 40 --lr 1e-4 --margin 0.2 --wver 1.0 --wid 0.1 \\
      --epochs 75 --extraepochs 25 --repetitions 5 --experdir /exp

  # smoke run on synthetic data, on the CPU
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 2 --bs 8 \\
      --device cpu

  # casenet C with the code as the triplet tap, aux heads, focal id loss,
  # remat, semi-hard triplets
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 1 --bs 8 \\
      --casenet C --postriplet 2 --auxlosses --focal --remat \\
      --tripletkind semi_hard --device cpu

  # data-parallel on 2 CPU ranks; sequence-parallel over 2 ranks; expert-
  # parallel MoE; on a host with 2 cards: --device cuda (the default), or
  # torchrun --nproc-per-node 2 -m ugaitnet_tpu_torch.cli.train --ndevices 2
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 1 --bs 8 \\
      --ndevices 2 --device cpu
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 1 --bs 8 \\
      --sp 2 --device cpu
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 1 --bs 8 \\
      --ep 2 --moe 4 --device cpu

  # tensor-parallel on a (2 x 2) mesh; branch placement over 2 devices;
  # on a host with 4 cards: torchrun --nproc-per-node 4
  # -m ugaitnet_tpu_torch.cli.train --ndevices 2 --tp 2
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 1 --bs 8 \\
      --ndevices 2 --tp 2 --device cpu
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 1 --bs 8 \\
      --pp 2 --device cpu

  # joint TUM-GAID + CASIA-B (BothDatasets) with per-source standardization,
  # then a fine-tune on CASIA-B from its best checkpoint (head surgery)
  python -m ugaitnet_tpu_torch.cli.train --datadir /data/tum_packed \\
      --datadir2 /data/casiab_packed --normstats --nclasses 224 \\
      --experdir /exp/joint
  python -m ugaitnet_tpu_torch.cli.train --datadir /data/casiab_packed \\
      --nclasses 74 --initnet /exp/joint/<run> --initepoch best \\
      --experdir /exp/ft
"""

from __future__ import annotations

import argparse
import os
import sys

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ugaitnet-torch-train")
    p.add_argument("--datadir", type=str, default="",
                   help="packed GaitDataset directory (data/schema.py)")
    p.add_argument("--datadir2", type=str, default="",
                   help="second packed dataset for joint (BothDatasets) "
                        "training: labels +305, gaits +3")
    p.add_argument("--normstats", action="store_true",
                   help="per-dataset plane-wise mean/std standardization "
                        "(BothDatasets normalize_paths equivalent)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic in-memory dataset")
    p.add_argument("--experdir", type=str, default="./experiments")
    p.add_argument("--experfix", type=str, default="demo")
    p.add_argument("--mod0", type=str, default="of")
    p.add_argument("--mod1", type=str, default="gray")
    p.add_argument("--mod2", type=str, default="",
                   help="third modality (e.g. depth) for 3-mod training")
    p.add_argument("--singlemod", action="store_true",
                   help="single-modality net (uses --mod0 only)")
    p.add_argument("--nclasses", type=int, default=None,
                   help="default 74 (8 with --synthetic)")
    p.add_argument("--gaitset", action="store_true", default=True)
    p.add_argument("--no-gaitset", dest="gaitset", action="store_false")
    p.add_argument("--use3d", action="store_true",
                   help="3D conv branches instead of 2D")
    p.add_argument("--mergefun", type=str, default="max",
                   choices=["max", "average", "sign_max"])
    p.add_argument("--casenet", type=str, default="D",
                   help="B/D: no extra dense; C: extra 256-d code head")
    p.add_argument("--postriplet", type=int, default=1)
    p.add_argument("--auxlosses", action="store_true")
    p.add_argument("--bs", "--batchsize", dest="bs", type=int, default=40)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.4)
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--wver", type=float, default=1.0,
                   help="triplet loss weight")
    p.add_argument("--wid", type=float, default=0.1, help="id CE weight")
    p.add_argument("--softlabel", type=float, default=0.0)
    p.add_argument("--focal", action="store_true")
    p.add_argument("--onlytriplet", action="store_true",
                   help="drop the id-CE term (BothDatasets only_triplet)")
    p.add_argument("--normbfmerge", action="store_true",
                   help="L2-normalize branch embeddings before the merge")
    p.add_argument("--tripletkind", type=str, default="batch_all",
                   choices=["batch_all", "semi_hard", "hard"])
    p.add_argument("--epochs", type=int, default=75)
    p.add_argument("--extraepochs", type=int, default=0)
    p.add_argument("--savemodelfreq", type=int, default=5)
    p.add_argument("--repetitions", type=int, default=5)
    p.add_argument("--buildgaits", type=str, default="",
                   help="comma-separated gait-group ids, one per sorted "
                        "unique gait code; equal ids share one balanced "
                        "sampling slot")
    p.add_argument("--expandlevel", type=int, default=3)
    p.add_argument("--noaugment", action="store_true")
    p.add_argument("--valperc", type=float, default=0.08)
    p.add_argument("--ndevices", type=int, default=0,
                   help="data-parallel ranks (0 = one process)")
    p.add_argument("--tp", type=int, default=0,
                   help="model-parallel ranks: a (ndevices x tp) mesh "
                        "splitting GaitSet conv channels and the part head "
                        "(parallel/tensor.py); 0 = off")
    p.add_argument("--sp", type=int, default=0,
                   help="sequence-parallel ranks: a (ndevices x sp) mesh "
                        "sharding the gait set (time) axis "
                        "(parallel/sequence.py); 0 = off, exclusive with "
                        "--tp/--ep")
    p.add_argument("--pp", type=int, default=0,
                   help="branch-placement devices: branch i trains on "
                        "device i, the head stage and optimizer on device 0,"
                        " in this one process (parallel/pipeline.py); "
                        "0 = off, exclusive with the mesh modes")
    p.add_argument("--ep", type=int, default=0,
                   help="expert-parallel ranks: a (ndevices x ep) mesh "
                        "sharding the MoE expert axis (parallel/expert.py);"
                        " requires --moe, 0 = off")
    p.add_argument("--asyncckpt", action="store_true",
                   help="write checkpoints on a background thread (the "
                        "train loop waits only for the copy to the host)")
    p.add_argument("--remat", action="store_true",
                   help="recompute branch activations in the backward "
                        "instead of holding them (torch.utils.checkpoint)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay fp32)")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--initnet", type=str, default="",
                   help="warm-start the WHOLE net from a prior experiment "
                        "dir (or Keras h5); classifier head kept fresh when "
                        "nclasses differs (reference --initnet)")
    p.add_argument("--initbranch", type=str, action="append", default=[],
                   help="per-branch warm start: mod=path, mod=path@srcmod "
                        "or mod=path@<branch index> (repeatable). "
                        "mod=path@of reproduces the reference's "
                        "gray-from-OF gaitset init quirk "
                        "(mj_uwyhNets_ba.py:765)")
    p.add_argument("--initepoch", type=str, default="-1",
                   help="checkpoint epoch for --initnet/--initbranch "
                        "(-1 latest, or 'best')")
    p.add_argument("--gschannels", type=str, default="",
                   help="gaitset stage widths 'c1,c2,c3' (default 32,64,128;"
                        " smaller for smoke runs / sweeps)")
    p.add_argument("--gspartdim", type=int, default=0,
                   help="gaitset per-part projection dim (default 256)")
    p.add_argument("--moe", type=int, default=0,
                   help="MoE part projection with this many experts "
                        "(ops/moe.py): a learned top-1 router over (batch, "
                        "part) tokens replaces the per-part MatMul; 0 = off")
    p.add_argument("--moecap", type=float, default=1.25,
                   help="MoE expert capacity factor")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default the CUDA card; "
                        "'cpu' only when asked for)")
    return p


def configs_from_args(args):
    from ugaitnet_tpu_torch.core.config import (BranchConfig, DataConfig,
                                                ModelConfig, TrainConfig)
    kind = "gaitset" if args.gaitset else ("conv3d" if args.use3d
                                           else "conv2d")
    mods = [args.mod0]
    if not args.singlemod:
        mods.append(args.mod1)
        if args.mod2:
            mods.append(args.mod2)
    extra = {}
    if args.gschannels:
        extra["gaitset_channels"] = tuple(
            int(x) for x in args.gschannels.replace(",", " ").split())
    if args.gspartdim:
        extra["part_dim"] = args.gspartdim
    if args.moe:
        if kind != "gaitset":
            raise SystemExit("--moe requires gaitset branches (the MoE "
                             "head replaces the per-part projection)")
        extra["moe_experts"] = args.moe
        extra["moe_capacity_factor"] = args.moecap
    branches = tuple(
        BranchConfig(kind=kind, modality=m, dropout=args.dropout, **extra)
        for m in mods)
    mcfg = ModelConfig(
        branches=branches, merge=args.mergefun, nclasses=args.nclasses,
        extra_dense=(256,) if args.casenet == "C" else (),
        postriplet=args.postriplet, dropout_code=args.dropout,
        aux_losses=args.auxlosses, norm_before_merge=args.normbfmerge,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat)
    dcfg = DataConfig(batch_size=args.bs, expand_level=args.expandlevel,
                      repetitions=args.repetitions,
                      augment=not args.noaugment,
                      gait_groups=(tuple(
                          int(x) for x in args.buildgaits.replace(
                              ",", " ").split())
                          if args.buildgaits else None))
    tcfg = TrainConfig(
        optimizer=args.optimizer, lr=args.lr, epochs=args.epochs,
        extra_epochs=args.extraepochs, margin=args.margin,
        loss_weights=(args.wver, args.wid), label_smoothing=args.softlabel,
        use_focal=args.focal, only_triplet=args.onlytriplet,
        triplet_kind=args.tripletkind,
        save_every_epochs=args.savemodelfreq, seed=args.seed,
        dp_devices=args.ndevices, tp_devices=args.tp, sp_devices=args.sp,
        pp_devices=args.pp, ep_devices=args.ep,
        async_checkpoint=args.asyncckpt)
    return mcfg, dcfg, tcfg


def check_modes(tcfg, mcfg) -> None:
    """The JAX CLI's exclusivity rules."""
    if sum(1 for d in (tcfg.tp_devices, tcfg.sp_devices,
                       tcfg.ep_devices) if d) > 1:
        raise SystemExit("--tp/--sp/--ep are exclusive (one 2D mesh each); "
                         "pick the sharding that relieves your bottleneck")
    if tcfg.pp_devices and (tcfg.tp_devices or tcfg.sp_devices
                            or tcfg.ep_devices or tcfg.dp_devices):
        raise SystemExit("--pp is exclusive with --ndevices/--tp/--sp/--ep "
                         "(branch placement orchestrates devices itself)")
    if tcfg.ep_devices and not mcfg.has_moe:
        raise SystemExit("--ep requires --moe (there is no expert axis "
                         "to shard otherwise)")


def mesh_axes(tcfg):
    """[(axis, size), ...] of the run's mesh, None for one process (and
    for --pp): --ep, --sp and --tp make a 2-D mesh with --ndevices
    (default 1) data ranks."""
    dp = max(1, tcfg.dp_devices)
    if tcfg.pp_devices:
        return None
    if tcfg.tp_devices:
        return [("data", dp), ("model", tcfg.tp_devices)]
    if tcfg.ep_devices:
        return [("data", dp), ("expert", tcfg.ep_devices)]
    if tcfg.sp_devices:
        return [("data", dp), ("seq", tcfg.sp_devices)]
    if tcfg.dp_devices:
        return [("data", dp)]
    return None


def _rank_main(rank: int, argv) -> None:
    main(argv)


def make_warm_start(args, mcfg):
    """The Trainer's warm_start hook for --initnet / --initbranch (None
    without them): the model's state_dict goes through the flax-layout tree
    (utils/weights.py), the JAX package's warm start runs on it, and the
    result comes back as a state_dict."""
    if not (args.initnet or args.initbranch):
        return None
    from ugaitnet_tpu_torch.utils.warm_start import (
        parse_initbranch_specs, warm_start_branches, warm_start_full)
    from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                                  state_dict_to_flax)
    epoch = args.initepoch if args.initepoch == "best" \
        else int(args.initepoch)
    specs = parse_initbranch_specs(args.initbranch,
                                   tuple(b.modality for b in mcfg.branches))

    def warm_start(state_dict):
        params = state_dict_to_flax(state_dict)
        if args.initnet:
            params = warm_start_full(params, args.initnet, epoch)
        if specs:
            params = warm_start_branches(params, specs, epoch)
        return flax_to_state_dict(params)
    return warm_start


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.nclasses is None:
        # --synthetic defaults to a smoke-sized 8 classes so the module
        # docstring's example runs out of the box; real data keeps 74
        args.nclasses = 8 if args.synthetic else 74
    mcfg, dcfg, tcfg = configs_from_args(args)
    check_modes(tcfg, mcfg)
    from ugaitnet_tpu_torch.train.trainer import experiment_name
    experdir = os.path.join(
        args.experdir, experiment_name(mcfg, dcfg, tcfg, args.experfix))

    axes = mesh_axes(tcfg)
    mesh = None
    if axes is not None:
        import torch.distributed as dist
        from ugaitnet_tpu_torch.parallel import sharding as S
        world = 1
        for _, n in axes:
            world *= n
        if not dist.is_initialized():
            if not S.under_torchrun():
                # one process per rank, each running this command
                print(f"* experiment dir: {experdir} ({world} ranks)",
                      flush=True)
                S.spawn_command(_rank_main, world, argv, args.device)
                return experdir
            S.init_from_env(args.device)
            try:
                return _train(args, mcfg, dcfg, tcfg, experdir,
                              S.build_mesh(axes))
            finally:
                dist.destroy_process_group()
        mesh = S.build_mesh(axes, S.rank_devices(args.device))
    return _train(args, mcfg, dcfg, tcfg, experdir, mesh)


def _train(args, mcfg, dcfg, tcfg, experdir, mesh):
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from ugaitnet_tpu_torch.train.trainer import Trainer

    if args.synthetic:
        if args.nclasses > 16:
            raise SystemExit("--synthetic needs --nclasses <= 16")
        ds = make_synthetic_dataset(
            num_subjects=max(args.nclasses, 2),
            modalities=tuple(b.modality for b in mcfg.branches))
    else:
        if not args.datadir:
            raise SystemExit("--datadir or --synthetic required")
        ds = GaitDataset.load(args.datadir)
        if args.datadir2:
            from ugaitnet_tpu_torch.data.convert import combine_datasets
            ds = combine_datasets(ds, GaitDataset.load(args.datadir2))
    if mesh is None or mesh.is_main:
        print(f"* experiment dir: {experdir}", flush=True)

    norm_stats = None
    if args.normstats:
        import numpy as np
        from ugaitnet_tpu_torch.data.pipeline import \
            compute_normalization_stats
        # one (mean, std) row per dataset source, stacked to (S, T*C)
        src = getattr(ds, "dataset_source", None)
        sources = ((src == 0, src == 1) if src is not None else (None,))
        norm_stats = {}
        for b in mcfg.branches:
            stats = [compute_normalization_stats(ds, b.modality, sel)
                     for sel in sources]
            norm_stats[b.modality] = (np.stack([s[0] for s in stats]),
                                      np.stack([s[1] for s in stats]))

    trainer = Trainer(mcfg, dcfg, tcfg, experdir,
                      use_tensorboard=args.tensorboard, mesh=mesh,
                      norm_stats=norm_stats,
                      warm_start=make_warm_start(args, mcfg),
                      device=args.device)
    trainer.fit(ds, val_perc=args.valperc, seed=args.seed)
    print("* training done", flush=True)
    return experdir


if __name__ == "__main__":
    main()
