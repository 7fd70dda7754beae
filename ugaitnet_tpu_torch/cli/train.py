"""Training entry point.

Port of ``ugaitnet_tpu/cli/train.py``: the same flags and the same
``configs_from_args``, plus ``--device`` (default ``cuda``; the CPU only
when asked for).  The multi-device modes, MoE, remat, warm starts and joint
two-dataset training raise ``NotImplementedError`` naming their ROADMAP item.

Examples:
  # flagship CASIA-B 2-mod config (gaitset + sign_max)
  python -m ugaitnet_tpu_torch.cli.train --datadir /data/casiab_packed \\
      --mod0 of --mod1 gray --nclasses 74 --mergefun sign_max \\
      --bs 40 --lr 1e-4 --margin 0.2 --wver 1.0 --wid 0.1 \\
      --epochs 75 --extraepochs 25 --repetitions 5 --experdir /exp

  # smoke run on synthetic data, on the CPU
  python -m ugaitnet_tpu_torch.cli.train --synthetic --epochs 2 --bs 8 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import os

ROADMAP_MULTI = "ROADMAP.md section 1, item 12 (multi-device and extras)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ugaitnet-torch-train")
    p.add_argument("--datadir", type=str, default="",
                   help="packed GaitDataset directory (data/schema.py)")
    p.add_argument("--datadir2", type=str, default="",
                   help="second packed dataset for joint (BothDatasets) "
                        "training: labels +305, gaits +3 (not ported yet)")
    p.add_argument("--normstats", action="store_true",
                   help="plane-wise mean/std standardization of the "
                        "training set")
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
                   help="data-parallel devices (not ported yet)")
    p.add_argument("--tp", type=int, default=0,
                   help="model-parallel devices (not ported yet)")
    p.add_argument("--sp", type=int, default=0,
                   help="sequence-parallel devices (not ported yet)")
    p.add_argument("--pp", type=int, default=0,
                   help="branch-placement devices (not ported yet)")
    p.add_argument("--ep", type=int, default=0,
                   help="expert-parallel devices (not ported yet)")
    p.add_argument("--asyncckpt", action="store_true",
                   help="write checkpoints on a background thread (the "
                        "train loop waits only for the copy to the host)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize branch activations (not ported yet)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay fp32)")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--initnet", type=str, default="",
                   help="warm-start the whole net from a prior experiment "
                        "(not ported yet)")
    p.add_argument("--initbranch", type=str, action="append", default=[],
                   help="per-branch warm start (not ported yet)")
    p.add_argument("--initepoch", type=str, default="-1",
                   help="checkpoint epoch for --initnet/--initbranch")
    p.add_argument("--gschannels", type=str, default="",
                   help="gaitset stage widths 'c1,c2,c3' (default 32,64,128;"
                        " smaller for smoke runs / sweeps)")
    p.add_argument("--gspartdim", type=int, default=0,
                   help="gaitset per-part projection dim (default 256)")
    p.add_argument("--moe", type=int, default=0,
                   help="MoE part projection experts (not ported yet)")
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


def _refuse_unported(args) -> None:
    """The flags whose paths the port does not have yet."""
    for flag in ("ndevices", "tp", "sp", "pp", "ep", "moe"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet "
                                      f"({ROADMAP_MULTI})")
    if args.remat:
        raise NotImplementedError(
            "--remat is not ported yet (ROADMAP.md section 1, item 10: the "
            "remaining model and loss surface)")
    if args.initnet or args.initbranch:
        raise NotImplementedError(
            "--initnet/--initbranch are not ported yet (ROADMAP.md section "
            "1, item 12: utils/warm_start.py)")
    if args.datadir2:
        raise NotImplementedError(
            "--datadir2 is not ported yet (ROADMAP.md section 1, item 11: "
            "it needs data/{convert,partitions}.py)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from ugaitnet_tpu_torch.train.trainer import Trainer, experiment_name

    if args.nclasses is None:
        # --synthetic defaults to a smoke-sized 8 classes so the module
        # docstring's example runs out of the box; real data keeps 74
        args.nclasses = 8 if args.synthetic else 74
    mcfg, dcfg, tcfg = configs_from_args(args)
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

    experdir = os.path.join(
        args.experdir, experiment_name(mcfg, dcfg, tcfg, args.experfix))
    print(f"* experiment dir: {experdir}", flush=True)

    norm_stats = None
    if args.normstats:
        from ugaitnet_tpu_torch.data.pipeline import \
            compute_normalization_stats
        norm_stats = {}
        for b in mcfg.branches:
            mean, std = compute_normalization_stats(ds, b.modality)
            norm_stats[b.modality] = (mean[None], std[None])

    trainer = Trainer(mcfg, dcfg, tcfg, experdir,
                      use_tensorboard=args.tensorboard,
                      norm_stats=norm_stats, device=args.device)
    trainer.fit(ds, val_perc=args.valperc, seed=args.seed)
    print("* training done", flush=True)
    return experdir


if __name__ == "__main__":
    main()
