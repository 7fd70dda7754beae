"""Open-world evaluation entry point.

Port of ``ugaitnet_tpu/cli/evaluate.py``: load a trained experiment, embed
the gallery (cached) and probe sets, and run either the CASIA-B camera-pair
protocol or the TUM merged-code protocol, optionally sweeping modality
combos.  ``--device`` (default ``cuda``) picks the device; the CPU runs only
when asked for.

``--dp N`` encodes data-parallel over N ranks (``eval/encode.py`` with a
mesh): the command starts the ranks itself as ``cli.train --ndevices`` does
(one card each over NCCL, an error on fewer cards; CPU ranks on gloo with
``--device cpu``), runs as one rank under ``torchrun``, or as a rank of a
process group its caller started (on its current card, so ranks may share
one).  Every rank runs the protocols on the gathered codes; rank 0 prints
and writes the results and the caches.

Example:
  python -m ugaitnet_tpu_torch.cli.evaluate --experdir /exp/... --epoch -1 \\
      --gallery /data/casiab_ft_packed --probes /data/casiab_test_nm_packed \\
      --protocol casiab --knn 3 --typecode 3
  # the same over 2 CPU ranks
  python -m ugaitnet_tpu_torch.cli.evaluate ... --dp 2 --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ugaitnet-torch-eval")
    p.add_argument("--experdir", type=str, required=True)
    p.add_argument("--epoch", type=str, default="-1",
                   help="checkpoint epoch (-1 = latest, 'best' = the "
                        "best-val-loss checkpoint)")
    p.add_argument("--gallery", type=str, required=True,
                   help="packed gallery dataset dir ('ft' split)")
    p.add_argument("--probes", type=str, nargs="+", required=True,
                   help="packed probe dataset dir(s)")
    p.add_argument("--protocol", type=str, default="casiab",
                   choices=["casiab", "openset"])
    p.add_argument("--knn", type=int, default=3)
    p.add_argument("--typecode", type=int, default=3)
    p.add_argument("--usemirror", action="store_true")
    p.add_argument("--useavg", action="store_true", default=True,
                   help="merged-code video protocol averages codes "
                        "(--no-useavg: element-wise max)")
    p.add_argument("--no-useavg", dest="useavg", action="store_false")
    p.add_argument("--allcombos", action="store_true",
                   help="gallery from all modality combos")
    p.add_argument("--allcombostest", action="store_true",
                   help="sweep probe modality combos")
    p.add_argument("--usemod", type=float, nargs="+", default=None,
                   help="modality presence mask at eval, e.g. 1 0")
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--dp", type=int, default=0,
                   help="encode data-parallel over N ranks (0 = one "
                        "process)")
    p.add_argument("--outfile", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default the CUDA card; 'cpu' only "
                        "when asked for)")
    return p


def load_experiment(experdir: str, epoch, device=None):
    """Rebuild the model from config.json and restore a checkpoint into it.
    epoch: an int (negative = latest) or the string 'best'.  Returns
    (model, state, mcfg, step)."""
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.core.config import load_json
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import init_state

    cfgs = load_json(os.path.join(experdir, "config.json"))
    mcfg, tcfg = cfgs["model"], cfgs["train"]
    model = UGaitNet(mcfg, device=device)
    if epoch == "best":
        if not ckpt.has_best_checkpoint(experdir):
            raise SystemExit(f"no 'best' checkpoint in {experdir}")
        step = "best"
    else:
        epoch = int(epoch)
        step = (ckpt.latest_checkpoint_step(experdir) if epoch < 0 else epoch)
    if step is None:
        raise SystemExit(f"no checkpoint found in {experdir}")
    state = ckpt.restore_checkpoint(experdir, step, init_state(model, tcfg))
    return model, state, mcfg, step


def ds_tag(path: str) -> str:
    """Dataset identity in a cache name: distinct dirs sharing a basename
    (or a dir whose contents changed) never reuse each other's codes."""
    ap = os.path.abspath(path)
    seed = ap
    for fn in ("meta.json", "labels.npy"):
        fp = os.path.join(ap, fn)
        if os.path.exists(fp):
            seed += f":{fn}:{os.path.getmtime(fp)}:{os.path.getsize(fp)}"
    return hashlib.sha1(seed.encode()).hexdigest()[:10]


def _rank_main(rank: int, argv) -> None:
    main(argv)


def main(argv=None):
    """The results (on rank 0 of ``--dp``; None where the command started
    the ranks: they are in the results file)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.dp <= 0:
        return _evaluate(args, None)
    import torch.distributed as dist
    from ugaitnet_tpu_torch.parallel import sharding as S
    if dist.is_initialized():
        # a rank of a world started before this call
        return _evaluate(args, S.make_mesh(args.dp,
                                           S.rank_devices(args.device)))
    if not S.under_torchrun():
        S.spawn_command(_rank_main, args.dp, argv, args.device)
        return None
    S.init_from_env(args.device)
    try:
        return _evaluate(args, S.make_mesh(args.dp))
    finally:
        dist.destroy_process_group()


def _evaluate(args, mesh):
    from ugaitnet_tpu_torch.core.config import EvalConfig
    from ugaitnet_tpu_torch.data.pipeline import load_norm_stats
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.eval.protocol import (
        EncodedSet, encode_set, eval_all_combos, eval_camera_pairs,
        eval_openset)

    main_rank = mesh is None or mesh.is_main
    model, state, mcfg, step = load_experiment(
        args.experdir, args.epoch,
        device=mesh.device if mesh is not None else args.device)
    if step == "best":
        # the 'best' checkpoint is overwritten as training improves; its
        # mtime in the cache tag keeps cached codes from outliving the
        # weights that produced them
        bdir = os.path.join(args.experdir, "ckpt", "best")
        step = f"best{int(os.path.getmtime(bdir))}"
    modalities = tuple(b.modality for b in mcfg.branches)
    # models trained with --normstats persist their standardization; encode
    # with the same stats or the net sees inputs on the wrong scale
    norm_stats = load_norm_stats(args.experdir, modalities)
    if norm_stats is not None and main_rank:
        print("* using persisted norm_stats.npz standardization",
              flush=True)
    ecfg = EvalConfig(knn=args.knn, typecode=args.typecode,
                      batch_size=args.bs, mirror_gallery=args.usemirror)
    dev = model.device

    gallery_ds = GaitDataset.load(args.gallery)
    gallery = None   # encoded lazily: the allcombos paths build their own

    def get_gallery():
        nonlocal gallery
        if gallery is None:
            cache = os.path.join(
                args.experdir,
                f"codes_gallery_{ds_tag(args.gallery)}_e{step}"
                f"_t{args.typecode}_bs{args.bs}"
                f"_mir{int(args.usemirror)}.npz")
            gallery = encode_set(model, gallery_ds, modalities, ecfg,
                                 mirror=args.usemirror, cache_path=cache,
                                 norm_stats=norm_stats, mesh=mesh)
        return gallery

    combo_memo = {}
    results = {}
    for probe_dir in args.probes:
        probe_ds = GaitDataset.load(probe_dir)
        name = os.path.basename(probe_dir.rstrip("/"))
        if args.allcombostest or args.allcombos:
            results[name] = eval_all_combos(
                model, gallery_ds, probe_ds, modalities, ecfg,
                combo_gallery=args.allcombos, use_avg=args.useavg,
                gallery_memo=combo_memo, norm_stats=norm_stats, mesh=mesh)
            continue
        # probe codes are cached per test dir like the gallery's
        mods_tag = ("all" if args.usemod is None else
                    "m" + "-".join(f"{u:g}".replace(".", "p")
                                   for u in args.usemod))
        probe_cache = os.path.join(
            args.experdir,
            f"codes_probe_{name}_{ds_tag(probe_dir)}_e{step}"
            f"_t{args.typecode}_bs{args.bs}_{mods_tag}.npz")
        probe = encode_set(model, probe_ds, modalities, ecfg,
                           use_mods=args.usemod, cache_path=probe_cache,
                           norm_stats=norm_stats, mesh=mesh)
        # per-camera confusion matrices ride along with the results, like
        # the reference's all_test_results h5
        conf_all = {}
        if args.protocol == "casiab":
            per_cam = {}
            gal = get_gallery()
            for cam in np.unique(probe.cams):
                sel = probe.cams == cam
                sub = EncodedSet(probe.codes[sel], probe.labels[sel],
                                 probe.video_ids[sel], probe.cams[sel])
                conf = {}
                per_cam[int(cam)] = eval_camera_pairs(
                    gal, sub, probe_camera=int(cam), knn=args.knn,
                    cameras=np.unique(gal.cams).tolist(), confusions=conf,
                    device=dev)
                for k, v in conf.items():
                    conf_all[f"probe{int(cam)}_{k}"] = v
            results[name] = per_cam
        else:
            results[name] = eval_openset(get_gallery(), probe, knn=args.knn,
                                         use_avg=args.useavg,
                                         confusions=conf_all, device=dev)
        if conf_all and main_rank:
            # the filename carries the code caches' discriminators, so two
            # eval configurations never overwrite each other's matrices
            conf_file = os.path.join(
                args.experdir,
                f"confusions_{name}_{ds_tag(probe_dir)}_e{step}"
                f"_k{args.knn}_t{args.typecode}_{mods_tag}"
                f"_mir{int(args.usemirror)}.npz")
            np.savez_compressed(conf_file, **conf_all)
            # a reserved sibling key, so results[name] keeps one shape
            results[name]["confusions_file"] = conf_file

    if not main_rank:
        return results
    out = json.dumps(results, indent=2, default=float)
    print(out)
    outfile = args.outfile or os.path.join(
        args.experdir, f"results_e{step}_k{args.knn}_t{args.typecode}.json")
    with open(outfile, "w") as f:
        f.write(out)
    print(f"* results saved to {outfile}")
    return results


if __name__ == "__main__":
    main()
