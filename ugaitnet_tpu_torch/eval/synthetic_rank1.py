"""Synthetic-identities convergence run -> open-world protocol -> Rank-1 +
EER.

Port of ``benchmarks/synthetic_rank1.py``: train the flagship two-branch
topology (gaitset x gaitset, sign_max merge) through the real
``Trainer.fit`` loop (P x K sampler, expand_level=2 modality dropout,
plateau lr control, early stop, checkpoints) on synthetic identities, then
push a held-out draw of the same identities (same ``template_seed``,
another ``seed``) through ``eval/protocol.py``'s camera-pair path
(encode_set -> per-gallery-camera kNN -> subsequence Rank-1 + per-video
majority vote) and a pooled verification EER, for three probe sweeps:
full, of_only and gray_only against the full gallery.

A model that plateaus at chance scores Rank-1 ~= 1 / num_subjects, so the
run checks the sampler, the modality dropout, the lr control, the encode
tap and the kNN protocol together, where one-step parity tests would pass
each piece alone.

The recipe is the JAX script's.  ``full_width`` is the one addition: the
branches take the flagship's defaults (channels (32, 64, 128), part_dim
256, 62 parts) instead of the script's (8, 8, 16) and 16.

    python -m ugaitnet_tpu_torch.eval.synthetic_rank1 --num-subjects 16 \\
        --device cpu --out /tmp/r.json

Without ``--device`` the run takes the CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import (BranchConfig, DataConfig,
                                            EvalConfig, ModelConfig,
                                            TrainConfig)
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.protocol import (EncodedSet, encode_set,
                                              eval_camera_pairs)
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops.metrics import eer_verif_dist
from ugaitnet_tpu_torch.train.trainer import Trainer

SWEEPS = {"full": (1.0, 1.0), "of_only": (1.0, 0.0), "gray_only": (0.0, 1.0)}
MODALITIES = ("of", "gray")
TINY_WIDTH = dict(gaitset_channels=(8, 8, 16), part_dim=16)
# float64 (probe, gallery, D) differences held at once by rank1_eer
_CHUNK_BYTES = 1 << 28


def datasets(num_subjects: int, seed: int
             ) -> Tuple[GaitDataset, GaitDataset]:
    """The train set and the held-out eval set: the same identity
    templates, every eval subsequence an unseen draw."""
    kw = dict(num_subjects=num_subjects, videos_per_subject=3,
              subseqs_per_video=3, template_seed=7)
    return (make_synthetic_dataset(seed=seed, name="syn_train", **kw),
            make_synthetic_dataset(seed=seed + 1, name="syn_eval", **kw))


def recipe(num_subjects: int, epochs: int, full_width: bool = False
           ) -> Tuple[ModelConfig, DataConfig, TrainConfig, EvalConfig]:
    """The model, data, train and eval configurations of the run."""
    width = {} if full_width else TINY_WIDTH
    mcfg = ModelConfig(
        branches=tuple(BranchConfig(kind="gaitset", modality=m, **width)
                       for m in MODALITIES),
        merge="sign_max", nclasses=num_subjects)
    # expand_level=2: each sampled row is replicated with a modality
    # dropped, so the model learns usable single-modality embeddings and
    # the probe sweeps measure graceful degradation
    dcfg = DataConfig(batch_size=16, repetitions=4, expand_level=2,
                      augment=False)
    tcfg = TrainConfig(lr=3e-3, epochs=epochs, extra_epochs=0,
                       save_every_epochs=5, loss_weights=(1.0, 0.2),
                       optimizer="adam")
    return mcfg, dcfg, tcfg, EvalConfig(typecode=3, batch_size=32, knn=1)


def rank1_eer(gallery: EncodedSet, probe: EncodedSet,
              device: DeviceLike = None) -> Dict[str, float]:
    """Camera-pair Rank-1 (probe camera 0, galleries cameras 1 and 2) and
    the pooled verification EER over every probe-gallery pair (genuine =
    same subject) on float64 distances.  device: where the kNN and the
    distances run (None: the CUDA card).

    The distances are the JAX script's, sum((p - g)^2) in float64, summed
    in torch's order instead of numpy's: they part by ~1e-16 relative,
    which orders no pair differently in the tests.  On the card a
    full-width sweep takes milliseconds where numpy on the host takes
    seconds."""
    res = eval_camera_pairs(gallery, probe, probe_camera=0, knn=1,
                            cameras=(0, 1, 2), device=device)
    dev = resolve_device(device)
    g = torch.as_tensor(gallery.codes, dtype=torch.float64, device=dev)
    p = torch.as_tensor(probe.codes, dtype=torch.float64, device=dev)
    rows = max(1, _CHUNK_BYTES // max(1, g.numel() * 8))
    d2 = torch.cat([((p[i:i + rows, None, :] - g[None]) ** 2).sum(-1)
                    for i in range(0, len(p), rows)])
    gt = (probe.labels[:, None] == gallery.labels[None, :]).astype(np.int64)
    eer, _ = eer_verif_dist(gt.ravel(), d2.sqrt().cpu().numpy().ravel())
    return {"rank1_subseq": res["rank1_subseq"],
            "rank1_video": res["rank1_video"], "eer": eer}


def _select(enc: EncodedSet, rows: np.ndarray) -> EncodedSet:
    return EncodedSet(enc.codes[rows], enc.labels[rows],
                      enc.video_ids[rows], enc.cams[rows])


def score(model: UGaitNet, eval_ds: GaitDataset, ecfg: EvalConfig,
          device: DeviceLike = None) -> Tuple[Dict[str, Dict], int]:
    """Each sweep's rank1_eer and the probe count.  The gallery is the full
    sweep's codes of cameras 1 and 2; every sweep's probes are its camera-0
    codes, so the sweeps vary only what the probe subject presents."""
    sweeps, gallery, n_probe = {}, None, 0
    for name, use_mods in SWEEPS.items():
        enc = encode_set(model, eval_ds, MODALITIES, ecfg, use_mods=use_mods)
        probe = _select(enc, np.where(enc.cams == 0)[0])
        if gallery is None:
            gallery = _select(enc, np.where(enc.cams != 0)[0])
            n_probe = len(probe.labels)
        sweeps[name] = rank1_eer(gallery, probe, device)
    return sweeps, n_probe


def run(experdir: str, num_subjects: int = 16, epochs: int = 20,
        seed: int = 0, device: DeviceLike = None,
        full_width: bool = False) -> Dict:
    """Train, encode the held-out draw and score it; the JAX script's
    result dict.  device: None takes the CUDA card (and raises without
    one); the kNN runs on the same device."""
    train_ds, eval_ds = datasets(num_subjects, seed)
    mcfg, dcfg, tcfg, ecfg = recipe(num_subjects, epochs, full_width)

    t0 = time.time()
    trainer = Trainer(mcfg, dcfg, tcfg, experdir, device=device)
    state = trainer.fit(train_ds, val_perc=0.15, seed=seed)
    train_s = time.time() - t0

    t0 = time.time()
    sweeps, n_probe = score(state.model, eval_ds, ecfg, trainer.device)
    eval_s = time.time() - t0

    return {
        "protocol": ("eval_camera_pairs (probe cam 0, galleries cams 1,2); "
                     "probe modality-presence sweeps vs the full gallery; "
                     "pooled verification EER"),
        "num_subjects": num_subjects,
        "train_subseqs": int(len(train_ds.labels)),
        "eval_subseqs": int(len(eval_ds.labels)),
        "probe_subseqs": int(n_probe),
        "rank1_subseq": sweeps["full"]["rank1_subseq"],
        "rank1_video": sweeps["full"]["rank1_video"],
        "eer": sweeps["full"]["eer"],
        "sweeps": sweeps,
        "chance_rank1": 1.0 / num_subjects,
        "train_seconds": round(train_s, 1),
        "encode_eval_seconds": round(eval_s, 1),
    }


def main(argv: Optional[list] = None) -> Dict:
    p = argparse.ArgumentParser("ugaitnet-torch-synthetic-rank1")
    p.add_argument("--num-subjects", type=int, default=64)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--full-width", action="store_true",
                   help="the flagship's branch widths instead of the tiny "
                        "(8, 8, 16), part_dim 16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--out", required=True, help="path of the result JSON")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        out = run(os.path.join(d, "exp"), num_subjects=args.num_subjects,
                  epochs=args.epochs, device=args.device,
                  full_width=args.full_width)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
