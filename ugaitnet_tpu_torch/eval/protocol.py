"""Open-world evaluation protocols.

Port of ``ugaitnet_tpu/eval/protocol.py``, re-deriving the two reference
eval scripts:

  * CASIA-B camera-pair protocol
    (mains/mj_testUWYHGaitNet_open_casiab.py:252-445): embed the gallery
    once (cached), then for every probe condition and every gallery camera
    != probe camera run kNN; report subsequence Rank-1 and per-video
    majority-vote Rank-1, averaged over the gallery cameras.

  * TUM-GAID protocol with video-level merged codes
    (mains/mj_testUWYHGaitNet_open_tum.py:355-446): kNN at subsequence level
    plus a second classifier over per-video averaged (or maxed) codes, with
    optional all-modality-combination galleries and probe sweeps.

Codes come from the model's device; the kNN runs on ``device`` (default
CUDA, ``eval_all_combos`` uses the model's), the metrics on the host.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ugaitnet_tpu_torch.core.config import EvalConfig
from ugaitnet_tpu_torch.core.device import DeviceLike
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.eval.encode import encode_dataset
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops.knn import knn_predict
from ugaitnet_tpu_torch.ops.metrics import (confusion_matrix, rank1_accuracy,
                                            video_majority_vote)


@dataclass
class EncodedSet:
    codes: np.ndarray
    labels: np.ndarray
    video_ids: np.ndarray
    cams: np.ndarray

    def save(self, path: str, config_key: str = "") -> None:
        np.savez_compressed(path, codes=self.codes, labels=self.labels,
                            video_ids=self.video_ids, cams=self.cams,
                            config_key=np.asarray(config_key))

    @classmethod
    def load(cls, path: str, config_key: str = "") -> "EncodedSet":
        z = np.load(path)
        if config_key and "config_key" in z:
            stored = str(z["config_key"])
            if stored and stored != config_key:
                raise ValueError(
                    f"cached codes at {path} were built with config "
                    f"{stored!r}, requested {config_key!r}; delete the "
                    f"cache or use a different cache_path")
        return cls(codes=z["codes"], labels=z["labels"],
                   video_ids=z["video_ids"], cams=z["cams"])


def encode_set(model: UGaitNet, ds: GaitDataset,
               modalities: Sequence[str], cfg: EvalConfig,
               use_mods: Optional[Sequence[float]] = None,
               mirror: bool = False,
               cache_path: Optional[str] = None,
               norm_stats=None, mesh=None) -> EncodedSet:
    """Embed a dataset, with the reference's gallery-code caching
    (codes_gallery_*.h5 pattern, mj_testUWYHGaitNet_open_casiab.py:291-324).
    The cache file is the JAX package's, key included: the key pins
    everything that changes the codes (batch_size too, since under
    l2_mode="reference" the signature L2 reduces over the batch axis), so
    reusing one cache_path across configurations fails loudly.  mesh:
    encode data-parallel (``encode_dataset``); rank 0 writes the cache."""
    key = (f"typecode={cfg.typecode};mirror={int(mirror)};"
           f"bs={cfg.batch_size};norm={int(norm_stats is not None)};"
           f"use_mods={list(use_mods) if use_mods is not None else 'all'}")
    if cache_path and os.path.exists(cache_path):
        return EncodedSet.load(cache_path, config_key=key)
    codes, labels, vids, cams = encode_dataset(
        model, ds, modalities, typecode=cfg.typecode,
        batch_size=cfg.batch_size, use_mods=use_mods, mirror=mirror,
        norm_stats=norm_stats, mesh=mesh)
    es = EncodedSet(codes, labels, vids, cams)
    if cache_path and (mesh is None or mesh.is_main):
        es.save(cache_path, config_key=key)
    return es


def _dense_confusion(pred: np.ndarray, gt: np.ndarray,
                     vocab: np.ndarray) -> np.ndarray:
    """(true, pred) confusion over a fixed label vocabulary."""
    lut = {int(l): i for i, l in enumerate(vocab)}
    p = np.asarray([lut[int(v)] for v in pred])
    g = np.asarray([lut[int(v)] for v in gt])
    return confusion_matrix(p, g, len(vocab))


def eval_camera_pairs(gallery: EncodedSet, probe: EncodedSet,
                      probe_camera: int, knn: int = 3,
                      cameras: Sequence[int] = (0, 18, 36, 54, 72, 90, 108,
                                                126, 144, 162, 180),
                      confusions: Optional[Dict] = None,
                      device: DeviceLike = None) -> Dict[str, float]:
    """CASIA-B: average subseq/video Rank-1 over gallery cams != probe cam.

    confusions: pass a dict to also collect one (true, pred) subseq
    confusion matrix per gallery camera, as the reference persists with its
    results (mj_testUWYHGaitNet_open_casiab.py:415-435); it is filled with
    {"labels": vocab, "cam_<g>": matrix}.
    """
    accs_sub, accs_vid = [], []
    vocab = None
    if confusions is not None:
        vocab = np.unique(np.concatenate([gallery.labels, probe.labels]))
        confusions["labels"] = vocab
    for cam_g in cameras:
        if cam_g == probe_camera:
            continue
        sel = np.where(gallery.cams == cam_g)[0]
        if len(sel) == 0:
            continue
        pred = knn_predict(probe.codes, gallery.codes[sel],
                           gallery.labels[sel], k=knn, device=device)
        accs_sub.append(rank1_accuracy(pred, probe.labels))
        acc_vid, _, _ = video_majority_vote(pred, probe.labels,
                                            probe.video_ids)
        accs_vid.append(acc_vid)
        if confusions is not None:
            confusions[f"cam_{int(cam_g)}"] = _dense_confusion(
                pred, probe.labels, vocab)
    return {"rank1_subseq": float(np.mean(accs_sub)) if accs_sub else 0.0,
            "rank1_video": float(np.mean(accs_vid)) if accs_vid else 0.0}


def _merge_codes_per_video(es: EncodedSet, use_avg: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-video merged codes + labels (mean or max pooling,
    mj_testUWYHGaitNet_open_tum.py:355-420)."""
    # one argsort + segment reductions, not a boolean mask per video
    uvids, inv = np.unique(es.video_ids, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(len(uvids)))
    c_sorted = np.asarray(es.codes)[order]
    if use_avg:
        sums = np.add.reduceat(c_sorted, starts, axis=0)
        counts = np.diff(np.append(starts, len(inv)))
        # divide in the codes' own dtype: int64 counts would promote the
        # merged gallery to float64
        codes = sums / counts[:, None].astype(c_sorted.dtype)
    else:
        codes = np.maximum.reduceat(c_sorted, starts, axis=0)
    labels = []
    l_sorted = es.labels[order]
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else len(inv)
        labs, cnt = np.unique(l_sorted[s:e], return_counts=True)
        labels.append(labs[np.argmax(cnt)])
    return codes, np.asarray(labels)


def eval_openset(gallery: EncodedSet, probe: EncodedSet, knn: int = 3,
                 use_avg: bool = True,
                 merged_gallery: Optional[Tuple[np.ndarray, np.ndarray]]
                 = None,
                 confusions: Optional[Dict] = None,
                 device: DeviceLike = None) -> Dict[str, float]:
    """TUM-style: subseq kNN + per-video vote + merged-code video kNN.

    merged_gallery: optional precomputed (codes, labels) from
    _merge_codes_per_video(gallery), so combo sweeps do not re-merge the
    same gallery per probe configuration.  confusions: pass a dict to
    collect subseq + merged-video confusion matrices.
    """
    pred = knn_predict(probe.codes, gallery.codes, gallery.labels, k=knn,
                       device=device)
    out = {"rank1_subseq": rank1_accuracy(pred, probe.labels)}
    acc_vid, _, _ = video_majority_vote(pred, probe.labels, probe.video_ids)
    out["rank1_video_vote"] = acc_vid

    gal_codes, gal_labels = (merged_gallery if merged_gallery is not None
                             else _merge_codes_per_video(gallery, use_avg))
    pr_codes, pr_labels = _merge_codes_per_video(probe, use_avg)
    pred_vid = knn_predict(pr_codes, gal_codes, gal_labels, k=knn,
                           device=device)
    out["rank1_video_merged"] = rank1_accuracy(pred_vid, pr_labels)
    if confusions is not None:
        vocab = np.unique(np.concatenate([gallery.labels, probe.labels]))
        confusions["labels"] = vocab
        confusions["subseq"] = _dense_confusion(pred, probe.labels, vocab)
        confusions["video_merged"] = _dense_confusion(pred_vid, pr_labels,
                                                      vocab)
    return out


def modality_combos(nmods: int) -> List[Tuple[float, ...]]:
    """All non-empty modality presence combinations (TUM --allcombos,
    mj_testUWYHGaitNet_open_tum.py:276-296)."""
    return [bits for bits in itertools.product([0.0, 1.0], repeat=nmods)
            if any(bits)]


def eval_all_combos(model: UGaitNet, gallery_ds: GaitDataset,
                    probe_ds: GaitDataset, modalities: Sequence[str],
                    cfg: EvalConfig, combo_gallery: bool = False,
                    use_avg: bool = True,
                    gallery_memo: Optional[Dict] = None,
                    norm_stats=None, mesh=None
                    ) -> Dict[str, Dict[str, float]]:
    """Probe every modality-presence combo (--allcombostest); optionally
    build the gallery from all combos stacked (--allcombos).

    gallery_memo: pass the same dict across calls (one per probe set) to
    encode the gallery once instead of per probe set; it is keyed on
    everything that shaped the gallery, so a changed configuration
    rebuilds it.  mesh: encode data-parallel (``encode_set``)."""
    memo_key = (gallery_ds.name, combo_gallery, use_avg, cfg.typecode,
                cfg.batch_size)
    if gallery_memo is not None and gallery_memo.get("key") == memo_key:
        gallery = gallery_memo["gallery"]
        merged_gallery = gallery_memo["merged"]
    else:
        if combo_gallery:
            parts = [encode_set(model, gallery_ds, modalities, cfg,
                                use_mods=c, norm_stats=norm_stats,
                                mesh=mesh)
                     for c in modality_combos(len(modalities))]
            gallery = EncodedSet(
                codes=np.concatenate([p.codes for p in parts]),
                labels=np.concatenate([p.labels for p in parts]),
                video_ids=np.concatenate([p.video_ids for p in parts]),
                cams=np.concatenate([p.cams for p in parts]))
        else:
            gallery = encode_set(model, gallery_ds, modalities, cfg,
                                 norm_stats=norm_stats, mesh=mesh)
        merged_gallery = _merge_codes_per_video(gallery, use_avg)
        if gallery_memo is not None:
            gallery_memo["key"] = memo_key
            gallery_memo["gallery"] = gallery
            gallery_memo["merged"] = merged_gallery
    results = {}
    for combo in modality_combos(len(modalities)):
        probe = encode_set(model, probe_ds, modalities, cfg,
                           use_mods=combo, norm_stats=norm_stats, mesh=mesh)
        name = "+".join(m for m, c in zip(modalities, combo) if c)
        results[name] = eval_openset(gallery, probe, knn=cfg.knn,
                                     use_avg=use_avg,
                                     merged_gallery=merged_gallery,
                                     device=model.device)
    return results
