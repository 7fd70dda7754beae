"""Verification / identification metrics.

The port's own copy of ``ugaitnet_tpu/ops/metrics.py`` (numpy only), so the port
imports nothing of the JAX package.

Parity targets:
  - EER from a ROC over (labels, -distances)
    (`mj_eerVerifDist`, (reference) nets/mj_metrics.py:10-24)
  - Rank-1 accuracy at subsequence and video level
    ((reference) mains/mj_testUWYHGaitNet_open_casiab.py:399-422)

These run on host numpy — they sit outside the hot path (the distance
matrices feeding them are computed on device, see ops/knn.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def roc_curve_scores(labels: np.ndarray, scores: np.ndarray):
    """Minimal sklearn.roc_curve equivalent (pos_label=1, drop intermediate
    points disabled): returns (fpr, tpr, thresholds) over distinct scores."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order]
    distinct = np.where(np.diff(scores))[0]
    threshold_idxs = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels == 1)[threshold_idxs].astype(np.float64)
    fps = (threshold_idxs + 1) - tps
    n_pos = (labels == 1).sum()
    n_neg = (labels != 1).sum()
    # single-class input: rates are undefined — emit nan like sklearn's
    # roc_curve (the old clamp-to-1 fabricated a confident EER of 0 or 1)
    tpr = tps / n_pos if n_pos else np.full_like(tps, np.nan)
    fpr = fps / n_neg if n_neg else np.full_like(fps, np.nan)
    thresholds = scores[threshold_idxs]
    return fpr, tpr, thresholds


def eer_verif_dist(gt_labels: np.ndarray, distances: np.ndarray) -> Tuple[float, float]:
    """EER + threshold, mj_eerVerifDist parity (ROC over negative distances)."""
    fpr, tpr, thr = roc_curve_scores(gt_labels, -np.asarray(distances))
    if np.all(np.isnan(fpr)) or np.all(np.isnan(tpr)):
        return float("nan"), float("nan")
    fnr = 1.0 - tpr
    ix = int(np.nanargmin(np.abs(fnr - fpr)))
    return float(fpr[ix]), float(-thr[ix])


def rank1_accuracy(pred_labels: np.ndarray, gt_labels: np.ndarray) -> float:
    pred_labels = np.asarray(pred_labels)
    gt_labels = np.asarray(gt_labels)
    if len(gt_labels) == 0:
        return 0.0
    return float(np.mean(pred_labels == gt_labels))


def video_majority_vote(pred_labels: np.ndarray, gt_labels: np.ndarray,
                        video_ids: Sequence) -> Tuple[float, np.ndarray, np.ndarray]:
    """Per-video majority vote over subsequence predictions
    (mj_testUWYHGaitNet_open_casiab.py:399-422). Ties resolve to the smallest
    label, like scipy.stats.mode. Returns (accuracy, per-video preds, gts)."""
    pred_labels = np.asarray(pred_labels)
    gt_labels = np.asarray(gt_labels)
    video_ids = np.asarray(video_ids)
    uvids = np.unique(video_ids)
    vid_pred = np.empty(len(uvids), dtype=pred_labels.dtype)
    vid_gt = np.empty(len(uvids), dtype=gt_labels.dtype)
    for i, v in enumerate(uvids):
        sel = video_ids == v
        labs, counts = np.unique(pred_labels[sel], return_counts=True)
        vid_pred[i] = labs[np.argmax(counts)]
        vid_gt[i] = gt_labels[sel][0]
    acc = float(np.mean(vid_pred == vid_gt)) if len(uvids) else 0.0
    return acc, vid_pred, vid_gt


def confusion_matrix(pred_labels: np.ndarray, gt_labels: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    for p, g in zip(np.asarray(pred_labels), np.asarray(gt_labels)):
        cm[int(g), int(p)] += 1
    return cm
