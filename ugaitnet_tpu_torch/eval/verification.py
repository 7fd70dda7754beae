"""Online verification metrics for validation during training.

The port's own copy of ``ugaitnet_tpu/eval/verification.py`` (numpy only), so the port
imports nothing of the JAX package.

Equivalent of `mj_computeDistMetrics`
((reference) mains/mj_trainUWYHGaitNet_DataGen_CasiaB.py:91-166, used per
save-chunk by the TUM mains): per batch, build one positive pair and
`negs_per_label` negative pairs for every class present, measure L2 distances
between codes, then compute EER + chance over all pairs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ugaitnet_tpu_torch.ops.metrics import eer_verif_dist


def pair_distances(codes: np.ndarray, labels: np.ndarray,
                   negs_per_label: int = 3, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (pair_labels {1 pos, 0 neg}, distances)."""
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    gt, dists = [], []
    for u in np.unique(labels):
        pos = np.where(labels == u)[0]
        neg = np.where(labels != u)[0]
        rng.shuffle(pos)
        rng.shuffle(neg)
        if len(pos) > 1:
            gt.append(1)
            dists.append(np.linalg.norm(codes[pos[0]] - codes[pos[1]]))
        # min(), not a >= gate: on a tiny split (complement smaller than
        # negs_per_label) the gate built ZERO negative pairs and the EER
        # came back nan even though real negative pairs exist
        if len(pos) > 0:
            for t in range(min(negs_per_label, len(neg))):
                gt.append(0)
                dists.append(np.linalg.norm(codes[pos[0]] - codes[neg[t]]))
    return np.asarray(gt), np.asarray(dists)


def verification_eer(codes: np.ndarray, labels: np.ndarray,
                     negs_per_label: int = 3, seed: int = 0
                     ) -> Dict[str, float]:
    gt, dists = pair_distances(codes, labels, negs_per_label, seed)
    if len(np.unique(gt)) < 2:
        # one-sided pair set (e.g. a val split with no repeated subject, so
        # no positive pairs): the EER is UNDEFINED — report nan like
        # roc_curve_scores does for single-class input rather than a
        # fabricated worst-case 1.0.  chance (fraction of positive pairs)
        # is still real data.
        chance = float(np.sum(gt > 0) / len(gt)) if len(gt) else 0.0
        return {"eer": float("nan"), "eer_threshold": float("nan"),
                "chance": chance}
    eer, thr = eer_verif_dist(gt, dists)
    chance = float(np.sum(gt > 0) / len(gt))
    return {"eer": eer, "eer_threshold": thr, "chance": chance}
