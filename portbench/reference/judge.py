"""The numbers that decide ``correct``: what the program produced, read
against the plain reference's values.  Each function returns readings;
the limits are the configuration file's."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's |prog norm - ref norm|, over the larger of the
    leaf's own reference norm and the median leaf's."""
    leaves = list(ref if leaves is None else leaves)
    med = statistics.median(ref[k] for k in leaves)
    worst, name = 0.0, ""
    for k in leaves:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
        if gap >= worst:
            worst, name = gap, k
    return worst, name


def moved_leaves(ref_grads: Dict[str, float]) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's.  The others (a bias under a
    normalization, say) move under Adam by round-off alone."""
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= 1e-3 * med]


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Iterable[str]) -> float:
    """The median leaf's gap, each leaf's as in ``norm_gap``."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return statistics.median(abs(prog.get(k, 0.0) - ref[k])
                             / max(ref[k], med, 1e-30) for k in leaves)


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number a train cell may compare; a cell's ``limits`` name
    the ones it does.  ``loss_gap``: the worst checked step's relative loss
    gap, ``loss_gap_first`` the first step's; ``grad_gap`` and
    ``change_gap``: the worst leaf's; ``change_gap_median``: the median
    leaf's change."""
    steps = [abs(p - r) / abs(r)
             for p, r in zip(prog["losses"], ref["losses"])]
    grad_gap, _ = norm_gap(prog["grad_norms"], ref["grad_norms"])
    moved = moved_leaves(ref["grad_norms"])
    change_gap, _ = norm_gap(prog["change"], ref["change"], moved)
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "grad_gap": grad_gap, "change_gap": change_gap,
            "change_gap_median": median_gap(prog["change"], ref["change"],
                                            moved)}


def merged_error(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: torch.Tensor, tie: float) -> torch.Tensor:
    """Per-row relative error of sign_max-merged, L2-scaled codes (B, P*D)
    against the reference's branch embeddings a, b (B, P, D) and its L2
    factor.  Where |a| and |b| lie within ``tie`` of each other, rounding
    may pick either branch, and the code is held to the nearer of the two
    candidates; elsewhere to the reference's pick."""
    a, b = (a * scale).flatten(1), (b * scale).flatten(1)
    codes = codes.to(a.dtype).flatten(1)
    pick = torch.where(a.abs() >= b.abs(), a, b)
    near = (a.abs() - b.abs()).abs() <= tie * torch.maximum(a.abs(),
                                                            b.abs())
    err = torch.where(near, torch.minimum((codes - a).abs(),
                                          (codes - b).abs()),
                      (codes - pick).abs())
    return err.norm(dim=1) / pick.norm(dim=1).clamp_min(1e-30)


def sampler_faults(epochs, labels, gaits, batch: int,
                   repetition: int) -> int:
    """Batches of the train sampler that break its documented P x K design
    (``data/sampler.py:BalancedGaitSampler``), checked from the indices
    alone against the benchmark's own label and gait columns: every batch
    holds ``batch`` distinct rows of the data set; each subject visited
    gives 2 x ``repetition`` consecutive round-robin draws over the gait
    types, so a batch holds that many rows of each subject (the last
    subject takes the rest where it does not divide, and its visit goes on
    at the next batch's start), spread over the gait types within one of
    each other (every subject here has every gait type); and within an
    epoch the subjects are visited in turn, so no subject of the data set
    gets two visits more than another.  ``epochs`` is a list of epochs,
    each a list of index arrays."""
    labels, gaits = np.asarray(labels), np.asarray(gaits)
    n, visit = len(labels), 2 * repetition
    want = sorted([visit] * (batch // visit)
                  + ([batch % visit] if batch % visit else []))
    ulabels, ugaits = np.unique(labels), np.unique(gaits)
    faults = 0
    for batches in epochs:
        visits = dict.fromkeys(ulabels.tolist(), 0)
        last = None
        for idx in batches:
            idx = np.asarray(idx)
            if (len(idx) != batch or len(np.unique(idx)) != len(idx)
                    or idx.min() < 0 or idx.max() >= n):
                faults += 1
                last = None
                continue
            labs = labels[idx]
            subjects, counts = np.unique(labs, return_counts=True)
            spread = [np.bincount(np.searchsorted(ugaits,
                                                  gaits[idx[labs == s]]),
                                  minlength=len(ugaits))
                      for s in subjects]
            if (sorted(counts.tolist()) != want
                    or any(c.max() - c.min() > 1 for c in spread)):
                faults += 1
            for s in subjects.tolist():
                visits[s] += 1
            if last is not None and labs[0] == last:
                visits[int(last)] -= 1      # the same visit, carried on
            last = labs[-1]
        if batches and max(visits.values()) - min(visits.values()) > 1:
            faults += 1
    return faults
