"""Balanced P*K batch sampler + train/val splitting.

The port's own copy of ``ugaitnet_tpu/data/sampler.py`` (numpy only), so the port
imports nothing of the JAX package.

Re-implements, at the *index* level (bit-compatible sampling semantics, zero
data movement), the reference's class- and gait-balanced batch construction:

  * BalancedGaitSampler <- the repetitions generator's __getitem__ state
    machine ((reference) data/mj_dataGeneratorMMUWYHsingle_repetitions.py:155-182):
    round-robin over gait types for the current subject, advancing the
    subject after `repetition` pairs of records; per-(gait,subject) cyclic
    pointers; subject order reshuffled each epoch (on_epoch_end, ...single.py:272-292).
  * split_train_val_by_video <- mj_splitTrainValGaitByInfo
    (..._repetitions.py:855-889): hold out `perc` of *videos* (all their
    subsequences) for validation, keeping train/val subject-disjoint at the
    clip level but class-complete.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class BalancedGaitSampler:
    """Yields batches of record indices, gait- and subject-balanced.

    With G gait types and `repetition=R`, each visited subject contributes
    ~R*2 records (cycling over its gait types) before the sampler moves to
    the next subject; a batch of size B therefore holds ~B/(2R) subjects x 2R
    records — the P*K structure batch-all triplet mining needs.
    """

    def __init__(self, labels: np.ndarray, gaits: np.ndarray,
                 batch_size: int, repetition: int = 5, shuffle: bool = True,
                 seed: int = 0,
                 gait_groups: Optional[Sequence[int]] = None):
        self.labels = np.asarray(labels)
        self.gaits = np.asarray(gaits)
        self.batch_size = batch_size
        self.repetition = max(int(repetition), 1)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

        self.ugait = np.unique(self.gaits)
        # buildGaits remap (BothDatasets joint regime): group ids aligned
        # with the sorted unique gait codes; members of one group share a
        # single balanced slot per sampling round
        # (mj_dataGeneratorMMUWYHBothDatasets.py:80-83,133-170).
        if gait_groups is not None and len(gait_groups) != len(self.ugait):
            raise ValueError(
                f"gait_groups has {len(gait_groups)} entries but the data "
                f"has {len(self.ugait)} unique gait codes {self.ugait}")
        self.gait_groups = (None if gait_groups is None
                            else np.asarray(gait_groups))
        self.ulabs = np.unique(self.labels)
        # per-(gait, subject) record index lists
        self.gait2idx: Dict[int, Dict[int, np.ndarray]] = {}
        for g in self.ugait:
            sel_g = np.where(self.gaits == g)[0]
            self.gait2idx[int(g)] = {
                int(l): sel_g[self.labels[sel_g] == l] for l in self.ulabs}
        self.on_epoch_end()

    def __len__(self) -> int:
        return int(np.floor(len(self.labels) / self.batch_size))

    def on_epoch_end(self) -> None:
        self.gait2ptr = {int(g): {int(l): 0 for l in self.ulabs}
                         for g in self.ugait}
        self.nextlab_idx = 0
        self._used = 0
        self._used_rep = 0
        if self.shuffle:
            self.rng.shuffle(self.ulabs)

    def next_batch(self) -> np.ndarray:
        if self.gait_groups is not None:
            return self._next_batch_grouped()
        # the use counters are BATCH-LOCAL in the reference (this_lab_used /
        # this_lab_used_rep initialized at the top of every __getitem__,
        # mj_dataGeneratorMMUWYHsingle_repetitions.py:153-155) while
        # nextlab_idx / gait2ptr persist — so every batch grants the
        # current subject a fresh 2*repetition budget
        self._used = 0
        self._used_rep = 0
        out: List[int] = []
        while len(out) < self.batch_size:
            for g in self.ugait:
                if len(out) == self.batch_size:
                    continue  # guard against overflow (reference :159-160)
                g = int(g)
                lab = int(self.ulabs[self.nextlab_idx])
                recs = self.gait2idx[g][lab]
                if len(recs) > 0:
                    out.append(int(recs[self.gait2ptr[g][lab]]))
                self._used += 1
                self.gait2ptr[g][lab] += 1
                if self.gait2ptr[g][lab] >= max(len(recs), 1):
                    self.gait2ptr[g][lab] = 0
                if self._used >= 2:
                    self._used = 0
                    self._used_rep += 1
                    if self._used_rep == self.repetition:
                        self._used_rep = 0
                        self.nextlab_idx += 1
                        if self.nextlab_idx >= len(self.ulabs):
                            self.nextlab_idx = 0
        return np.asarray(out, dtype=np.int64)

    def _next_batch_grouped(self) -> np.ndarray:
        """Faithful port of the BothDatasets batch loop with buildGaits
        groups (mj_dataGeneratorMMUWYHBothDatasets.py:128-182): round-robin
        over gait positions; positions sharing a group id are balanced
        against each other (the member with the smaller count goes first,
        and when the group has kept pace with the rounds it is skipped).
        On the joint regime's label structure — each subject has records
        for only its own dataset's gait codes — empty (gait,label) cells
        stall the position while the round counter keeps advancing (the
        reference increments global_count on every pass through position
        0, including stalls), so the net effect is that merged gaits stay
        within one record of each other in every batch. The label cursor
        advances every 2 uses, the BothDatasets generator's fixed cadence
        (:170-180; that generator family has no `repetitions`)."""
        groups = self.gait_groups
        ng = len(self.ugait)
        # batch-local use counter, like the single-regime generator
        # (mj_dataGeneratorMMUWYHBothDatasets.py:130 this_lab_used = 0)
        self._used = 0
        out: List[int] = []
        count = np.zeros(ng)
        global_rounds = 0
        ind_g = 0
        guard = 0
        while len(out) < self.batch_size:
            guard += 1
            if guard > 1000 * self.batch_size:
                raise RuntimeError(
                    "grouped sampler made no progress; check gait_groups "
                    "against the data's gait codes")
            if ind_g == 0:
                global_rounds += 1
            members = np.where(groups == groups[ind_g])[0]
            if len(members) > 1:
                if count[members].sum() < global_rounds:
                    others = members[members != ind_g]
                    if np.any(count[ind_g] > count[others]):
                        ind_g = (ind_g + 1) % ng
                        continue
                else:  # group already filled this round
                    ind_g = (ind_g + 1) % ng
                    continue
            g = int(self.ugait[ind_g])
            lab = int(self.ulabs[self.nextlab_idx])
            recs = self.gait2idx[g][lab]
            if len(recs) > 0:
                out.append(int(recs[self.gait2ptr[g][lab]]))
                count[ind_g] += 1
                # ind_g advances only after a successful append; on an empty
                # (gait,label) cell the reference retries the same gait with
                # the label cursor moving on (:166-168)
                ind_g = (ind_g + 1) % ng
            self.gait2ptr[g][lab] += 1
            if self.gait2ptr[g][lab] >= max(len(recs), 1):
                self.gait2ptr[g][lab] = 0
            self._used += 1
            if self._used >= 2:
                self._used = 0
                self.nextlab_idx += 1
                if self.nextlab_idx >= len(self.ulabs):
                    self.nextlab_idx = 0
        return np.asarray(out, dtype=np.int64)

    def epoch(self) -> Iterator[np.ndarray]:
        for _ in range(len(self)):
            yield self.next_batch()
        self.on_epoch_end()


class SequentialSampler:
    """Deterministic full-coverage batches for eval (isTest=True path:
    shuffle=False, trailing partial batch included — the eval scripts iterate
    ceil(N/bs), mains/mj_testUWYHGaitNet_open_casiab.py:176-179)."""

    def __init__(self, n: int, batch_size: int):
        self.n = n
        self.batch_size = batch_size

    def __len__(self) -> int:
        return int(np.ceil(self.n / self.batch_size))

    def epoch(self) -> Iterator[np.ndarray]:
        for s in range(0, self.n, self.batch_size):
            yield np.arange(s, min(s + self.batch_size, self.n))


def split_train_val_by_video(video_ids: np.ndarray, perc: float = 0.09,
                             seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Hold out `perc` of videos (all their subsequences) for validation.

    Returns (train_indices, val_indices). Parity with
    mj_splitTrainValGaitByInfo (..._repetitions.py:855-889, perc=0.09; the
    CasiaB main uses 0.08 via its own copy).
    """
    video_ids = np.asarray(video_ids)
    uvids = np.unique(video_ids)
    rng = np.random.RandomState(seed)
    rng.shuffle(uvids)
    nval = int(perc * len(uvids))
    vids_val = set(uvids[len(uvids) - nval:].tolist())
    val_mask = np.isin(video_ids, list(vids_val))
    return np.where(~val_mask)[0], np.where(val_mask)[0]
