"""Dataset metadata loaders and per-subject split helpers.

The port's own copy of ``ugaitnet_tpu/data/dataset_info.py`` (numpy only), so
the port imports nothing of the JAX package.

Clean-room equivalents of the reference's info-file utilities:
  * TumGaidMetadata <- TUMGAIDdb ((reference) data/mj_tumgaid.py:7-106):
    subject-id list files (tumgaidtrainids/valids/testids.lst) and the
    per-subject gender/age/shoe attribute files.
  * split_train_val_by_subject <- mj_splitTrainValGait
    ((reference) data/mj_utils.py:9-57): holds out the last
    `perc`-fraction samples of EVERY subject for validation (class-complete
    split, unlike the video-level split in data/sampler.py).
  * load_groups_file <- mj_load_groups_file (mj_utils.py:96-104).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


class TumGaidMetadata:
    """TUM-GAID label-dir metadata: id lists + gender/age/shoe attributes."""

    def __init__(self, basedir: str):
        self.basedir = basedir
        self.train = self._load_list("tumgaidtrainids.lst")
        self.val = self._load_list("tumgaidvalids.lst")
        self.test = self._load_list("tumgaidtestids.lst")
        self._gender: Optional[List[str]] = None
        self._age: Optional[List[str]] = None
        self._shoe: Optional[List[str]] = None

    def _load_list(self, name: str) -> List[int]:
        path = os.path.join(self.basedir, name)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [int(tok) for tok in f.read().split()]

    def _load_attr(self, name: str) -> List[str]:
        with open(os.path.join(self.basedir, name)) as f:
            return f.read().split()

    def gender(self, label: int) -> str:
        if self._gender is None:
            self._gender = self._load_attr("allgender.txt")
        return self._gender[label]

    def age(self, label: int) -> str:
        if self._age is None:
            self._age = self._load_attr("allage.txt")
        return self._age[label]

    def shoe(self, label: int) -> str:
        if self._shoe is None:
            self._shoe = self._load_attr("allshoetype.txt")
        return self._shoe[label]

    def split_indices(self, labels: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(train_idx, val_idx, test_idx) selecting samples whose subject id
        appears in the respective id list (get_train_val_samples_from_dbinfo
        parity)."""
        labels = np.asarray(labels)
        out = []
        for ids in (self.train, self.val, self.test):
            mask = np.isin(labels, np.asarray(ids, labels.dtype))
            out.append(np.where(mask)[0])
        return tuple(out)


def split_train_val_by_subject(labels: np.ndarray, perc: float = 0.1
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-subject tail holdout (mj_splitTrainValGait parity): the last
    nval_ps = perc*N/nclasses records of EVERY subject go to validation.

    Reference quirk kept as-is (utils/mj_utils.py:40-52): nval_ps is a
    GLOBAL average, so a subject with fewer than nval_ps records loses all
    of them to validation (cut goes negative) — heavily imbalanced label
    sets can end up with zero training samples for small classes.  Prefer
    split_train_val_by_video for real runs."""
    labels = np.asarray(labels)
    ulabels = np.unique(labels)
    nval_ps = int(perc * len(labels) / max(len(ulabels), 1))
    idx_tr, idx_val = [], []
    for lab in ulabels:
        idx = list(np.where(labels == lab)[0])
        cut = len(idx) - nval_ps
        idx_tr += idx[:cut]
        idx_val += idx[cut:]
    return np.asarray(idx_tr, np.int64), np.asarray(idx_val, np.int64)


def load_groups_file(filepath: str) -> Dict[int, List[int]]:
    """Parse 'group member member ...' lines (mj_load_groups_file parity)."""
    groups: Dict[int, List[int]] = {}
    with open(filepath) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            groups[int(toks[0])] = [int(t) for t in toks[1:]]
    return groups
