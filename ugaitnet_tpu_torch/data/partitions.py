"""Dataset partition catalog: CASIA-B, TUM-GAID, OU-MVLP.

The port's own copy of ``ugaitnet_tpu/data/partitions.py`` (numpy only), so
the port imports nothing of the JAX package.

Clean-room equivalent of `getPartitions`
((reference) data/datasetInfo.py:5-310): for each (dataset, split) the
well-known subject ids, walking conditions, camera set, and native video
resolution used by the offline builders. These are dataset facts (published
protocols), encoded as data.

CASIA-B (124 subjects, 11 views):
  train split: subjects 1..74; gallery/"ft" + probes: subjects 75..124.
  conditions: nm-01..06 (normal), bg-01..02 (bag), cl-01..02 (coat);
  cameras 000..180 step 18. Standard protocol: gallery nm-01..04,
  probes nm-05..06 / bg-01..02 / cl-01..02.

TUM-GAID (305 subjects):
  150 train / 155 test; conditions n01..n06 (normal), b01..b02 (backpack),
  s01..s02 (shoes); "elapsed time" recordings n07..n12 for a 32-subject
  subset. Subject lists ship as label files; ids here are 1..305 with the
  standard 150/155 split order.

OU-MVLP: 10307 subjects, 14 views; only offline preprocessing existed in
the reference (no training main), mirrored here for completeness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

GAIT_CODES = {"nm": 0, "bg": 1, "cl": 2,   # CASIA-B
              "n": 0, "b": 1, "s": 2}       # TUM-GAID


@dataclass(frozen=True)
class PartitionSpec:
    dataset: str
    split: str                    # train | ft | test
    subject_ids: Tuple[int, ...]
    conditions: Tuple[str, ...]   # e.g. "nm-01", "b01"
    cameras: Tuple[int, ...]      # empty = single fixed camera
    im_width: int
    im_height: int

    @property
    def gait_of(self) -> Dict[str, int]:
        # OU-MVLP conditions are bare sequence numbers ("00", "01") with a
        # single walking condition — gait 1 like the reference's gaits
        # list (datasetInfo.py:274-276); named conditions strip to their
        # code prefix
        out = {}
        for c in self.conditions:
            key = c.rstrip("0123456789-").rstrip("-")
            out[c] = GAIT_CODES[key] if key else 1
        return out


CASIAB_CAMERAS = tuple(range(0, 181, 18))
CASIAB_ALL_CONDITIONS = tuple(
    [f"nm-{i:02d}" for i in range(1, 7)]
    + [f"bg-{i:02d}" for i in range(1, 3)]
    + [f"cl-{i:02d}" for i in range(1, 3)])

TUM_CONDITIONS = tuple([f"n{i:02d}" for i in range(1, 7)]
                       + [f"b{i:02d}" for i in range(1, 3)]
                       + [f"s{i:02d}" for i in range(1, 3)])
TUM_ELAPSED_CONDITIONS = tuple([f"n{i:02d}" for i in range(7, 13)])


def get_partition(dataset: str, split: str,
                  subject_ids: Optional[Sequence[int]] = None
                  ) -> PartitionSpec:
    dataset = dataset.lower()
    if dataset in ("casiab", "casia_b"):
        if split == "train":
            ids = tuple(range(1, 75))
            conds = CASIAB_ALL_CONDITIONS
        elif split == "ft":            # gallery: test subjects, nm-01..04
            ids = tuple(range(75, 125))
            conds = tuple(f"nm-{i:02d}" for i in range(1, 5))
        elif split.startswith("test"):  # probes: nm-05..06 / bg / cl
            ids = tuple(range(75, 125))
            cond_map = {"test": ("nm-05", "nm-06"),   # bare = nm probes
                        "test_nm": ("nm-05", "nm-06"),
                        "test_bg": ("bg-01", "bg-02"),
                        "test_cl": ("cl-01", "cl-02")}
            if split not in cond_map:
                # a typo like "test-cl" must not silently run the nm
                # probes and label the number as a cl result
                raise ValueError(f"unknown casiab split {split}; "
                                 f"expected one of {sorted(cond_map)}")
            conds = cond_map[split]
        else:
            raise ValueError(f"unknown casiab split {split}")
        return PartitionSpec("casiab", split, ids, conds, CASIAB_CAMERAS,
                             320, 240)

    if dataset in ("tum_gaid", "tumgaid", "tum"):
        if split == "train":
            ids = tuple(range(1, 151))
            conds = TUM_CONDITIONS
        elif split == "ft":
            ids = tuple(range(151, 306))
            conds = tuple(c for c in TUM_CONDITIONS
                          if c.startswith("n") and c <= "n04")
        elif split == "test":
            ids = tuple(range(151, 306))
            conds = TUM_CONDITIONS
        elif split == "elapsed":
            ids = tuple(range(151, 306))
            conds = TUM_ELAPSED_CONDITIONS
        else:
            raise ValueError(f"unknown tum split {split}")
        return PartitionSpec("tum_gaid", split, ids, conds, (), 640, 480)

    if dataset in ("oumvlp", "ou-mvlp", "ou_mvlp"):
        cams = tuple(list(range(0, 91, 15)) + list(range(180, 271, 15)))
        # the reference splits OU-MVLP subjects by the dataset's official
        # ID_list_train.txt / ID_list_test.txt (5153 / 5154 subjects,
        # datasetInfo.py:260-285) — files that ship with OU-MVLP, not with
        # this repo.  Pass their contents via subject_ids; returning all
        # 10307 ids for a train/ft split would silently mix gallery and
        # training subjects.
        if split in ("train", "ft") and subject_ids is None:
            raise ValueError(
                "OU-MVLP train/ft splits need subject_ids from the "
                "dataset's ID_list_train.txt / ID_list_test.txt "
                "(5153/5154 subjects, reference datasetInfo.py:260-285)")
        ids = tuple(subject_ids) if subject_ids is not None else tuple(
            range(1, 10308))
        # reference patterns: train uses both sequences, ft '-01-'
        # (gallery), test '-00-' (probes) — datasetInfo.py:270-303
        conds = {"train": ("00", "01"), "ft": ("01",)}.get(split, ("00",))
        # native resolution per the reference: 1280x960 (datasetInfo.py:252-253)
        return PartitionSpec("oumvlp", split, ids, conds, cams,
                             1280, 960)

    raise ValueError(f"unknown dataset {dataset}")


# Joint TUM+CASIA regime offsets (BothDatasets mains,
# (reference) mains/mj_trainUWYHGaitNet_DataGen_2mod_BothDatasets.py:114-138):
CASIA_LABEL_OFFSET = 305
CASIA_GAIT_OFFSET = 3
