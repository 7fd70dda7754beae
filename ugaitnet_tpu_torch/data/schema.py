"""Packed dataset schema.

The port's own copy of ``ugaitnet_tpu/data/schema.py`` (numpy only), so the port
imports nothing of the JAX package.

The reference stores one h5 file per 25-frame subsequence plus a global index
h5 per partition ((reference) data/generateOFData.py:136-231) and pays a
per-sample `dd.io.load` on every batch (...single.py:294-338) — the dominant
CPU cost (SURVEY.md §3.1). The TPU-native design packs each (partition,
modality) into ONE memory-mapped array of raw quantized volumes plus flat
numpy metadata columns, so a training batch is a single fancy-index gather of
contiguous rows, and all dequantization/augmentation runs on device.

Schema per modality store:
  volumes   (N, T*C, H, W)  int16 (OF, x compress_factor) or uint8
  metadata columns (shared across modalities of a partition):
  labels    (N,) int32   subject id (raw, e.g. 1..74 / 305+ for joint)
  video_ids (N,) int32   source video id (groups subsequences)
  gaits     (N,) int32   gait/condition code (nm/bg/cl or n/b/s)
  cams      (N,) int32   camera id (CASIA-B; 0 elsewhere)
  set_ids   (N,) int32   1=train 2=val split hint (reference `set`)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ugaitnet_tpu_torch.core.config import MODALITY_CHANNELS, NUM_FRAMES, FRAME_H, FRAME_W


@dataclass
class ModalityStore:
    """Raw volumes of one modality, quantized as stored on disk."""
    modality: str
    volumes: np.ndarray                  # (N, T*C, H, W) int16/uint8
    compress_factor: float = 1.0         # >1 => int16 quantized (OF x100)
    # presence mask: sample i has this modality (missing -> gated out,
    # reference marks missing pairs with -1 file ids, ...single.py:392-399)
    present: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.present is None:
            self.present = np.ones(len(self.volumes), dtype=bool)

    @property
    def channels(self) -> int:
        return MODALITY_CHANNELS[self.modality]

    def mean_volume(self) -> np.ndarray:
        """Mean raw volume over the store (data/builders.py's accumulated
        `meanSample`, (reference) data/generateOFData.py:84,144,190+),
        in raw quantized units.  Streams the mmap'd store in chunks — a
        real split is tens of GB and a single float64 copy would OOM the
        host (same rationale as pipeline.compute_normalization_stats)."""
        n = self.volumes.shape[0]
        tot = np.zeros(self.volumes.shape[1:], np.float64)
        for s in range(0, n, 512):
            tot += np.asarray(self.volumes[s:s + 512], np.float64
                              ).sum(axis=0)
        return tot / max(n, 1)


@dataclass
class GaitDataset:
    """One partition (e.g. casiab-N074-train) across modalities."""
    name: str
    modalities: Dict[str, ModalityStore]
    labels: np.ndarray
    video_ids: np.ndarray
    gaits: np.ndarray
    cams: np.ndarray
    set_ids: np.ndarray
    # ntype=2 partitions (named per-sample files) scale OF by an extra 0.1
    # (...single.py:323-324); kept per-dataset for parity.
    ntype: int = 2

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def modality_names(self) -> List[str]:
        return list(self.modalities.keys())

    def label_map(self) -> Dict[int, int]:
        """Raw subject id -> dense [0, nclasses) id, sorted ascending
        (parity with the mains' labmap construction,
        mains/mj_trainUWYHGaitNet_DataGen_CasiaB.py:408-414)."""
        return {int(l): i for i, l in enumerate(np.unique(self.labels))}

    # ---------- persistence (npz + json sidecar, mmap-friendly) ----------

    def save(self, basedir: str) -> None:
        os.makedirs(basedir, exist_ok=True)
        meta = {
            "name": self.name, "ntype": self.ntype,
            "modalities": {
                m: {"compress_factor": s.compress_factor}
                for m, s in self.modalities.items()},
        }
        with open(os.path.join(basedir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        for col in ("labels", "video_ids", "gaits", "cams", "set_ids"):
            np.save(os.path.join(basedir, f"{col}.npy"), getattr(self, col))
        # joint (BothDatasets) datasets carry a per-sample origin column
        # (combine_datasets); losing it on reload would silently disable
        # per-dataset normalization stats
        src = getattr(self, "dataset_source", None)
        if src is not None:
            np.save(os.path.join(basedir, "dataset_source.npy"), src)
        for m, s in self.modalities.items():
            np.save(os.path.join(basedir, f"volumes_{m}.npy"), s.volumes)
            np.save(os.path.join(basedir, f"present_{m}.npy"), s.present)

    @classmethod
    def load(cls, basedir: str, mmap: bool = True) -> "GaitDataset":
        with open(os.path.join(basedir, "meta.json")) as f:
            meta = json.load(f)
        mmap_mode = "r" if mmap else None
        cols = {c: np.load(os.path.join(basedir, f"{c}.npy"))
                for c in ("labels", "video_ids", "gaits", "cams", "set_ids")}
        mods = {}
        for m, info in meta["modalities"].items():
            mods[m] = ModalityStore(
                modality=m,
                volumes=np.load(os.path.join(basedir, f"volumes_{m}.npy"),
                                mmap_mode=mmap_mode),
                compress_factor=info["compress_factor"],
                present=np.load(os.path.join(basedir, f"present_{m}.npy")))
        ds = cls(name=meta["name"], modalities=mods, ntype=meta["ntype"],
                 **cols)
        src_path = os.path.join(basedir, "dataset_source.npy")
        if os.path.exists(src_path):
            ds.dataset_source = np.load(src_path)
        return ds


def empty_volume_shape(modality: str) -> tuple:
    return (NUM_FRAMES * MODALITY_CHANNELS[modality], FRAME_H, FRAME_W)
