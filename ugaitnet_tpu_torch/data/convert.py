"""Interop: import reference-format h5 datasets; joint-dataset combination.

The port's own copy of ``ugaitnet_tpu/data/convert.py`` (numpy only), so
the port imports nothing of the JAX package.

`import_reference_dir` reads the per-sample h5 files the reference's
generate*Data.py scripts emit (deepdish layout: /data, /label, /videoId,
/gait, /cam, /compressFactor — (reference) data/generateOFData.py:136-149)
into a packed GaitDataset, so models trained here can be compared on
identical inputs.

`combine_datasets` builds the joint TUM+CASIA regime
((reference) mains/mj_trainUWYHGaitNet_DataGen_2mod_BothDatasets.py:102-170):
CASIA labels shift by +305, gaits by +3, video ids by the TUM max, and each
source dataset can carry per-dataset mean/std normalization volumes
(mj_dataGeneratorMMUWYHBothDatasets.py:89-99).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ugaitnet_tpu_torch.data.partitions import (CASIA_GAIT_OFFSET,
                                                CASIA_LABEL_OFFSET)
from ugaitnet_tpu_torch.data.schema import GaitDataset, ModalityStore


def _read_h5_sample(path: str) -> Optional[Dict[str, np.ndarray]]:
    import h5py
    out = {}
    try:
        with h5py.File(path, "r") as f:
            def get(k, default=None):
                if k in f:
                    v = f[k]
                    if hasattr(v, "shape") and v.shape == ():
                        return v[()]
                    return np.asarray(v)
                # deepdish nests under 'data' group sometimes
                if "data" in f and hasattr(f["data"], "keys") and k in f["data"]:
                    return np.asarray(f["data"][k])
                return default
            out["data"] = get("data")
            out["label"] = get("label", -1)
            out["videoId"] = get("videoId", 0)
            out["gait"] = get("gait", 0)
            out["cam"] = get("cam", 0)
            out["compressFactor"] = get("compressFactor", 1)
    except OSError:
        return None
    if out["data"] is None or np.size(out["data"]) == 0:
        return None
    return out


def import_reference_dir(datadir: str, modality: str, name: str = "",
                         ntype: int = 2) -> GaitDataset:
    """Import a directory of reference per-sample h5 volumes.

    Volumes are stored (60, 60, T*C) channel-last in the files
    (generateOFData.py:133) and transposed here to our (T*C, 60, 60) planes.
    Empty files are dropped, like the generator's pre-filter
    (mj_dataGeneratorMMUWYHsingle.py:111-131).
    """
    files = sorted(glob.glob(os.path.join(datadir, "*.h5")))
    vols, labels, vids, gaits, cams = [], [], [], [], []
    cf = 1.0
    cf_seen = {}
    for path in files:
        s = _read_h5_sample(path)
        if s is None:
            continue
        data = np.asarray(s["data"])
        if data.ndim == 3 and data.shape[0] == data.shape[1]:
            data = np.moveaxis(data, 2, 0)       # (H, W, TC) -> (TC, H, W)
        cf = float(np.asarray(s["compressFactor"]))
        cf_seen.setdefault(cf, path)
        if len(cf_seen) > 1:
            # mixed scales would silently mis-dequantize part of the store
            # (and the int16->uint8 cast would wrap negative flow values)
            pair = sorted(cf_seen.items())
            raise ValueError(
                f"{datadir}: inconsistent compressFactor across samples: "
                f"{pair[0][0]:g} ({os.path.basename(pair[0][1])}) vs "
                f"{pair[1][0]:g} ({os.path.basename(pair[1][1])}); a file "
                "missing the key reads as 1 — fix or remove it")
        vols.append(data.astype(np.int16 if cf > 1 else np.uint8))
        labels.append(int(np.asarray(s["label"])))
        vids.append(int(np.asarray(s["videoId"])))
        gaits.append(int(np.asarray(s["gait"])))
        cams.append(int(np.asarray(s["cam"])))
    if not vols:
        raise FileNotFoundError(f"no readable samples under {datadir}")
    store = ModalityStore(modality=modality, volumes=np.stack(vols),
                          compress_factor=max(cf, 1.0))
    n = len(vols)
    return GaitDataset(
        name=name or os.path.basename(datadir.rstrip("/")),
        modalities={modality: store},
        labels=np.asarray(labels, np.int32),
        video_ids=np.asarray(vids, np.int32),
        gaits=np.asarray(gaits, np.int32),
        cams=np.asarray(cams, np.int32),
        set_ids=np.ones(n, np.int32), ntype=ntype)


def combine_datasets(primary: GaitDataset, secondary: GaitDataset,
                     name: str = "joint",
                     label_offset: int = CASIA_LABEL_OFFSET,
                     gait_offset: int = CASIA_GAIT_OFFSET) -> GaitDataset:
    """Joint two-dataset training set (TUM + CASIA) with reference offsets.

    Adds a `dataset_source` column (0=primary, 1=secondary) mirroring the
    BothDatasets generator's datadir selector
    (mj_dataGeneratorMMUWYHBothDatasets.py:362-374).
    """
    if primary.ntype != secondary.ntype:
        raise ValueError(f"ntype differs: primary {primary.ntype}, "
                         f"secondary {secondary.ntype}")
    extra = set(secondary.modality_names) - set(primary.modality_names)
    if extra:
        # silently dropping a secondary-only store would surface much
        # later as a KeyError (or a quietly single-modality run)
        raise ValueError(
            f"secondary dataset has modalities {sorted(extra)} absent "
            "from the primary; the joint store keeps the primary's set — "
            "rebuild the inputs with matching modalities")
    mods = {}
    for m in primary.modality_names:
        if m not in secondary.modality_names:
            raise ValueError(f"secondary dataset missing modality {m}")
        a, b = primary.modalities[m], secondary.modalities[m]
        if a.volumes.shape[1:] != b.volumes.shape[1:]:
            raise ValueError(f"volume shapes differ for {m}")
        if a.compress_factor != b.compress_factor:
            raise ValueError(
                f"{m}: quantization scales differ (primary "
                f"{a.compress_factor:g}, secondary {b.compress_factor:g}) "
                "— the joint store keeps one compress_factor, so the "
                "secondary would dequantize wrongly; rebuild it at the "
                "primary's scale")
        mods[m] = ModalityStore(
            modality=m,
            volumes=np.concatenate([np.asarray(a.volumes),
                                    np.asarray(b.volumes)]),
            compress_factor=a.compress_factor,
            present=np.concatenate([a.present, b.present]))
    vid_off = int(primary.video_ids.max()) + 1 if len(primary) else 0
    ds = GaitDataset(
        name=name, modalities=mods,
        labels=np.concatenate([primary.labels,
                               secondary.labels + label_offset]),
        video_ids=np.concatenate([primary.video_ids,
                                  secondary.video_ids + vid_off]),
        gaits=np.concatenate([primary.gaits,
                              secondary.gaits + gait_offset]),
        cams=np.concatenate([primary.cams, secondary.cams]),
        set_ids=np.concatenate([primary.set_ids, secondary.set_ids]),
        ntype=primary.ntype)
    ds.dataset_source = np.concatenate(
        [np.zeros(len(primary), np.int32),
         np.ones(len(secondary), np.int32)])
    return ds
