"""Offline dataset builders: raw videos / OF fields / silhouettes -> packed
GaitDataset.

The port's own copy of ``ugaitnet_tpu/data/builders.py`` (numpy only), so
the port imports nothing of the JAX package.

Re-implements the windowing of the reference's generate*Data.py scripts
((reference) data/generateOFData.py:61-231, generateRGBData.py,
generateDepthData.py, generateSilhouetteData.py) writing packed arrays
(data/schema.py) instead of one h5 per window:

  * windows of `n_frames` (25) consecutive tracked frames, step 5, while
    i+1+n_frames < track length (generateOFData.py:106-108);
  * frames resized to 80x60, person bounding boxes scaled accordingly;
  * horizontal recentering: the window's middle-frame bb centroid moves to
    column 30, then crop to 60x60 (generateOFData.py:131-134);
  * quantization: OF already int16 x100 (compressFactor 100); gray/depth/
    silhouette uint8 (compressFactor 0/1).

cv2 is used when available; resize/warp fall back to a numpy bilinear
implementation so builders run anywhere.
"""

from __future__ import annotations

import importlib.util
import os

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ugaitnet_tpu_torch.core.config import MODALITY_CHANNELS, NUM_FRAMES
from ugaitnet_tpu_torch.data.schema import GaitDataset, ModalityStore

# cv2 is imported where it is used: a machine without it (the card's, for
# one) takes the numpy routes, and importing this module never loads it
_HAS_CV2 = importlib.util.find_spec("cv2") is not None


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize-compatible bilinear resize (HxWx[C])."""
    if _HAS_CV2:
        import cv2
        out = cv2.resize(np.ascontiguousarray(img.astype(np.float32)),
                         (width, height), interpolation=cv2.INTER_LINEAR)
        return out
    h, w = img.shape[:2]
    ys = (np.arange(height) + 0.5) * h / height - 0.5
    xs = (np.arange(width) + 0.5) * w / width - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(int)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(int)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def hshift_crop(img: np.ndarray, shift: float, out_w: int = 60) -> np.ndarray:
    """warpAffine([[1,0,shift],[0,1,0]]) to width out_w: shift columns right
    by `shift` px (bilinear, zero fill) then crop to out_w."""
    h, w = img.shape[:2]
    xs = np.arange(out_w) - shift          # inverse map
    x0 = np.floor(xs).astype(int)
    fx = xs - x0
    x1 = x0 + 1
    valid0 = (x0 >= 0) & (x0 < w)
    valid1 = (x1 >= 0) & (x1 < w)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x1, 0, w - 1)
    im = img.astype(np.float32)
    a = im[:, x0c] * np.where(valid0, 1.0, 0.0)[None, :, None] \
        if img.ndim == 3 else im[:, x0c] * np.where(valid0, 1.0, 0.0)[None, :]
    b = im[:, x1c] * np.where(valid1, 1.0, 0.0)[None, :, None] \
        if img.ndim == 3 else im[:, x1c] * np.where(valid1, 1.0, 0.0)[None, :]
    fxb = fx[None, :, None] if img.ndim == 3 else fx[None, :]
    return a * (1 - fxb) + b * fxb


@dataclass
class TrackedVideo:
    """One source video: per-frame content + person track.

    frames: (T, H, W) or (T, H, W, C) — raw gray/depth/silhouette frames, or
            OF fields (C=2, already quantized x100 if int16).
    boxes:  (T, 4) per-frame person bb [ymin, xmin, ymax, xmax] in source px.
    frame_ids: (T,) original frame indices (defaults to arange).
    """
    frames: np.ndarray
    boxes: np.ndarray
    label: int
    gait: int
    cam: int = 0
    video_id: Optional[int] = None   # None -> assigned by build_dataset
    frame_ids: Optional[np.ndarray] = None


def extract_windows(video: TrackedVideo, modality: str,
                    n_frames: int = NUM_FRAMES, step: int = 5,
                    src_wh: Optional[Tuple[int, int]] = None
                    ) -> List[np.ndarray]:
    """Window one video into (T*C, 60, 60) plane volumes.

    Follows generateOFData.py:106-148: scale to 80x60, recenter the middle
    frame's bb centroid x to column 30, crop to 60 wide.
    """
    frames = video.frames
    # the window loop runs over the TRACK, not the raw frame array: the
    # reference iterates range(0, len(full_tracks), step) and selects
    # content frames by their recorded ids, of[full_frames[i:i+n]]
    # (generateOFData.py:106-109, generateRGBData.py:135-139).  Windowing
    # over len(frames) would pair pre-track content with track boxes (and
    # overrun the box array) whenever the track starts mid-video.
    frame_ids = (np.asarray(video.frame_ids, int)
                 if video.frame_ids is not None
                 else np.arange(len(video.boxes)))
    t_total = min(len(video.boxes), len(frame_ids))
    if len(frame_ids) and frame_ids.max() >= len(frames):
        raise ValueError(
            f"frame_ids reference frame {frame_ids.max()} but only "
            f"{len(frames)} frames were given")
    if src_wh is None:
        src_h, src_w = frames.shape[1:3]
    else:
        src_w, src_h = src_wh
    x_scale = 80.0 / src_w
    y_scale = 60.0 / src_h
    channels = MODALITY_CHANNELS[modality]

    out = []
    for i in range(0, t_total, step):
        if (i + 1 + n_frames) >= t_total:
            break
        window = frames[frame_ids[i:i + n_frames]]
        boxes = video.boxes[i + 1:i + 1 + n_frames]  # OF offset-by-1 parity
        mid = boxes[round(n_frames / 2)]
        # the reference rounds each scaled coordinate to int BEFORE the
        # centroid (generateOFData.py:117-125) — keep the same sub-pixel
        # behavior so windows resample at identical offsets
        cx = (np.round(mid[1] * x_scale) + np.round(mid[3] * x_scale)) / 2.0
        shift = 30.0 - cx

        planes = np.zeros((n_frames * channels, 60, 60), np.float32)
        for k in range(n_frames):
            resized = resize_bilinear(window[k], 80, 60)
            shifted = hshift_crop(resized, shift, 60)
            if channels == 1:
                planes[k] = shifted if shifted.ndim == 2 else shifted[..., 0]
            else:
                for c in range(channels):
                    planes[channels * k + c] = shifted[..., c]
        out.append(planes)
    return out


def build_dataset(videos: Iterable[TrackedVideo],
                  modality: str,
                  name: str,
                  n_frames: int = NUM_FRAMES,
                  step: int = 5,
                  compress_factor: Optional[float] = None,
                  ntype: int = 2,
                  val_perc: float = 0.0,
                  seed: int = 0) -> GaitDataset:
    """Build a single-modality packed dataset from tracked videos.

    val_perc > 0 assigns a stratified per-subject fraction of windows to the
    validation set (set_id 2), like the builders' `set` column
    (generateOFData.py:190-231)."""
    if compress_factor is None:
        compress_factor = 100.0 if modality == "of" else 1.0
    vols, labels, vids, gaits, cams = [], [], [], [], []
    for vix, video in enumerate(videos):
        vid = video.video_id if video.video_id is not None else (vix + 1)
        for planes in extract_windows(video, modality, n_frames, step):
            if modality == "of":
                vols.append(np.clip(planes, -32767, 32767).astype(np.int16))
            else:
                vols.append(np.clip(planes, 0, 255).astype(np.uint8))
            labels.append(video.label)
            vids.append(vid)
            gaits.append(video.gait)
            cams.append(video.cam)

    n = len(vols)
    volumes = (np.stack(vols) if n else
               np.zeros((0, n_frames * MODALITY_CHANNELS[modality], 60, 60),
                        np.int16 if modality == "of" else np.uint8))
    store = ModalityStore(modality=modality, volumes=volumes,
                          compress_factor=compress_factor)
    set_ids = np.ones(n, np.int32)
    if val_perc > 0 and n:
        rng = np.random.RandomState(seed)
        labels_arr = np.asarray(labels)
        for lab in np.unique(labels_arr):
            idx = np.where(labels_arr == lab)[0]
            rng.shuffle(idx)
            nval = int(val_perc * len(idx))
            set_ids[idx[:nval]] = 2
    return GaitDataset(
        name=name, modalities={modality: store},
        labels=np.asarray(labels, np.int32),
        video_ids=np.asarray(vids, np.int32),
        gaits=np.asarray(gaits, np.int32),
        cams=np.asarray(cams, np.int32),
        set_ids=set_ids, ntype=ntype)


def merge_modalities(datasets: Sequence[GaitDataset], name: str
                     ) -> GaitDataset:
    """Align single-modality datasets built from the same videos into one
    multimodal dataset.

    Requires sample-exact alignment (same length and video_id sequence):
    the packed stores carry no window index, so a partial overlap cannot be
    re-paired safely — rebuild the inputs from identical video/track inputs
    instead. Metadata (labels/gaits/cams/set_ids) is taken from the first
    dataset. CLI: `cli.build_data --merge DIR DIR --outdir OUT`."""
    base = datasets[0]
    n = len(base)
    for d in datasets[1:]:
        # video_ids are per-build counters, so equality alone can hold for
        # builds over *different* video sets — compare every metadata
        # column to refuse pairing sample i's volumes with sample j's label
        if (len(d) != n
                or not np.array_equal(d.video_ids, base.video_ids)
                or not np.array_equal(d.labels, base.labels)
                or not np.array_equal(d.gaits, base.gaits)
                or not np.array_equal(d.cams, base.cams)):
            raise ValueError("modality datasets are not aligned; build them "
                             "from identical video/track inputs")
        if d.ntype != base.ntype:
            raise ValueError(f"ntype differs: {base.name} {base.ntype}, "
                             f"{d.name} {d.ntype} — ntype selects the OF "
                             "dequantization scale, so one store would "
                             "decode wrongly")
    mods = {}
    for d in datasets:
        for m, store in d.modalities.items():
            if m in mods:
                raise ValueError(
                    f"duplicate modality '{m}' across inputs — merging "
                    "would silently drop one store; pass one dataset per "
                    "modality")
            mods[m] = store
    out = GaitDataset(name=name, modalities=mods, labels=base.labels,
                      video_ids=base.video_ids, gaits=base.gaits,
                      cams=base.cams, set_ids=base.set_ids,
                      ntype=base.ntype)
    src = getattr(base, "dataset_source", None)
    if src is not None:   # joint inputs: keep per-dataset norm-stats usable
        out.dataset_source = src
    return out


def load_silhouette_frames(dirpath: str, pattern: str = "*.png"
                           ) -> np.ndarray:
    """Load a directory of per-frame silhouette PNGs as (T, H, W) uint8,
    sorted by filename (generateSilhouetteData.py's cv2.imread grayscale
    loop, (reference) data/generateSilhouetteData.py:16)."""
    import glob as _glob
    files = sorted(_glob.glob(os.path.join(dirpath, pattern)))
    frames = []
    for f in files:
        if _HAS_CV2:
            import cv2
            img = cv2.imread(f, cv2.IMREAD_GRAYSCALE)
        else:
            from PIL import Image
            img = np.asarray(Image.open(f).convert("L"))
        if img is not None:
            frames.append(np.asarray(img, np.uint8))
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.uint8)


def load_video_frames(path: str, gray: bool = True) -> np.ndarray:
    """Decode an .avi/.mp4 into (T, H, W[, 3]) frames (loadVideo parity,
    (reference) data/generateRGBData.py:10-29). Requires cv2."""
    if not _HAS_CV2:
        raise RuntimeError("cv2 not available for video decode")
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if gray:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.uint8)
