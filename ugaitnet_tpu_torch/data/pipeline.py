"""Host -> device input pipeline.

Port of ``ugaitnet_tpu/data/pipeline.py``.  The host side is a thin gather
over the packed dataset (``data/schema.py``); dequantization,
normalization, joint augmentation and expand-level modality dropout run on
the device over the whole batch.

Batch layout after expansion (the reference's interleaving): rows
``[i*E .. i*E+E-1]`` are sample i's original copy followed by its
modality-dropout copies, so P*K label blocks survive.  Augmentation runs
before the expansion, so every copy of a sample shares its augmentation,
and a dropped copy's noise fill replaces the augmented volume.

``PrefetchLoader`` overlaps the host half (the native gather into
page-locked buffers) with the card's work on a producer thread; the
consumer copies to the card without blocking and preprocesses.  Batch i of
an epoch draws from ``batch_generator(seed, epoch, i)``, so its draws do not
depend on thread timing and a resumed run replays them.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import MODALITY_CHANNELS, DataConfig
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.data.native import gather_rows
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.ops import augment as A
from ugaitnet_tpu_torch.ops.preprocess import (apply_modality_dropout,
                                                clip_augment, dequant_scale,
                                                dequantize,
                                                frames_to_planes,
                                                normalize_uint8,
                                                planes_to_frames)


class HostBatch(dict):
    """Raw numpy arrays staged for one batch: per-modality uint8/int16
    volumes + present flags, plus dense labels."""


_TORCH_DTYPE = {np.dtype(t).str: getattr(torch, t)
                for t in ("uint8", "int16", "int32", "float32")}


def gather_host_batch(ds: GaitDataset, idx: np.ndarray,
                      modalities: Sequence[str],
                      labmap: Optional[Dict[int, int]] = None,
                      pin: bool = False) -> HostBatch:
    """Gather the rows ``idx`` of every modality from the memory-mapped
    stores (``data/native.py:gather_rows``).  pin: gather into page-locked
    CPU tensors, so a non-blocking copy to the card does not wait for the
    host; the arrays are numpy otherwise."""
    out = HostBatch()
    for m in modalities:
        store = ds.modalities[m]
        if pin:
            buf = torch.empty((len(idx), *store.volumes.shape[1:]),
                              dtype=_TORCH_DTYPE[store.volumes.dtype.str],
                              pin_memory=True)
            gather_rows(store.volumes, idx, out=buf.numpy())
            out[f"raw_{m}"] = buf
        else:
            out[f"raw_{m}"] = gather_rows(store.volumes, idx)
        out[f"present_{m}"] = store.present[idx].astype(np.float32)
    labels = ds.labels[idx]
    if labmap is not None:
        labels = np.asarray([labmap[int(l)] for l in labels], np.int32)
    out["labels"] = labels.astype(np.int32)
    # joint-dataset source selector (BothDatasets regime)
    src = getattr(ds, "dataset_source", None)
    out["source"] = (src[idx].astype(np.int32) if src is not None
                     else np.zeros(len(idx), np.int32))
    if pin:
        for k, v in out.items():
            if isinstance(v, np.ndarray):
                out[k] = torch.from_numpy(v).pin_memory()
    return out


def compute_normalization_stats(ds: GaitDataset, modality: str,
                                source: Optional[np.ndarray] = None
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-plane mean/std of the *normalized* volumes (the BothDatasets
    per-dataset normalization h5s, mj_dataGeneratorMMUWYHBothDatasets.py:89-99).
    Returns (mean (T*C,), std (T*C,))."""
    store = ds.modalities[modality]
    idx = (np.arange(len(ds)) if source is None
           else np.where(np.asarray(source))[0])
    # stream in chunks: a memory-mapped train split is tens of GB, and one
    # float64 copy of it would exhaust the host
    chunk = 512
    n_planes = store.volumes.shape[1]
    tot = np.zeros(n_planes, np.float64)
    tot2 = np.zeros(n_planes, np.float64)
    count = 0
    for s in range(0, len(idx), chunk):
        x = np.asarray(store.volumes[idx[s:s + chunk]], np.float64)
        if store.compress_factor > 1:
            x = x / store.compress_factor
            if ds.ntype == 2:
                x = x * 0.1
        else:
            x = x / 255.0
            if modality != "silhouette":
                x = x - 0.5
        tot += x.sum(axis=(0, 2, 3))
        tot2 += np.square(x).sum(axis=(0, 2, 3))
        count += x.shape[0] * x.shape[2] * x.shape[3]
    mean = tot / max(count, 1)
    var = np.maximum(tot2 / max(count, 1) - np.square(mean), 0.0)
    return (mean.astype(np.float32),
            np.maximum(np.sqrt(var), 1e-6).astype(np.float32))


def save_norm_stats(experdir: str, norm_stats: Dict) -> str:
    """Persist {modality: (mean, std)} standardization next to the
    experiment's checkpoints, in the JAX package's file format."""
    path = os.path.join(experdir, "norm_stats.npz")
    np.savez(path,
             **{f"mean_{m}": v[0] for m, v in norm_stats.items()},
             **{f"std_{m}": v[1] for m, v in norm_stats.items()})
    return path


def load_norm_stats(experdir: str, modalities) -> Optional[Dict]:
    """Load save_norm_stats() output; None when the experiment was trained
    without standardization."""
    path = os.path.join(experdir, "norm_stats.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    missing = [m for m in modalities
               if f"mean_{m}" not in z or f"std_{m}" not in z]
    if missing:
        raise ValueError(
            f"{path} lacks stats for modalities {missing}; it was written "
            "for a different branch set than this experiment's config")
    return {m: (z[f"mean_{m}"], z[f"std_{m}"]) for m in modalities}


def _dropout_masks(generator: Optional[torch.Generator], batch: int,
                   nmods: int, expand: int,
                   device: torch.device) -> torch.Tensor:
    """(B, E, nmods) 0/1 keep-masks for the expand copies (copy 0 = all 1).

    2 modalities (the reference's expand_level): copy 1 disables a random
    modality, copy 2 the other; copies past 3 repeat copy 1.  3+ modalities
    (__gen_batchMM): even samples disable min(ex+1, nmods-1) modalities
    drawn with replacement (a count drawn from [1, nmods) when expand is
    2); odd samples keep exactly modality (i + ex) % nmods.  Draws come
    from ``generator``, so the masks differ from the JAX package's key
    stream; pass ``masks=`` to ``preprocess_batch`` to reproduce a draw.
    """
    if expand <= 1:
        return torch.ones((batch, expand, nmods), dtype=torch.float32,
                          device=device)
    gdev = A.generator_device(generator)
    eye = torch.eye(nmods, dtype=torch.float32)
    ones = torch.ones((batch, nmods), dtype=torch.float32)
    if nmods == 2:
        choice = (torch.rand(batch, generator=generator, device=gdev)
                  < 0.5).long().cpu()
        copies = [ones, 1.0 - eye[choice]]
        if expand > 2:
            copies.append(1.0 - eye[1 - choice])
        while len(copies) < expand:
            copies.append(copies[1])
        return torch.stack(copies, dim=1).to(device, non_blocking=True)

    rows = torch.arange(batch)
    even = (rows % 2 == 0)[:, None]
    copies = [ones]
    for ex in range(expand - 1):
        if expand > 2:
            ndis = torch.full((batch,), min(ex + 1, nmods - 1))
        else:
            ndis = torch.randint(1, nmods, (batch,), generator=generator,
                                 device=gdev).cpu()
        picks = torch.randint(nmods, (batch, nmods - 1), generator=generator,
                              device=gdev).cpu()
        mask_even = ones
        for d in range(nmods - 1):
            active = (d < ndis).to(torch.float32)[:, None]
            mask_even = mask_even * ((1.0 - eye[picks[:, d]]) * active
                                     + (1.0 - active))
        mask_odd = eye[(rows + ex) % nmods]
        copies.append(torch.where(even, mask_even, mask_odd))
    return torch.stack(copies, dim=1).to(device, non_blocking=True)


def _expand_rows(x: torch.Tensor, expand: int) -> torch.Tensor:
    """Repeat each row E times, interleaved: (B, ...) -> (B*E, ...)."""
    return torch.repeat_interleave(x, expand, dim=0)


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    """v on ``device``.  A writable C-contiguous array (a fresh gather) is
    taken as it is; a read-only or strided one (a memmap, a view) is copied
    once.  Copies to the card do not block the host: from page-locked memory
    they are asynchronous, from pageable memory CUDA stages them first."""
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        if not (a.flags["C_CONTIGUOUS"] and a.flags["WRITEABLE"]):
            a = np.array(a, copy=True, order="C")
        v = torch.from_numpy(a)
    return v.to(device, non_blocking=True)


def _transform_params(params: Optional[Sequence[A.TransformParams]],
                      generator: Optional[torch.Generator], batch: int,
                      modalities: Tuple[str, ...], cfg: DataConfig,
                      device: torch.device) -> List[A.TransformParams]:
    """One affine/flip draw per sample, shared across modalities (the
    reference copies tx/ty and flip between modality transforms,
    ...single.py:401-410); zoom and photometric params per modality, with
    OF photometric off.  Given ``params`` (one per modality) are shared the
    same way, so the JAX package's per-modality draws reproduce its batch."""
    if params is None:
        params = [A.random_transform_params(
            generator, batch, shift_choices=cfg.shift_range,
            zoom_range=cfg.zoom_range, brightness_range=cfg.brightness_range,
            channel_shift_range=cfg.channel_shift_range,
            photometric=(m != "of"), device=device) for m in modalities]
    params = [A.TransformParams(*(_as_tensor(v, device) for v in p))
              for p in params]
    base = params[0]
    return [p._replace(apply=base.apply, tx=base.tx, ty=base.ty,
                       flip=base.flip) for p in params]


def preprocess_batch(raw: Dict[str, object], modalities: Tuple[str, ...],
                     channels: Tuple[int, ...],
                     compress_factors: Tuple[float, ...], ntype: int,
                     expand: int, augmenting: bool, cfg: DataConfig,
                     normalize: bool = False,
                     masks: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[Sequence[A.TransformParams]] = None,
                     device: DeviceLike = None
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                torch.Tensor]:
    """dequant -> augment -> expand + modality dropout, on ``device``.

    raw: ``raw_<m>`` (B, T*C, H, W) int16/uint8, ``present_<m>`` (B,),
    ``labels`` (B,), and with ``normalize`` also ``source`` (B,) and
    ``norm_mean_<m>`` / ``norm_std_<m>`` (n_sources, T*C); numpy arrays or
    tensors.  masks: optional (B, E, nmods) keep-masks; params: optional
    per-modality ``TransformParams`` (used when ``augmenting``); both are
    drawn from ``generator`` when not given.

    Returns (volumes[(B*E, T, H, W, C_m)], use_flags[(B*E,)], labels (B*E,)).
    """
    dev = resolve_device(device)
    labels = _as_tensor(raw["labels"], dev)
    batch = labels.shape[0]
    if augmenting:
        params = _transform_params(params, generator, batch, modalities, cfg,
                                   dev)
        # one per-sample OF clip coin (...single.py:412-417)
        clip_coin = params[0].clip_of.reshape(-1, 1, 1, 1)

    volumes, use_flags = [], []
    for mi, m in enumerate(modalities):
        x = _as_tensor(raw[f"raw_{m}"], dev)
        quantized = compress_factors[mi] > 1.0
        if quantized and augmenting and cfg.of_clip_max > 0:
            # the clip augment acts on the raw values, before dequantizing
            x = x.to(torch.float32)
            x = torch.where(clip_coin, clip_augment(x, cfg.of_clip_max,
                                                    cfg.of_clip_min), x)
        if normalize:
            # per-dataset per-plane standardization (BothDatasets regime)
            src = _as_tensor(raw["source"], dev).long()
            mean = _as_tensor(raw[f"norm_mean_{m}"], dev)[src][:, :, None, None]
            std = _as_tensor(raw[f"norm_std_{m}"], dev)[src][:, :, None, None]
        if quantized and normalize:
            # one rounding for x * scale - mean, as XLA's fused multiply-add
            # (float64 holds the float32 product exactly)
            scale = dequant_scale(compress_factors[mi], ntype)
            x = (x.to(torch.float64) * scale - mean.to(torch.float64)
                 ).to(torch.float32)
        elif quantized:
            x = dequantize(x, compress_factors[mi], ntype)
        else:
            x = normalize_uint8(x, silhouette=(m == "silhouette"))
            if normalize:
                x = x - mean
        if normalize:
            x = x / std
        if augmenting:
            x = frames_to_planes(A.augment_batch(
                planes_to_frames(x, channels[mi]), params[mi],
                is_of=(m == "of")))
        volumes.append(x)
        use_flags.append(_as_tensor(raw[f"present_{m}"], dev)
                         .to(torch.float32))

    if masks is None:
        masks = _dropout_masks(generator, batch, len(modalities), expand, dev)
    else:
        masks = _as_tensor(masks, dev).to(torch.float32)
    out_vols, out_flags = [], []
    for mi in range(len(modalities)):
        u = _expand_rows(use_flags[mi], expand) * masks[:, :, mi].reshape(-1)
        v = apply_modality_dropout(_expand_rows(volumes[mi], expand), u,
                                   cfg.noise)
        # frames last: a view that keeps the plane order in memory, which
        # is the per-frame NCHW layout the GaitSet convolutions read
        out_vols.append(planes_to_frames(v, channels[mi]))
        out_flags.append(u)
    return out_vols, out_flags, _expand_rows(labels, expand)


class GaitPipeline:
    """Sampler indices -> device-ready batches."""

    def __init__(self, ds: GaitDataset, cfg: DataConfig,
                 modalities: Sequence[str],
                 labmap: Optional[Dict[int, int]] = None,
                 indices: Optional[np.ndarray] = None,
                 augment: Optional[bool] = None,
                 norm_stats: Optional[Dict[str, Tuple[np.ndarray,
                                                      np.ndarray]]] = None,
                 device: DeviceLike = None):
        self.ds = ds
        self.cfg = cfg
        self.modalities = tuple(modalities)
        self.labmap = labmap
        self.indices = (np.arange(len(ds)) if indices is None
                        else np.asarray(indices))
        self.channels = tuple(MODALITY_CHANNELS[m] for m in modalities)
        self.compress_factors = tuple(
            float(ds.modalities[m].compress_factor) for m in modalities)
        self.augmenting = cfg.augment if augment is None else augment
        # norm_stats[m] = (means (S, T*C), stds (S, T*C)) per dataset source
        self.norm_stats = norm_stats
        self.device = resolve_device(device)

    def gather(self, batch_idx: np.ndarray) -> HostBatch:
        """The host half of ``load``: the raw rows of ``batch_idx`` (indices
        into this pipeline's view, self.indices), page-locked when the
        pipeline's device is a card.  Safe on a worker thread."""
        raw = gather_host_batch(self.ds, self.indices[batch_idx],
                                self.modalities, self.labmap,
                                pin=self.device.type == "cuda")
        if self.norm_stats is not None:
            # np.asarray: on a card the source column is a page-locked
            # tensor, and np.max passes `initial` on to Tensor.max
            src_max = int(np.max(np.asarray(raw["source"]), initial=0))
            for m in self.modalities:
                mean, std = self.norm_stats[m]
                mean2 = np.atleast_2d(mean).astype(np.float32)
                if src_max >= mean2.shape[0]:
                    # an out-of-range source row would standardize one
                    # dataset with another's statistics
                    raise ValueError(
                        f"norm_stats[{m!r}] has {mean2.shape[0]} source "
                        f"row(s) but the batch contains dataset_source="
                        f"{src_max}; pass one (mean, std) row per dataset")
                raw[f"norm_mean_{m}"] = mean2
                raw[f"norm_std_{m}"] = np.atleast_2d(std).astype(np.float32)
        return raw

    def preprocess(self, raw: HostBatch,
                   generator: Optional[torch.Generator] = None,
                   expand: Optional[int] = None):
        """The device half of ``load``: copy to the device and preprocess;
        augmentation and dropout masks draw from ``generator``."""
        e = self.cfg.expand_level if expand is None else expand
        return preprocess_batch(
            raw, self.modalities, self.channels, self.compress_factors,
            self.ds.ntype, e, self.augmenting, self.cfg,
            normalize=self.norm_stats is not None, generator=generator,
            device=self.device)

    def load(self, batch_idx: np.ndarray,
             generator: Optional[torch.Generator] = None,
             expand: Optional[int] = None):
        """batch_idx indexes into this pipeline's view (self.indices);
        augmentation and dropout masks draw from ``generator``."""
        return self.preprocess(self.gather(batch_idx), generator, expand)


def batch_generator(seed: int, epoch: int, index: int) -> torch.Generator:
    """The CPU generator batch ``index`` of ``epoch`` draws its augmentation
    and dropout masks from.  Seeded from (seed, epoch, index) alone, so the
    draws do not depend on which thread gathered the batch, or when, and a
    resumed run replays them (the JAX trainer folds the batch index into a
    key made from hash((seed, epoch)))."""
    return torch.Generator().manual_seed(hash((seed, epoch, index)) % 2 ** 63)


# batches gathered ahead of the one being preprocessed: one overlaps the
# card's step, the second absorbs a slow gather
PREFETCH_DEPTH = 2


class PrefetchLoader:
    """One epoch of ``sampler`` through ``pipe``, the host gathers running
    ahead on a producer thread.

    The producer only gathers (``GaitPipeline.gather``: the native gather
    releases the GIL, and on a card it fills page-locked buffers), at most
    ``PREFETCH_DEPTH`` batches ahead.  The consumer, the caller's thread,
    copies each batch to the device and preprocesses it with
    ``batch_generator(seed, epoch, i)``, so no card work runs on the
    producer.  An exception in the producer is raised in the consumer;
    ``close()`` (also run when the consumer stops early) releases the
    producer and waits for it.
    """

    def __init__(self, pipe: GaitPipeline, sampler, seed: int, epoch: int):
        self.pipe = pipe
        self.seed, self.epoch = seed, epoch
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._n = len(sampler)

        def producer():
            # any exception must reach the consumer: a silently dead
            # producer would leave __iter__ parked in q.get() forever
            try:
                for i, idx in enumerate(sampler.epoch()):
                    if (self._stop.is_set()
                            or not self._put((i, pipe.gather(idx)))):
                        return
            except BaseException as e:   # noqa: BLE001 - raised in __iter__
                self._put(e)
                return
            self._put(None)

        self._t = threading.Thread(target=producer, daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue  # re-check the stop flag so close() can unblock us
        return False

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                i, raw = item
                yield self.pipe.preprocess(
                    raw, batch_generator(self.seed, self.epoch, i))
        finally:
            self.close()

    def __len__(self):
        return self._n

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the producer advances the sampler: wait for it (it stops within
        # one gather), so the next epoch never shares the sampler with it
        self._t.join()
