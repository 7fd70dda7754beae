"""Serving: identification against a gallery held on the device.

Port of ``ugaitnet_tpu/eval/serving.py`` for float32 galleries on one
device.  The gallery code matrix lives on the card; one call takes raw
quantized clip volumes -> dequantize -> embed -> distance matmul -> top-k
vote and returns labels + neighbor distances.  Query batches are padded to
fixed bucket sizes, so every query of a bucket runs the same shapes.

Incremental enrollment: the gallery lives in capacity-padded device buffers
(power-of-two row and class capacities) with a (capacity,) float32 distance
bias marking dead slots (+1e12, never in a top-k while k <= live rows).
``enroll`` writes the new rows in place into the card's buffer (only they
cross host -> device) and ``remove`` tombstones rows by flipping bias
entries; buffers are rebuilt only when a capacity doubles.  A host master
copy stays row-aligned with the card's buffer, so a large gallery costs
host memory too.

Not ported yet (ROADMAP.md §1 item 9): ``quantized=True`` (int8 encode,
``ops/quantize.py``), ``gallery_dtype="int8"`` and ``mesh=`` (row-sharded
galleries) raise ``NotImplementedError``; ``torch.export`` of the encoder
comes with the export slice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import (FRAME_H, FRAME_W,
                                            MODALITY_CHANNELS, NUM_FRAMES,
                                            DataConfig)
from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.eval.encode import _tap
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops.knn import (nearest, pairwise_l2, squared_norms,
                                        vote)
from ugaitnet_tpu_torch.ops.metrics import eer_verif_dist

_ROADMAP = "(ROADMAP.md §1 item 9, serving and export)"


def _next_pow2(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the gallery/class capacity
    quantum, so buffers are rebuilt log2(final gallery size) times."""
    return 1 << max(floor - 1, n - 1).bit_length()


def _raw_specs(modalities, channels, compress_factors, batch: int,
               with_source: bool = False
               ) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """(shape, dtype) of each entry of the service's raw feed at one bucket
    size (the port's copy of ``ugaitnet_tpu/eval/export.py:_raw_specs``):
    interleaved quantized planes (B, T*C, H, W) per modality, int16 where
    the quantization factor is > 1 and uint8 otherwise, presence flags,
    labels, and the dataset source where standardization needs it."""
    spec = {}
    for m, c, f in zip(modalities, channels, compress_factors):
        spec[f"raw_{m}"] = ((batch, NUM_FRAMES * c, FRAME_H, FRAME_W),
                            np.dtype(np.int16 if f > 1 else np.uint8))
        spec[f"present_{m}"] = ((batch,), np.dtype(np.float32))
    spec["labels"] = ((batch,), np.dtype(np.int32))
    if with_source:
        spec["source"] = ((batch,), np.dtype(np.int32))
    return spec


class SignatureService:
    """Encode + identify against a gallery on the model's device.

    Usage:
        svc = SignatureService(model, ("of", "gray"))
        svc.set_gallery(codes, labels)          # or build_gallery(dataset)
        labels, dists = svc.identify_raw({"raw_of": ..., "raw_gray": ...})
    """

    def __init__(self, model: UGaitNet, modalities: Sequence[str],
                 typecode: int = 3, knn: int = 3, ntype: int = 2,
                 compress_factors: Optional[Sequence[float]] = None,
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 quantized: bool = False,
                 norm_stats: Optional[Dict] = None,
                 gallery_dtype: str = "float32",
                 mesh=None):
        if quantized:
            raise NotImplementedError(
                f"quantized=True (int8 encode) is not ported yet {_ROADMAP}")
        if gallery_dtype == "int8":
            raise NotImplementedError(
                f"the int8 gallery is not ported yet {_ROADMAP}")
        if gallery_dtype != "float32":
            raise ValueError(f"gallery_dtype must be float32 or int8, "
                             f"got {gallery_dtype!r}")
        if mesh is not None:
            raise NotImplementedError(
                f"mesh serving is not ported yet {_ROADMAP}")
        # The reference-parity signature normalizes over the BATCH axis
        # (l2_mode="reference"), so codes would depend on what else is in
        # the batch.  Serve with the per-sample normalization instead: it
        # has no parameters, and a shallow copy of the module shares the
        # weights.  Gallery and probes go through this same service.
        if model.config.l2_mode != "feature":
            model = copy.copy(model)
            model.config = dataclasses.replace(model.config,
                                               l2_mode="feature")
        self.model = model
        self.device = model.device
        self.modalities = tuple(modalities)
        self.typecode = typecode
        self.knn = knn
        self.ntype = ntype
        self.channels = tuple(MODALITY_CHANNELS[m] for m in modalities)
        self.compress_factors = tuple(
            compress_factors if compress_factors is not None
            else [100.0 if m == "of" else 1.0 for m in modalities])
        self.buckets = tuple(sorted(buckets))
        self._dcfg = DataConfig()
        # a model trained with standardized inputs needs the same stats
        # here, or it sees another input distribution than in training;
        # several sources index by the raw feed's "source" entry
        self.norm_stats = norm_stats
        self._norm = None
        self.norm_sources = 1
        if norm_stats is not None:
            missing = [m for m in self.modalities if m not in norm_stats]
            if missing:
                raise ValueError(
                    f"norm_stats missing modalities {missing}; a partially"
                    " standardized encode would mix input scales")
            self._norm = {
                m: tuple(torch.as_tensor(np.atleast_2d(norm_stats[m][i]),
                                         dtype=torch.float32).to(self.device)
                         for i in (0, 1))
                for m in self.modalities}
            rows = {int(v[0].shape[0]) for v in self._norm.values()}
            if len(rows) > 1:
                raise ValueError(
                    f"norm_stats disagree on dataset-source count per "
                    f"modality: {sorted(rows)}")
            self.norm_sources = rows.pop()
        self._gallery_codes: Optional[torch.Tensor] = None
        # the buffer's squared row norms, kept with it: recomputing them
        # per query would stream a (capacity, D) temporary every call
        self._gallery_sq: Optional[torch.Tensor] = None
        self._gallery_dense: Optional[torch.Tensor] = None
        self._gallery_bias: Optional[torch.Tensor] = None  # 0 / 1e12
        self._ulabels: Optional[np.ndarray] = None
        self._gallery_size = 0      # LIVE rows (tombstones excluded)
        # host masters stay row-aligned with the device buffers (tombstoned
        # slots stay in place until a capacity rebuild compacts them)
        self._capacity = 0
        self._label_capacity = 0
        self._rows_used = 0         # slots consumed incl. tombstones
        self._host_codes: Optional[np.ndarray] = None
        self._host_labels: Optional[np.ndarray] = None
        self._live: Optional[np.ndarray] = None

    # -- device computation ----------------------------------------------
    def _encode(self, raw: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self._norm is not None:
            for m in self.modalities:
                raw[f"norm_mean_{m}"], raw[f"norm_std_{m}"] = self._norm[m]
        vols, flags, _ = preprocess_batch(
            raw, self.modalities, self.channels, self.compress_factors,
            self.ntype, 1, False, self._dcfg,
            normalize=self._norm is not None, device=self.device)
        return _tap(self.model(vols, flags), self.typecode)

    def _dist_vote(self, codes: torch.Tensor, k: int):
        d2 = pairwise_l2(codes, self._gallery_codes, self._gallery_sq)
        # dead slots (capacity padding + removed identities) carry +1e12
        d2 = d2 + self._gallery_bias[None, :]
        d2k, idx = nearest(d2, k)
        # the class CAPACITY, not the live count: unused class slots never
        # get a vote (dead rows never reach a top-k), so argmax skips them
        pred = vote(self._gallery_dense[idx], self._label_capacity)
        return pred, torch.sqrt(d2k)

    # ------------------------------------------------------------------
    def set_gallery(self, codes: np.ndarray, labels: np.ndarray,
                    warmup: bool = False) -> None:
        """Install a fresh gallery (replacing any previous one);
        warmup=True runs every query bucket once right away."""
        codes = np.asarray(codes, np.float32)
        labels = np.asarray(labels)
        if len(codes) == 0:
            raise ValueError("gallery must have at least one code")
        self._host_codes = codes
        self._host_labels = labels
        self._live = np.ones(len(codes), bool)
        self._install(_next_pow2(len(codes)),
                      _next_pow2(len(np.unique(labels))))
        if warmup:
            self.warmup()

    # -- capacity machinery --------------------------------------------
    def _install(self, capacity: int, label_capacity: int) -> None:
        """(Re)build the device buffers at the given capacities, compacting
        tombstoned slots out of the host masters."""
        if not self._live.all():
            self._host_codes = self._host_codes[self._live]
            self._host_labels = self._host_labels[self._live]
            self._live = np.ones(len(self._host_codes), bool)
        self._rows_used = len(self._host_codes)
        self._capacity = capacity
        self._label_capacity = label_capacity
        n, d = self._host_codes.shape
        self._gallery_codes = self._gallery_sq = None   # free the old first
        buf = torch.empty((capacity, d), dtype=torch.float32,
                          device=self.device)
        buf[:n].copy_(torch.from_numpy(self._host_codes))
        buf[n:].zero_()
        self._gallery_codes = buf
        self._gallery_sq = squared_norms(buf)
        self._refresh_meta()

    def _refresh_meta(self) -> None:
        """Recompute + upload the dense-label and bias vectors from the host
        masters.  Dense ids come from sorted np.unique over LIVE labels, so
        the tie-break order always matches a freshly built service."""
        live_idx = np.flatnonzero(self._live)
        self._ulabels, dense_live = np.unique(self._host_labels[live_idx],
                                              return_inverse=True)
        if len(self._ulabels) > self._label_capacity:
            raise AssertionError("class capacity underflow: enroll() must "
                                 "grow label_capacity before refreshing")
        dense = np.zeros(self._capacity, np.int64)
        dense[live_idx] = dense_live
        bias = np.full(self._capacity, 1e12, np.float32)
        bias[live_idx] = 0.0
        self._gallery_dense = torch.from_numpy(dense).to(self.device)
        self._gallery_bias = torch.from_numpy(bias).to(self.device)
        self._gallery_size = int(len(live_idx))

    # -- incremental enrollment ----------------------------------------
    def enroll(self, codes: np.ndarray, labels: np.ndarray) -> None:
        """Append identities to the live gallery.  Within the current
        capacities the new rows are written in place into the card's
        buffer; past one, the gallery is rebuilt at the doubled capacity."""
        codes = np.asarray(codes, np.float32)
        labels = np.asarray(labels)
        if len(codes) != len(labels):
            raise ValueError(f"{len(codes)} codes vs {len(labels)} labels")
        if len(codes) == 0:
            return
        if self._host_codes is None:
            self.set_gallery(codes, labels)
            return
        n = len(codes)
        live_labels = self._host_labels[:self._rows_used][self._live]
        nuniq = len(np.unique(np.concatenate([live_labels, labels])))
        in_place = (self._rows_used + n <= self._capacity
                    and nuniq <= self._label_capacity)
        self._host_codes = np.concatenate([self._host_codes, codes])
        self._host_labels = np.concatenate([self._host_labels, labels])
        self._live = np.concatenate([self._live, np.ones(n, bool)])
        if not in_place:
            self._install(_next_pow2(int(self._live.sum())),
                          _next_pow2(nuniq))
            return
        pos = self._rows_used
        rows = self._gallery_codes[pos:pos + n]
        rows.copy_(torch.from_numpy(codes))
        self._gallery_sq[pos:pos + n] = squared_norms(rows)
        self._rows_used += n
        self._refresh_meta()

    def enroll_raw(self, raw: Dict[str, np.ndarray],
                   labels: np.ndarray) -> None:
        """Encode raw clip volumes with this service's encode path and
        enroll the resulting signatures."""
        self.enroll(self.encode_raw(raw), labels)

    def remove(self, labels) -> int:
        """Tombstone every gallery row whose label is in ``labels``: flips
        bias entries to +1e12 and refreshes the dense-label map; the code
        rows stay in place until the next capacity rebuild.  Returns the
        number of rows removed."""
        labs = np.atleast_1d(np.asarray(labels))
        if self._host_codes is None:
            raise RuntimeError("no gallery set")
        hit = np.isin(self._host_labels, labs) & self._live
        if not hit.any():
            return 0
        if hit.sum() == self._live.sum():
            raise ValueError("cannot remove the entire gallery; use "
                             "set_gallery to install a new one")
        self._live &= ~hit
        self._refresh_meta()
        return int(hit.sum())

    def build_gallery(self, ds: GaitDataset, batch_size: int = 128,
                      warmup: bool = False) -> None:
        """Embed a packed dataset with this service's encode path and
        install it as the gallery."""
        codes = []
        n = len(ds)
        src = getattr(ds, "dataset_source", None)
        for s in range(0, n, batch_size):
            idx = np.arange(s, min(s + batch_size, n))
            real = len(idx)
            if real < batch_size:   # keep one batch shape
                idx = np.concatenate(
                    [idx, np.full(batch_size - real, idx[-1])])
            # each sample's own source selects its norm_stats row
            raw = {"labels": np.zeros(len(idx), np.int32),
                   "source": (src[idx].astype(np.int32) if src is not None
                              else np.zeros(len(idx), np.int32))}
            for m in self.modalities:
                store = ds.modalities[m]
                raw[f"raw_{m}"] = np.take(store.volumes, idx, axis=0)
                raw[f"present_{m}"] = store.present[idx].astype(np.float32)
            raw = {k: torch.from_numpy(v).to(self.device)
                   for k, v in raw.items()}
            with torch.no_grad():
                codes.append(self._encode(raw)[:real].cpu())
        self.set_gallery(torch.cat(codes).numpy(), ds.labels, warmup=warmup)

    def warmup(self) -> None:
        """Run every query bucket once (cuDNN and allocator warm-up), so
        the first live query of each bucket is steady-state."""
        if self._gallery_codes is None:
            raise RuntimeError("no gallery set")
        for b in self.buckets:
            specs = _raw_specs(self.modalities, self.channels,
                               self.compress_factors, b,
                               with_source=self._norm is not None)
            self.identify_raw({k: np.zeros(shape, dt)
                               for k, (shape, dt) in specs.items()
                               if k.startswith("raw_") or k == "source"})

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError("queries above the largest bucket are chunked")

    def _padded(self, v, nb: int, dtype=None) -> torch.Tensor:
        """``v`` (n, ...) on the device, zero-padded to ``nb`` rows."""
        v = torch.as_tensor(v)
        out = torch.zeros((nb, *v.shape[1:]), dtype=dtype or v.dtype,
                          device=self.device)
        out[:len(v)] = v.to(self.device)
        return out

    def _pad_raw(self, raw: Dict[str, np.ndarray], n: int) -> Dict:
        """Pad a raw query feed (n <= max bucket) to its query bucket;
        padded rows are absent (presence 0)."""
        nb = self._bucket(n)
        padded = {}
        for m in self.modalities:
            padded[f"raw_{m}"] = self._padded(raw[f"raw_{m}"], nb)
            padded[f"present_{m}"] = self._padded(
                raw.get(f"present_{m}", np.ones(n, np.float32)), nb,
                torch.float32)
        padded["labels"] = torch.zeros(nb, dtype=torch.int32,
                                       device=self.device)
        # with several stats rows, a missing source would standardize every
        # query with dataset 0's statistics
        if self.norm_sources > 1 and "source" not in raw:
            raise ValueError(
                f"this service standardizes with {self.norm_sources} "
                "dataset-source stat rows; queries must carry a 'source' "
                "entry selecting each sample's dataset")
        padded["source"] = self._padded(
            raw.get("source", np.zeros(n, np.int32)), nb, torch.int64)
        return padded

    def _chunks(self, raw: Dict[str, np.ndarray]):
        """Split a feed larger than the largest bucket into bucket-sized
        feeds (None when it fits)."""
        n = next(iter(raw.values())).shape[0]
        top = self.buckets[-1]
        if n <= top:
            return None
        return [{k: v[s:s + top] for k, v in raw.items()}
                for s in range(0, n, top)]

    def encode_raw(self, raw: Dict[str, np.ndarray]) -> np.ndarray:
        """Encode raw clip volumes to (N, D) signatures through the same
        bucketed path identify_raw uses."""
        chunks = self._chunks(raw)
        if chunks is not None:
            return np.concatenate([self.encode_raw(c) for c in chunks])
        n = next(iter(raw.values())).shape[0]
        with torch.no_grad():
            codes = self._encode(self._pad_raw(raw, n))
        return codes[:n].cpu().numpy()

    def _result(self, pred: torch.Tensor, dists: torch.Tensor, n: int):
        return (self._ulabels[pred[:n].cpu().numpy()],
                dists[:n].cpu().numpy())

    def identify_raw(self, raw: Dict[str, np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """raw: {"raw_<mod>": (N, T*C, H, W) quantized volumes, optional
        "present_<mod>": (N,)}.  Returns (labels, (N, k) neighbor
        distances)."""
        if self._gallery_codes is None:
            raise RuntimeError("no gallery set")
        chunks = self._chunks(raw)
        if chunks is not None:
            preds, dists = zip(*(self.identify_raw(c) for c in chunks))
            return np.concatenate(preds), np.concatenate(dists)
        n = next(iter(raw.values())).shape[0]
        k = min(self.knn, self._gallery_size)
        with torch.no_grad():
            codes = self._encode(self._pad_raw(raw, n))
            return self._result(*self._dist_vote(codes, k), n)

    def identify_codes(self, codes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """kNN-identify precomputed (N, D) signature codes against the
        gallery: the distance + vote half of identify_raw, bucket-padded
        (zero codes, whose predictions are discarded)."""
        if self._gallery_codes is None:
            raise RuntimeError("no gallery set")
        codes = np.asarray(codes, np.float32)
        n = len(codes)
        top = self.buckets[-1]
        if n > top:
            preds, dists = zip(*(self.identify_codes(codes[s:s + top])
                                 for s in range(0, n, top)))
            return np.concatenate(preds), np.concatenate(dists)
        k = min(self.knn, self._gallery_size)
        with torch.no_grad():
            return self._result(*self._dist_vote(
                self._padded(codes, self._bucket(n)), k), n)

    # -- 1:1 verification ----------------------------------------------
    def verify_codes(self, codes_a: np.ndarray, codes_b: np.ndarray,
                     threshold: Optional[float] = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """1:1 verification over row-paired signatures: L2 distances, plus
        same-person decisions when a threshold is given (on the host: the
        pairwise distance is trivial next to the encode).  Calibrate the
        threshold with calibrate_verification."""
        codes_a = np.asarray(codes_a, np.float32)
        codes_b = np.asarray(codes_b, np.float32)
        if codes_a.shape != codes_b.shape:
            raise ValueError(f"paired code batches must match: "
                             f"{codes_a.shape} vs {codes_b.shape}")
        d = np.linalg.norm(codes_a - codes_b, axis=1)
        return d, (d <= threshold if threshold is not None else None)

    def verify_raw(self, raw_a: Dict[str, np.ndarray],
                   raw_b: Dict[str, np.ndarray],
                   threshold: Optional[float] = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Verify that raw clip pairs show the same person: encode both
        sides and compare signature distances (the deployed form of the
        reference's verification nets + EER protocol)."""
        return self.verify_codes(self.encode_raw(raw_a),
                                 self.encode_raw(raw_b), threshold)

    @staticmethod
    def calibrate_verification(codes_a: np.ndarray, codes_b: np.ndarray,
                               same: np.ndarray) -> Tuple[float, float]:
        """EER-point threshold over labeled pairs (same=1 for same-person):
        returns (eer, threshold) via ops/metrics.eer_verif_dist."""
        d = np.linalg.norm(np.asarray(codes_a, np.float32)
                           - np.asarray(codes_b, np.float32), axis=1)
        return eer_verif_dist(np.asarray(same).astype(np.int64), d)

    def identify_video(self, raw: Dict[str, np.ndarray],
                       use_avg: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Identify one VIDEO from its subsequence clips: encode every clip,
        merge the signatures into one video code (mean, or max with
        use_avg=False, as eval/protocol.py:_merge_codes_per_video, without
        re-normalization) and query the gallery once.  Returns (label, (k,)
        neighbor distances)."""
        codes = self.encode_raw(raw)
        merged = codes.mean(axis=0) if use_avg else codes.max(axis=0)
        labels, dists = self.identify_codes(merged[None])
        return labels[0], dists[0]
