"""Serving: identification against a gallery held on the device.

Port of ``ugaitnet_tpu/eval/serving.py``.  The gallery code matrix lives
on the card; one call takes raw quantized clip volumes -> dequantize ->
embed -> distance matmul -> top-k vote and returns labels + neighbor
distances.  Query batches are padded to
fixed bucket sizes, so every query of a bucket runs the same shapes.

Incremental enrollment: the gallery lives in capacity-padded device buffers
(power-of-two row and class capacities) with a (capacity,) float32 distance
bias marking dead slots (+1e12, never in a top-k while k <= live rows).
``enroll`` writes the new rows in place into the card's buffer (only they
cross host -> device) and ``remove`` tombstones rows by flipping bias
entries; buffers are rebuilt only when a capacity doubles.  A host master
copy stays row-aligned with the card's buffer, so a large gallery costs
host memory too.

``gallery_dtype="int8"`` keeps the gallery per-row int8 quantized
(``ops/knn.py:quantize_gallery``) in three capacity-padded card buffers
(codes, (capacity,) scales, |g|^2 of the original codes) and takes the
distance cross term as an int8 product: a quarter of the bytes per query,
four times the rows per card.  ``quantized=True`` encodes through the int8
branches (``ops/quantize.py``), calibrated on ``calib_volumes``.  The
encoder exports with ``eval/export.py``.

``mesh=`` (a ``parallel/sharding.py`` mesh) holds a gallery too large for
one card: every rank builds the service and calls its methods together
(SPMD), with the same arguments.  The model and the host masters are
replicated; each rank's card buffers hold its block of the rows of the
capacity (rounded up to a multiple of the mesh's first axis), and
``enroll`` / ``remove`` write only the rows a rank owns.  A query is encoded
on every rank, scored against each rank's rows, and the ranks' top-k merge
by (distance, row) (``ops/knn.py:sharded_nearest``): the results are the
one-device service's, on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import MODALITY_CHANNELS, DataConfig
from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.eval.encode import _tap
from ugaitnet_tpu_torch.eval.export import _raw_specs
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops.knn import (nearest, pairwise_l2,
                                        pairwise_l2_int8, quantize_gallery,
                                        sharded_nearest, squared_norms, vote)
from ugaitnet_tpu_torch.ops.metrics import eer_verif_dist
from ugaitnet_tpu_torch.ops.quantize import encode_int8, quantize_model_params

# gallery rows quantized per step of an install (about 1 GB of float32 at
# D = 15,872)
_INSTALL_ROWS = 16384


def _next_pow2(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the gallery/class capacity
    quantum, so buffers are rebuilt log2(final gallery size) times."""
    return 1 << max(floor - 1, n - 1).bit_length()


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
                 calib_volumes: Optional[Sequence] = None,
                 norm_stats: Optional[Dict] = None,
                 gallery_dtype: str = "float32",
                 mesh=None):
        if gallery_dtype not in ("float32", "int8"):
            raise ValueError(f"gallery_dtype must be float32 or int8, "
                             f"got {gallery_dtype!r}")
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
        # the mesh's first axis splits the rows: this rank holds block
        # ``_shard`` of ``_shards``
        self.mesh = mesh
        self._shards, self._shard, self._group = 1, 0, None
        if mesh is not None:
            axis = mesh.axis_names[0]
            self._shards, self._shard = mesh.size(axis), mesh.index(axis)
            self._group = mesh.group(axis)
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
        # quantized=True: the int8 encode emits the flattened signature
        # only; a service configured for another tap would compare float
        # galleries and int8 probes in different embedding spaces
        self.quantized = quantized
        self._qnet = None
        if quantized:
            if typecode != 3 or model.config.extra_dense:
                raise ValueError(
                    "quantized=True supports typecode=3 on nets without "
                    "extra_dense (the int8 path encodes the flattened "
                    f"signature); got typecode={typecode}, extra_dense="
                    f"{model.config.extra_dense}")
            if calib_volumes is None:
                raise ValueError("quantized=True needs calib_volumes "
                                 "(one (B,T,H,W,C_i) batch per modality)")
            self._qnet = quantize_model_params(model, model.config,
                                               calib_volumes)
        self.gallery_dtype = gallery_dtype
        # float32: (capacity, D) codes; int8: (capacity, D) int8 codes,
        # with their per-row scales in _gallery_scale
        self._gallery_codes: Optional[torch.Tensor] = None
        self._gallery_scale: Optional[torch.Tensor] = None
        # |g|^2 per row, kept with the buffer: recomputing it per query
        # would stream a (capacity, D) temporary every call (int8: from the
        # original codes)
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
        if self._qnet is not None:
            return encode_int8(self._qnet, vols, flags, self.model.config)
        return _tap(self.model(vols, flags, train=False), self.typecode)

    def _distances(self, codes: torch.Tensor) -> torch.Tensor:
        """(P, D) probe codes -> (P, capacity) squared distances."""
        if self.gallery_dtype == "int8":
            return pairwise_l2_int8(codes, self._gallery_codes,
                                    self._gallery_scale, self._gallery_sq)
        return pairwise_l2(codes, self._gallery_codes, self._gallery_sq)

    def _dist_vote(self, codes: torch.Tensor, k: int):
        d2 = self._distances(codes)
        # dead slots (capacity padding + removed identities) carry +1e12
        d2 = d2 + self._gallery_bias[None, :]
        if self._group is None:
            d2k, idx = nearest(d2, k)
            labels = self._gallery_dense[idx]
        else:
            d2k, labels = sharded_nearest(d2, self._gallery_dense, k,
                                          self._row0(), self._group)
        # the class CAPACITY, not the live count: unused class slots never
        # get a vote (dead rows never reach a top-k), so argmax skips them
        pred = vote(labels, self._label_capacity)
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
        self._install(self._fit_capacity(len(codes)),
                      _next_pow2(len(np.unique(labels))))
        if warmup:
            self.warmup()

    # -- capacity machinery --------------------------------------------
    def _fit_capacity(self, rows: int) -> int:
        """The power-of-two capacity, rounded up to a multiple of the
        mesh's first axis (the row blocks must be equal)."""
        cap = _next_pow2(rows)
        return cap + (-cap) % self._shards

    def _row0(self) -> int:
        """The first global row of this rank's block."""
        return self._shard * (self._capacity // self._shards)

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
        # free the old buffers first
        self._gallery_codes = self._gallery_scale = self._gallery_sq = None
        int8 = self.gallery_dtype == "int8"
        dev = self.device
        # dead slots: zero codes, scale 1, |g|^2 0 (the bias excludes them)
        rows = capacity // self._shards
        codes = torch.zeros((rows, d), device=dev,
                            dtype=torch.int8 if int8 else torch.float32)
        sq = torch.zeros(rows, device=dev)
        scale = torch.ones(rows, device=dev) if int8 else None
        self._gallery_codes, self._gallery_scale, self._gallery_sq = \
            codes, scale, sq
        for s in range(0, n, _INSTALL_ROWS):
            self._write_rows(s, self._host_codes[s:s + _INSTALL_ROWS])
        self._refresh_meta()

    def _write_rows(self, pos: int, rows: np.ndarray) -> None:
        """Write float32 code rows into the card's buffers at global row
        ``pos``, in place (int8: quantized per row on the card); on a mesh,
        the rows this rank's block holds."""
        row0 = self._row0()
        lo = max(pos, row0)
        hi = min(pos + len(rows), row0 + self._capacity // self._shards)
        if lo >= hi:
            return
        rows = rows[lo - pos:hi - pos]
        pos = lo - row0
        x = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        end = pos + len(rows)
        if self.gallery_dtype == "int8":
            q, scale, g2 = quantize_gallery(x)
            self._gallery_codes[pos:end].copy_(q)
            self._gallery_scale[pos:end].copy_(scale)
            self._gallery_sq[pos:end].copy_(g2)
        else:
            self._gallery_codes[pos:end].copy_(x)
            self._gallery_sq[pos:end].copy_(squared_norms(x))

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
        block = slice(self._row0(),
                      self._row0() + self._capacity // self._shards)
        self._gallery_dense = torch.from_numpy(dense[block]).to(self.device)
        self._gallery_bias = torch.from_numpy(bias[block]).to(self.device)
        self._gallery_size = int(len(live_idx))

    # -- incremental enrollment ----------------------------------------
    def enroll(self, codes: np.ndarray, labels: np.ndarray) -> None:
        """Append identities to the live gallery.  Within the current
        capacities the new rows are written in place into the card's
        buffers; past one, the gallery is rebuilt at the doubled capacity
        (int8: per-row quantization, so appended rows equal a full
        requantization)."""
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
            self._install(self._fit_capacity(int(self._live.sum())),
                          _next_pow2(nuniq))
            return
        self._write_rows(self._rows_used, codes)
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
