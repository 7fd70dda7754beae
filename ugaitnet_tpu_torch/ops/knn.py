"""kNN gallery search on the device.

Port of ``ugaitnet_tpu/ops/knn.py``: the float32 paths and the int8 gallery
(``quantize_gallery``, ``pairwise_l2_int8``) on one device, and
``knn_predict_sharded``, the gallery's rows split over the ranks of a mesh.  The probes x
gallery distances are one matmul, a top-k picks the neighbors and the vote
is a one-hot sum; only the final labels come back to the host.

The int8 cross term is ``torch._int_mm`` (exact int32 sums), as the JAX
package leaves it to an XLA dot.  On a card it is cuBLASLt's int8 GEMM,
which takes A row-major and B column-major (so the gallery's (G, D) rows
go in as ``B = gallery.T``, no copy), and refuses an M of 16 rows or
fewer and a K or N that is not a multiple of 8: ``int8_mm`` pads M to at
least 24 rows and every dimension to a multiple of 8 with zeros, which
add nothing to the sums.  The serving gallery's power-of-two capacity and
every configured code width (62 x part_dim, ndense_units) are multiples
of 8 already, so only the probe rows are padded there.  int32 cannot
overflow: D * 127^2 = 2.56e8 at D = 15,872.

Neighbor order: ``jax.lax.top_k`` returns the lower index first among
equal values, and ``torch.topk`` promises no order at all.  Exact ties are
real here (a code enrolled twice, mirrored copies of symmetric clips, the
+1e12 dead slots of a serving gallery), and a different k-th neighbor
changes the vote.  So ``nearest`` ranks by the pair (distance, gallery
index), packed into one int64 key: the bits of a non-negative float32 sort
as the float does, and the index breaks ties, lower first.

Vote parity: sklearn with uniform weights sums votes per class and takes the
lowest class on ties; the one-hot sum over sorted unique class ids and
``torch.argmax`` (first maximum) match it.

Row-sharded galleries (``knn_predict_sharded``, and the mesh service of
``eval/serving.py``): every rank scores its rows and keeps its k nearest by
the same int64 key, with the global row index; the ranks' candidates are
all-gathered and merged by that key (``sharded_nearest``), so the neighbors
and their order are the one-device ``nearest``'s, the JAX ``lax.top_k``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.ops.collectives import gather_rows_nograd


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x
    return torch.nn.functional.pad(x, (0, cols - x.shape[1],
                                       0, rows - x.shape[0]))


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, a @ b.T, exact."""
    m, k = a.shape
    n = b.shape[0]
    up = lambda v: -(-v // 8) * 8
    kp = up(k)
    out = torch._int_mm(_pad_to(a, max(24, up(m)), kp),
                        _pad_to(b, up(n), kp).t())
    return out[:m, :n]


# float32(1 / 127): XLA compiles the probes' ``max / 127.0`` in
# pairwise_l2_int8 into a multiply by this constant (numpy's
# quantize_gallery divides)
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_rows(x: torch.Tensor, xla_scale: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (q (N, D) int8, scale (N,)), scale =
    max(max |row|, 1e-30) / 127 (times float32(1/127) with ``xla_scale``)
    and q = clip(round(x / scale), -127, 127), rounding half to even, as
    ``jnp.round`` and ``np.rint`` do."""
    amax = torch.clamp_min(x.abs().amax(dim=1), 1e-30)
    scale = amax * _RECIP_127 if xla_scale else amax / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_gallery(codes) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Symmetric per-ROW int8 quantization of (G, D) float32 codes (a
    tensor, on its device, or an array): (int8 codes, (G,) scales, |g|^2),
    |g|^2 from the ORIGINAL codes, so only the cross term of the distance is
    quantized.  Per-row scales keep one outlier row from costing every other
    row its resolution.  The codes and scales are the JAX package's
    (numpy) values bitwise; |g|^2 sums in torch's order."""
    codes = torch.as_tensor(codes, dtype=torch.float32)
    if codes.shape[0] == 0:
        n = codes.shape[0]
        return (codes.to(torch.int8), torch.ones(n, device=codes.device),
                torch.zeros(n, device=codes.device))
    q, scale = quantize_rows(codes)
    return q, scale, squared_norms(codes)


def pairwise_l2_int8(probes: torch.Tensor, gallery_i8: torch.Tensor,
                     gallery_scale: torch.Tensor, g2: torch.Tensor
                     ) -> torch.Tensor:
    """(P, D) float32 x (G, D) int8 -> (P, G) squared-L2.

    Probes are quantized per row; the cross term is int8 x int8 -> int32
    and rescaled in float32 by the per-row probe scales, then by the
    per-row gallery scales, in the JAX package's order; |q|^2 and |g|^2
    stay float32.  The probe scales and codes are those of the JAX
    function as jit compiles it (the serving path), bitwise."""
    p2 = squared_norms(probes)[:, None]
    q, ps = quantize_rows(probes, xla_scale=True)
    dot = int8_mm(q, gallery_i8).to(torch.float32) * ps[:, None] \
        * gallery_scale[None, :]
    return torch.clamp_min(p2 + g2[None, :] - 2.0 * dot, 0.0)


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N,) row sums of squares."""
    return torch.sum(x * x, dim=1)


def pairwise_l2(probes: torch.Tensor, gallery: torch.Tensor,
                gallery_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, D) x (G, D) -> (P, G) squared-L2 distances (monotone in L2, so
    neighbor order matches sklearn's euclidean metric).  gallery_sq: the
    gallery's squared_norms, when the caller keeps them."""
    p2 = squared_norms(probes)[:, None]
    g2 = squared_norms(gallery) if gallery_sq is None else gallery_sq
    dot = probes @ gallery.T
    return torch.clamp_min(p2 + g2[None, :] - 2.0 * dot, 0.0)


def _keys(d2: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """int64 (float32 bits of d2, offset + column) per entry: they sort as
    (distance, index)."""
    # + 0.0 turns a -0.0 into +0.0, whose bits sort as the smallest
    bits = (d2 + 0.0).contiguous().view(torch.int32).to(torch.int64)
    col = torch.arange(offset, offset + d2.shape[1], device=d2.device,
                       dtype=torch.int64)
    return (bits << 32) | col


def _smallest(key: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(key, k, dim=1, largest=False, sorted=True)


def nearest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of non-negative float32 ``d2``,
    ascending, the lower column first among equal values: (values,
    indices), each (P, k)."""
    idx = _smallest(_keys(d2), k).values & 0xFFFFFFFF
    return torch.gather(d2, 1, idx), idx


def sharded_nearest(d2: torch.Tensor, labels: torch.Tensor, k: int,
                    offset: int, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nearest`` over a gallery whose rows the ranks of ``group`` split
    (``group=None``: one device holds them all): ``d2`` (P, G_r) holds
    this rank's rows, the global rows from ``offset``, and ``labels``
    (G_r,) their dense labels.  Returns the k nearest's (d2, labels), each
    (P, k), the same on every rank."""
    key = _smallest(_keys(d2, offset), min(k, d2.shape[1]))
    cand = labels[key.indices]
    keys = gather_rows_nograd(key.values[None], group)      # (n, P, k_r)
    labs = gather_rows_nograd(cand[None], group)
    keys = keys.permute(1, 0, 2).reshape(d2.shape[0], -1)
    labs = labs.permute(1, 0, 2).reshape(d2.shape[0], -1)
    best = _smallest(keys, k)
    d2k = (best.values >> 32).to(torch.int32).view(torch.float32)
    return d2k, torch.gather(labs, 1, best.indices)


def vote(neighbor_labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(P, k) dense neighbor labels -> (P,) majority class, lowest on ties."""
    votes = torch.nn.functional.one_hot(neighbor_labels.long(), num_classes)
    return torch.argmax(votes.sum(dim=1), dim=1)


def _knn_device(probes: torch.Tensor, gallery: torch.Tensor,
                gallery_labels: torch.Tensor, k: int, num_classes: int):
    d2 = pairwise_l2(probes, gallery)
    _, idx = nearest(d2, k)
    return vote(gallery_labels[idx], num_classes), d2


def _to_device(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(dev)


def knn_predict(probes: np.ndarray, gallery: np.ndarray,
                gallery_labels: np.ndarray, k: int = 3,
                batch: int = 4096, device: DeviceLike = None) -> np.ndarray:
    """Predict probe labels by kNN vote over the gallery, ``batch`` probes
    at a time.  Labels may be arbitrary ints; they are densified to [0, C)
    on the host and mapped back after the vote."""
    dev = resolve_device(device)
    ulabs, dense = np.unique(np.asarray(gallery_labels), return_inverse=True)
    gal = _to_device(gallery, dev)
    dense = torch.as_tensor(dense.astype(np.int64)).to(dev)
    k = min(k, gal.shape[0])
    probes = np.asarray(probes, np.float32)
    preds = []
    for s in range(0, probes.shape[0], batch):
        pred, _ = _knn_device(_to_device(probes[s:s + batch], dev), gal,
                              dense, k, len(ulabs))
        preds.append(pred.cpu().numpy())
    return ulabs[np.concatenate(preds)]


def knn_predict_with_distances(probes: np.ndarray, gallery: np.ndarray,
                               gallery_labels: np.ndarray, k: int = 3,
                               device: DeviceLike = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Like knn_predict but also returns the full (P, G) distance matrix
    (used by the averaged-code video protocol)."""
    dev = resolve_device(device)
    ulabs, dense = np.unique(np.asarray(gallery_labels), return_inverse=True)
    k = min(k, len(gallery))
    pred, d2 = _knn_device(_to_device(probes, dev), _to_device(gallery, dev),
                           torch.as_tensor(dense.astype(np.int64)).to(dev),
                           k, len(ulabs))
    return ulabs[pred.cpu().numpy()], np.sqrt(d2.cpu().numpy())


def pad_gallery_int8(q: np.ndarray, scale: np.ndarray, g2: np.ndarray,
                     dense_labels: np.ndarray, multiple: int):
    """Pad a quantized gallery to a row-count multiple with +inf-distance
    sentinels (q = 0, scale 1, |g|^2 = 1e12) so row-sharding divides
    evenly; the sentinels can never enter a top-k as long as k <= real
    rows.  numpy, bitwise the JAX package's."""
    pad = (-len(q)) % multiple
    if not pad:
        return q, scale, g2, dense_labels
    return (np.concatenate([q, np.zeros((pad, q.shape[1]), np.int8)]),
            np.concatenate([scale, np.ones(pad, np.float32)]),
            np.concatenate([g2, np.full(pad, 1e12, np.float32)]),
            np.concatenate([dense_labels, np.zeros(pad, np.int32)]))


def knn_predict_sharded(probes: np.ndarray, gallery: np.ndarray,
                        gallery_labels: np.ndarray, mesh, k: int = 3,
                        gallery_dtype: str = "float32") -> np.ndarray:
    """kNN with the gallery's rows split over the mesh's first axis, for
    galleries too large for one card.  Every rank calls it with the same
    arguments (SPMD) and gets the labels.

    The gallery is padded to a multiple of the axis size with sentinels
    (float32: rows of 1e6; int8: ``pad_gallery_int8``), each rank scores
    the probes against its rows and the ranks' top-k merge by
    ``sharded_nearest``.  gallery_dtype="int8" quantizes per row on the
    host (shard-independent, so the distances are the one-device int8
    path's) and takes the int8 cross term."""
    axis = mesh.axis_names[0]
    n, r, group = mesh.size(axis), mesh.index(axis), mesh.group(axis)
    dev = mesh.device
    ulabs, dense = np.unique(np.asarray(gallery_labels), return_inverse=True)
    d_lab = dense.astype(np.int32)
    k = min(k, len(gallery))
    pr = _to_device(probes, dev)

    def rows(a: np.ndarray) -> torch.Tensor:
        size = len(a) // n
        return torch.from_numpy(np.ascontiguousarray(
            a[r * size:(r + 1) * size])).to(dev)

    if gallery_dtype == "int8":
        q, scale, g2 = (t.numpy() for t in quantize_gallery(
            np.asarray(gallery, np.float32)))
        q, scale, g2, d_lab = pad_gallery_int8(q, scale, g2, d_lab, n)
        d2 = pairwise_l2_int8(pr, rows(q), rows(scale), rows(g2))
    else:
        g = np.asarray(gallery, np.float32)
        pad = (-len(g)) % n
        if pad:
            g = np.concatenate([g, np.full((pad, g.shape[1]), 1e6,
                                           np.float32)])
            d_lab = np.concatenate([d_lab, np.zeros(pad, np.int32)])
        d2 = pairwise_l2(pr, rows(g))
    lab = rows(d_lab).to(torch.int64)
    _, labels = sharded_nearest(d2, lab, k, r * (len(d_lab) // n), group)
    return ulabs[vote(labels, len(ulabs)).cpu().numpy()]
