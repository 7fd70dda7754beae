"""kNN gallery search on the device.

Port of ``ugaitnet_tpu/ops/knn.py`` (the float32 paths).  The probes x
gallery distances are one matmul, a top-k picks the neighbors and the vote
is a one-hot sum; only the final labels come back to the host.

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device


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


def nearest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of non-negative float32 ``d2``,
    ascending, the lower column first among equal values: (values,
    indices), each (P, k)."""
    # + 0.0 turns a -0.0 into +0.0, whose bits sort as the smallest
    bits = (d2 + 0.0).contiguous().view(torch.int32).to(torch.int64)
    col = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int64)
    key = (bits << 32) | col
    idx = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    idx = idx & 0xFFFFFFFF
    return torch.gather(d2, 1, idx), idx


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
