"""Signature extraction for evaluation.

Port of ``ugaitnet_tpu/eval/encode.py``: the reference's
``evalUWYHNet_set`` encode loop (mains/mj_testUWYHGaitNet_open_casiab.py:
55-245) batched on the device.  Iterate the dataset deterministically
(expand 1, no shuffle, trailing partial batch included), tap the requested
embedding, optionally add mirrored copies, and return codes + labels +
video ids + cams on the host.

typecode parity (:157-166): 1 -> "signature", 3 -> "flatten", else "code".
Rank-3 part signatures are flattened per sample, so kNN sees one vector per
subsequence.

With a ``mesh`` (``parallel/sharding.py``; every rank calls, with the same
arguments and its own replica of the model) each rank encodes its rows of
every batch: the batch-axis L2 of the signature sums over the data ranks,
so the codes are the one-process encode's, and the codes are gathered to
every rank.  A tensor-parallel model (``parallel/tensor.py``) encodes its
strip of parts, joined over the model group.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import DataConfig
from ugaitnet_tpu_torch.data.pipeline import GaitPipeline
from ugaitnet_tpu_torch.data.sampler import SequentialSampler
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.models.network import UGaitNet, tp_strips
from ugaitnet_tpu_torch.obsv import spans
from ugaitnet_tpu_torch.ops.augment import mirror_volume
from ugaitnet_tpu_torch.ops.collectives import (DATA_AXIS, gather_along,
                                                gather_rows_nograd)

TYPECODE_TAP = {1: "signature", 3: "flatten"}
# the pass number of the traced spans' ids (pass, batch)
_PASSES = itertools.count()


def _tap(out: Dict[str, torch.Tensor], typecode: int) -> torch.Tensor:
    name = TYPECODE_TAP.get(typecode, "code")
    x = out.get(name, out["signature"])
    if x.ndim == 3:
        x = x.reshape(x.shape[0], -1)
    return x


def _tap_whole(out: Dict[str, torch.Tensor], typecode: int,
               model: UGaitNet) -> torch.Tensor:
    """``_tap``, with a tensor-parallel model's strip joined whole."""
    x = _tap(out, typecode)
    name = TYPECODE_TAP.get(typecode, "code")
    tp = getattr(model, "tp", None)
    if name not in out:
        name = "signature"
    if name in tp_strips(model.config, tp):
        x = gather_along(x, tp.group, 1)      # parts-major flattened strips
    return x


def encode_dataset(model: UGaitNet, ds: GaitDataset,
                   modalities: Sequence[str],
                   typecode: int = 3, batch_size: int = 128,
                   use_mods: Optional[Sequence[float]] = None,
                   mirror: bool = False,
                   indices: Optional[np.ndarray] = None,
                   norm_stats=None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (codes (N,D), labels, video_ids, cams) in raw label space,
    encoded on ``model``'s device.  mesh: encode data-parallel over the
    mesh's "data" axis (module docstring); batch_size must divide by its
    size.

    use_mods masks whole modalities at encode time (the eval scripts'
    use_mod1/use_mod2 args and the TUM all-combos protocol).  mirror=True
    appends a horizontally mirrored copy of every batch (the usemirror
    gallery option, mj_testUWYHGaitNet_open_casiab.py:194-206).
    norm_stats: the per-dataset standardization the model was trained with.
    """
    cfg = DataConfig(batch_size=batch_size, expand_level=1, augment=False)
    pipe = GaitPipeline(ds, cfg, modalities, labmap=None, indices=indices,
                        augment=False, norm_stats=norm_stats,
                        device=model.device)
    n = len(pipe.indices)
    if n == 0:
        # loud instead of an opaque concatenate error at the end: an empty
        # selection is a data mistake, and (0, D) codes would only surface
        # later as a silent rank1 = 0.0
        raise ValueError(
            f"encode_dataset: no samples to encode in '{ds.name}' "
            f"(dataset len {len(ds)}, indices filter "
            f"{'set' if indices is not None else 'absent'})")
    if use_mods is None:
        use_mods = [1.0] * len(modalities)
    group, ndev, shard = None, 1, slice(None)
    if mesh is not None:
        group, ndev = mesh.group(DATA_AXIS), mesh.size(DATA_AXIS)
        if batch_size % ndev:
            raise ValueError(
                f"encode batch_size {batch_size} not divisible by the "
                f"{ndev}-device data axis; the padded trailing batch could "
                "not shard evenly")
        b = batch_size // ndev
        shard = slice(mesh.index(DATA_AXIS) * b,
                      (mesh.index(DATA_AXIS) + 1) * b)

    def encode(vols, flags):
        out = model(vols, flags, train=False, group=group)
        return gather_rows_nograd(_tap_whole(out, typecode, model), group)

    # traced spans (obsv/spans.py), with the id (pass, batch), follow each
    # other: input.gather (the batch's rows to the host, the batch before
    # released), encode.launch (copy, preprocess and forward enqueued) and
    # encode.readback (.cpu()) partition each batch; encode.collect is the
    # pass's end
    npass = next(_PASSES)
    codes, metas = [], []
    with torch.inference_mode():
        for b, batch_idx in enumerate(
                SequentialSampler(n, batch_size).epoch()):
            # pad the trailing partial batch to the full size with
            # use_flags == 0 rows: gating zeroes their embeddings, so under
            # l2_mode="reference" (batch-axis signature L2) they add nothing
            # to the column norms and the real rows equal an unpadded
            # forward; duplicate-row padding would skew every real code
            real = len(batch_idx)
            if real < batch_size:
                batch_idx = np.concatenate(
                    [batch_idx, np.full(batch_size - real, batch_idx[-1])])
            sid = (npass, b)
            # a mesh rank loads and encodes its own rows of the batch
            with spans.span("input.gather", sid):
                raw = pipe.gather(batch_idx[shard])
            with spans.span("encode.launch", sid):
                vols, flags, _ = pipe.preprocess(raw, expand=1, span_id=sid)
                flags = [f * u for f, u in zip(flags, use_mods)]
                if real < batch_size:
                    valid = torch.zeros(batch_size, device=model.device)
                    valid[:real] = 1.0
                    flags = [f * valid[shard] for f in flags]
                out = encode(vols, flags)[:real]
            with spans.span("encode.readback", sid):
                codes.append(out.cpu())
            metas.append(batch_idx[:real])
            if mirror:
                with spans.span("encode.launch", sid):
                    mvols = [mirror_volume(v, is_of=(m == "of"))
                             for v, m in zip(vols, modalities)]
                    out = encode(mvols, flags)[:real]
                with spans.span("encode.readback", sid):
                    codes.append(out.cpu())
                metas.append(batch_idx[:real])

    with spans.span("encode.collect", npass):
        sel = pipe.indices[np.concatenate(metas)]
        return (torch.cat(codes).numpy(), np.asarray(ds.labels[sel]),
                np.asarray(ds.video_ids[sel]), np.asarray(ds.cams[sel]))
