"""Synthetic in-memory gait dataset.

The port's own copy of ``ugaitnet_tpu/data/synthetic.py`` (numpy only), so the port
imports nothing of the JAX package.

Promotes the reference's `isDebug` fake-data mode
((reference) data/mj_dataGeneratorMMUWYHsingle.py:357-370) to a
first-class, shape- and dtype-faithful data source: quantized int16 OF
volumes and uint8 gray/depth/silhouette volumes with subject/gait/video/cam
structure, so samplers, pipelines, training and eval all run end-to-end
without real CASIA-B / TUM-GAID data.

Each subject gets a persistent random "gait template" per modality so that
embeddings are learnably class-separable — useful for smoke-training tests
that check the loss actually falls.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ugaitnet_tpu_torch.core.config import MODALITY_CHANNELS, NUM_FRAMES, FRAME_H, FRAME_W
from ugaitnet_tpu_torch.data.schema import GaitDataset, ModalityStore


def make_synthetic_dataset(num_subjects: int = 8,
                           videos_per_subject: int = 3,
                           subseqs_per_video: int = 4,
                           modalities: Sequence[str] = ("of", "gray"),
                           gait_types: Sequence[int] = (0, 1, 2),
                           num_cams: int = 3,
                           seed: int = 0,
                           template_seed: int | None = None,
                           name: str = "synthetic") -> GaitDataset:
    """template_seed: seed for the per-subject identity templates,
    decoupled from `seed` (the noise/subsequence draws).  Two datasets
    built with the same template_seed but different seeds share identities
    while every subsequence is an unseen draw — a train set and a
    held-out eval set for convergence/Rank-1 protocols.  Defaults to
    `seed` (one dataset, identical to the old behavior)."""
    rng = np.random.RandomState(seed)
    trng = (np.random.RandomState(template_seed)
            if template_seed is not None else rng)
    n = num_subjects * videos_per_subject * subseqs_per_video

    labels = np.zeros(n, np.int32)
    video_ids = np.zeros(n, np.int32)
    gaits = np.zeros(n, np.int32)
    cams = np.zeros(n, np.int32)
    set_ids = np.ones(n, np.int32)

    stores = {}
    templates = {m: trng.randn(num_subjects, 4, 4,
                               MODALITY_CHANNELS[m]).astype(np.float32)
                 for m in modalities}
    vols = {m: np.zeros((n, NUM_FRAMES * MODALITY_CHANNELS[m],
                         FRAME_H, FRAME_W),
                        np.int16 if m == "of" else np.uint8)
            for m in modalities}

    i = 0
    for s in range(num_subjects):
        # (modality, subject)-only: hoisted out of the video/subseq loops
        # (the upsample was redundantly recomputed per subsequence)
        bases = {m: np.repeat(np.repeat(templates[m][s], 15, 0), 15, 1)
                 for m in modalities}
        for v in range(videos_per_subject):
            vid = s * videos_per_subject + v
            gait = gait_types[v % len(gait_types)]
            # deterministic spread with two properties the protocols need:
            # (1) the camera SET is identical for every subject (a probe
            # subject must exist in single-camera galleries — a
            # subject-dependent spread capped camera-pair rank-1 at ~0.3
            # because most galleries simply lacked the probe subject);
            # (2) camera decorrelates from gait once videos_per_subject
            # exceeds len(gait_types) (the v//len phase shift breaks the
            # v % num_cams == v % len(gait_types) bijection).
            cam = (v + v // len(gait_types)) % num_cams
            for _ in range(subseqs_per_video):
                labels[i] = s + 1          # raw ids start at 1 like CASIA-B
                video_ids[i] = vid
                gaits[i] = gait
                cams[i] = cam
                for m in modalities:
                    c = MODALITY_CHANNELS[m]
                    # subject template upsampled + noise, laid out as planes
                    base = bases[m]
                    frames = (base[None] * 0.2
                              + 0.05 * rng.randn(NUM_FRAMES, FRAME_H,
                                                 FRAME_W, c))
                    planes = np.moveaxis(frames, -1, 1).reshape(
                        NUM_FRAMES * c, FRAME_H, FRAME_W)
                    if m == "of":
                        # int16 x100 like generateOFData (compressFactor=100)
                        vols[m][i] = np.clip(planes * 100.0 * 10.0,
                                             -32000, 32000).astype(np.int16)
                    else:
                        vols[m][i] = np.clip((planes + 0.5) * 255.0,
                                             0, 255).astype(np.uint8)
                i += 1

    for m in modalities:
        stores[m] = ModalityStore(
            modality=m, volumes=vols[m],
            compress_factor=100.0 if m == "of" else 1.0)

    return GaitDataset(name=name, modalities=stores, labels=labels,
                       video_ids=video_ids, gaits=gaits, cams=cams,
                       set_ids=set_ids, ntype=2)
