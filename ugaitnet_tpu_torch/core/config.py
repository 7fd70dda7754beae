"""Typed configuration for models, data, training and eval.

The port's own copy of ``ugaitnet_tpu/core/config.py``: the same dataclasses
with the same field names and defaults, so one ``config.json`` drives both
packages.  Every field selects a path the port runs: the gaitset, conv2d and
conv3d branches, MoE, the sharding axes (data, sequence, expert, tensor and
pipeline parallelism) and the optimizer menu.  A value no module supports
raises ``ValueError`` where it is read (an unknown branch kind, say).  No
field selects the port's CUDA kernels: a CUDA tensor takes them, a CPU
tensor their plain versions.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


# Canonical clip geometry shared by all datasets the reference supports
# ((reference) `nets/mj_uwyhNets_ba.py:160`): 25-frame windows at 60x60,
# optical flow carries 2 interleaved channels per frame (=> 50 planes).
NUM_FRAMES = 25
FRAME_H = 60
FRAME_W = 60

# Channels-per-frame for each modality.
MODALITY_CHANNELS: Dict[str, int] = {
    "of": 2,
    "gray": 1,
    "depth": 1,
    "silhouette": 1,
    "rgb": 3,
}


@dataclass(frozen=True)
class BranchConfig:
    """One per-modality encoder branch.

    kind:
      - "conv2d":  4-layer 2D CNN over the (H, W, T*C) volume
                   (reference `UWYHNet.buildBranch`, mj_uwyhNets_ba.py:66-152)
      - "conv3d":  6-layer strided 3D CNN (reference `build_3Dbranch`, :336-417)
      - "gaitset": two-stream set network with HPP part pooling
                   (reference `build_gaitset_branch`, :419-484)
      - "deepgaitv2": the port's own DeepGaitV2, configured by
                   ``DeepGaitV2Config`` below
    """

    kind: str = "gaitset"
    modality: str = "gray"
    # conv2d options (reference defaults filters [64,128,512,512], sizes [7,5,3,2]).
    filters_numbers: Tuple[int, ...] = (64, 128, 512, 512)
    filters_size: Tuple[int, ...] = (7, 5, 3, 2)
    ndense_units: int = 512
    weight_decay: float = 1e-4
    dropout: float = 0.4
    # activation: "relu" or "leaky" (alpha like reference LeakyReLU).
    activation: str = "leaky"
    leaky_alpha: float = 0.3
    # gaitset options: HPP bins and per-part projection width
    # (reference bins [1,2,4,8,16] * 2 streams = 62 parts, MatMul -> 256).
    hpp_bins: Tuple[int, ...] = (1, 2, 4, 8, 16)
    part_dim: int = 256
    gaitset_channels: Tuple[int, int, int] = (32, 64, 128)
    # BothDatasets gaitset variant: flatten the (P, D) parts per sample and
    # L2-normalize, emitting a rank-2 embedding
    # (reference nets/mj_uwyhNets_bothDatasets.py:395-399, norm=True).
    flatten_output: bool = False
    # Mixture-of-experts part projection (beyond reference, ops/moe.py):
    # 0 = the reference's fixed per-part MatMul; E > 0 replaces it with E
    # shared expert matrices and a learned top-1 router over (batch, part)
    # tokens.  Trains with a Switch load-balance aux loss
    # (TrainConfig.moe_aux_weight) and shards the expert axis under
    # expert parallelism (parallel/expert.py).
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    @property
    def in_channels(self) -> int:
        return MODALITY_CHANNELS[self.modality]

    @property
    def num_parts(self) -> int:
        # Both streams contribute one feature per bin.
        return 2 * sum(self.hpp_bins)


@dataclass(frozen=True)
class DeepGaitV2Config(BranchConfig):
    """A "deepgaitv2" branch (port only, ``models/deepgaitv2.py``):
    DeepGaitV2's 3D mode (Fan et al., arXiv:2303.03301; OpenGait
    ``deepgaitv2.py``), a single-modality model with its BNNeck id head.
    A subclass, so that ``BranchConfig`` keeps the JAX package's fields.

    stage_channels / stage_blocks: OpenGait's ``Backbone.channels`` /
    ``layers`` (the stem's width is the first); ``hpp_bins`` and
    ``part_dim`` its HPP bins and ``SeparateFCs`` width; ``logit_scale``
    the cosine logits' scale (OpenGait's ``CrossEntropyLoss.scale``)."""

    kind: str = "deepgaitv2"
    modality: str = "silhouette"
    hpp_bins: Tuple[int, ...] = (16,)
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    stage_blocks: Tuple[int, ...] = (1, 4, 4, 1)
    logit_scale: float = 16.0

    @property
    def num_parts(self) -> int:
        # one map, one feature per bin
        return sum(self.hpp_bins)


@dataclass(frozen=True)
class ModelConfig:
    """Full multimodal network: branches + gating + fusion + heads.

    Mirrors the knobs of `UWYHSemiNet.build`
    ((reference) `nets/mj_uwyhNets_ba.py:668-935`).
    """

    branches: Tuple[BranchConfig, ...] = (
        BranchConfig(kind="gaitset", modality="of"),
        BranchConfig(kind="gaitset", modality="gray"),
    )
    # "max" | "average" | "sign_max"  (reference fMerge / sign_max lambda,
    # mains/mj_trainUWYHGaitNet_DataGen_CasiaB.py:169-178).
    merge: str = "max"
    nclasses: int = 74
    # Extra dense head: [] = none (casenet B/D), [d] = extra code layer
    # (casenet C). postriplet picks which tap the triplet loss sees.
    extra_dense: Tuple[int, ...] = ()
    postriplet: int = 1
    dropout_code: float = 0.4
    # Per-branch auxiliary softmax classifiers (reference aux_losses,
    # mj_uwyhNets_ba.py:853-859).
    aux_losses: bool = False
    # L2-normalize each branch embedding *before* the merge
    # (reference `normbfmerge` in UWYHSemiNet3Mods, mj_uwyhNets_ba.py).
    norm_before_merge: bool = False
    # Reference quirk (deliberate, kept for parity): the "signature" layer is
    # tf.math.l2_normalize(x, axis=1); for the rank-3 gaitset signature
    # (parts, batch, dim) axis=1 is the *batch* axis
    # ((reference) `nets/mj_uwyhNets_ba.py:817`). "reference" reproduces
    # that; "feature" normalizes each per-part vector (the sane choice).
    l2_mode: str = "reference"
    # Compute dtype for convs/matmuls ("float32" for parity, "bfloat16" for
    # peak MXU throughput; params stay float32 either way).
    compute_dtype: str = "float32"
    # Rematerialize branch activations in the backward pass (jax.checkpoint
    # around each branch): the frame-stream conv activations are the HBM
    # peak of the train step ((B,T,64,64,C) per stage); remat trades ~1/3
    # extra conv FLOPs for that footprint, enabling larger per-chip batches.
    # Identical numerics (same ops, recomputed).
    remat: bool = False
    # Sequence-parallel mesh axis name: when set, every gaitset set-pool
    # finishes its max over the time axis with an all_gather over this
    # shard_map axis (parallel/sequence.py shards the T dim across it).
    # None (default) = the model runs self-contained under plain jit.
    seq_axis: str = ""

    @property
    def multimodal(self) -> bool:
        return len(self.branches) > 1

    @property
    def has_moe(self) -> bool:
        """Any branch routes its part projection through MoE experts —
        the train step then collects the sown load-balance aux losses
        (train/train_step.py:compute_losses)."""
        return any(b.moe_experts > 0 for b in self.branches)

    @property
    def signature_parts(self) -> int:
        """Leading signature axis after batch: 1 when the gaitset branch
        flattens its parts (flatten_output) or for dense branches."""
        b0 = self.branches[0]
        if b0.kind == "deepgaitv2" or (b0.kind == "gaitset"
                                       and not b0.flatten_output):
            return b0.num_parts
        return 1

    @property
    def signature_dim(self) -> int:
        b0 = self.branches[0]
        if b0.kind == "gaitset":
            return (b0.num_parts * b0.part_dim if b0.flatten_output
                    else b0.part_dim)
        if b0.kind == "deepgaitv2":
            return b0.part_dim
        return b0.ndense_units

    @property
    def bnneck_scale(self) -> float:
        """The BNNeck head's logit scale where the model has that head (a
        DeepGaitV2 branch with classes, ``models/deepgaitv2.py:BNNeck``),
        else 0."""
        b0 = self.branches[0]
        if b0.kind == "deepgaitv2" and self.nclasses > 0:
            return b0.logit_scale
        return 0.0


@dataclass(frozen=True)
class DataConfig:
    """Sampler + preprocessing options.

    Mirrors `DataGeneratorGaitMMUWYH`
    ((reference) `data/mj_dataGeneratorMMUWYHsingle.py:26-841`).
    """

    batch_size: int = 40
    # Replicate each sample with modality-dropout copies: level 1 = none,
    # 2 = one random-modality-disabled copy, 3 = both single-modality copies
    # (reference expand_level, ...single.py:491-535).
    expand_level: int = 3
    # P*K balanced sampling: emit `repetitions` records per subject before
    # advancing (reference repetitions generator).
    repetitions: int = 5
    augment: bool = True
    # Probability machinery matches the reference: 3/4 of samples get a
    # joint shift/zoom/brightness transform, 1/2 of those also mirror
    # (...single.py:401-410).
    shift_range: Tuple[int, ...] = (-5, -3, 0, 3, 5)
    zoom_range: float = 0.04
    brightness_range: Tuple[float, float] = (0.95, 1.05)
    channel_shift_range: float = 0.025
    # OF magnitude clip augmentation (...single.py:412-417).
    of_clip_max: float = 2300.0
    of_clip_min: float = 50.0
    # Value filled into disabled-modality inputs (reference self.noise = 1e-9).
    noise: float = 1e-9
    # buildGaits remap for the joint (BothDatasets) regime: one group id per
    # *sorted unique* gait code; gaits sharing a group id are balanced as ONE
    # sampling slot per round (e.g. (0,1,2,0,4,5) merges TUM "n" with CASIA
    # "nm"; mj_dataGeneratorMMUWYHBothDatasets.py:80-83,139, used at
    # mains/mj_trainUWYHGaitNet_DataGen_2mod_BothDatasets.py:875-882).
    gait_groups: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class TrainConfig:
    # adam | adam_keras (exact Keras update, trajectory-faithful for
    # migrated reference checkpoints) | sgd | amsgrad | adamw |
    # sgd_opengait (port only: torch.optim.SGD with momentum and weight
    # decay 5e-4, OpenGait's solver; train/train_step.py:make_optimizer)
    optimizer: str = "adam"
    lr: float = 1e-4
    momentum: float = 0.9
    epochs: int = 75
    extra_epochs: int = 25
    margin: float = 0.2
    # [triplet weight (wver), id-CE weight (wid), aux weights...]
    loss_weights: Tuple[float, ...] = (1.0, 0.1)
    label_smoothing: float = 0.0
    use_focal: bool = False
    only_triplet: bool = False
    # semi-hard triplet instead of batch-all (BothDatasets regime,
    # reference nets/mj_uwyhNets_bothDatasets.py:696,715).
    triplet_kind: str = "batch_all"  # batch_all (pallas on tpu) | batch_all_xla | batch_all_pallas | semi_hard | hard
    save_every_epochs: int = 5
    seed: int = 0
    # Sharding: data-parallel axis size 0 = use all devices.
    dp_devices: int = 0
    # Model-parallel axis size; >0 builds a (max(1,dp) x tp) 2D mesh with
    # conv channels and the part head sharded (parallel/tensor.py).
    tp_devices: int = 0
    # Sequence-parallel axis size; >0 builds a (max(1,dp) x sp) 2D mesh
    # sharding the gait set (time) axis (parallel/sequence.py).  Mutually
    # exclusive with tp_devices.
    sp_devices: int = 0
    # Pipeline (branch-placement) parallel device count; >0 places branch
    # trunk i on device i and the head stage + optimizer on device 0
    # (parallel/pipeline.py).  Mutually exclusive with the mesh modes.
    pp_devices: int = 0
    # Expert-parallel axis size; >0 builds a (max(1,dp) x ep) 2D mesh with
    # the MoE expert axis sharded (parallel/expert.py).  Requires a model
    # with BranchConfig.moe_experts > 0; mutually exclusive with tp/sp/pp.
    ep_devices: int = 0
    # Weight of the Switch load-balance auxiliary loss when any branch
    # uses an MoE part projection (ops/moe.py).
    moe_aux_weight: float = 0.01
    # Write checkpoints on orbax's background thread so the train loop
    # never blocks on serialization/disk (core/checkpoint.py
    # AsyncCheckpointWriter).
    async_checkpoint: bool = False


@dataclass(frozen=True)
class EvalConfig:
    knn: int = 3
    # 1 = signature parts tensor, 3 = flattened signature (reference
    # typecode->layer map, mains/mj_testUWYHGaitNet_open_casiab.py:157-166),
    # else = "code" tap.
    typecode: int = 3
    # Combine per-subsequence predictions per video: "vote" (majority,
    # CASIA-B) or "avgcode" (mean code then kNN, TUM).
    video_mode: str = "vote"
    mirror_gallery: bool = False
    batch_size: int = 128


def asdict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def dump_json(path: str, **configs: Any) -> None:
    """Persist all configs of an experiment to one JSON file
    (parity with `rd_JSONInfo`, reference utils/rd_JSONInfo.py:4-42)."""
    payload = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
               for k, v in configs.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)


def _rebuild(cls, d):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        payload = json.load(f)
    out: Dict[str, Any] = {}
    mapping = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig,
               "eval": EvalConfig}
    for k, v in payload.items():
        cls = mapping.get(k)
        if cls is None:
            out[k] = v
            continue
        if k == "model" and "branches" in v:
            v = dict(v)
            v["branches"] = tuple(
                _rebuild(DeepGaitV2Config if b.get("kind") == "deepgaitv2"
                         else BranchConfig, b) for b in v["branches"])
        out[k] = _rebuild(cls, v)
    return out
