"""DeepGaitV2 in its 3D mode as a branch, and its BNNeck id head.

Written from Fan, Hou, Yu et al., *Exploring Deep Models for Practical
Gait Recognition* (arXiv:2303.03301), as OpenGait builds it
(``opengait/modeling/models/deepgaitv2.py``, the blocks of
``opengait/modeling/modules.py``).  The port has no JAX counterpart of it.
Per clip ``x`` (T, H, W, 1) of silhouettes:

  input:   padded by 2 on every side (the GaitSet branch's pad: 60 x 60 ->
           64 x 64), then 10 columns cut each side (OpenGait's
           ``BaseSilCuttingTransform``: 64 x 44)
  stem:    per frame, 3x3 conv 1 -> c0, BatchNorm, ReLU
  stage1:  per frame, ``BasicBlock`` 2D at c0
  stage2-4: ``BasicBlock`` 3D (3x3x3 convs, padding 1), widths c1..c3; the
           first block of a stage carries the stage's stride (``STRIDES``,
           fixed by the 3D mode in OpenGait's code), and where the stride
           or the width changes its shortcut is a strided 1x1x1 conv and
           BatchNorm
  pool:    max over time (``gaitset.py:_set_max``), horizontal pyramid
           pooling (``gaitset.py:_hpp``: mean + max a strip), then per part
           a (c3 -> part_dim) matmul, ``fc_bin``: the signature ("embed_1")

A ``BasicBlock`` is conv -> BN -> ReLU -> conv -> BN, plus the shortcut,
then ReLU.  Every conv is a ``branches.Conv`` without bias.  The 2D stages
run with time folded into the batch, the 3D stages on a view of the same
memory.  On a card that memory is channels-last, so that cuDNN's bf16
convs read and write NHWC / NDHWC without transposes; on the CPU it stays
NCHW, since the CPU's channels-last BatchNorm sums its statistics in one
pass (6e-6 of the largest value from float64 in training, against 1e-7).

``BatchNorm`` keeps float32 parameters and running statistics whatever
the compute dtype.  Its mode is the forward's ``train`` argument, as the
port's dropout's, never ``nn.Module.training``: train normalizes with the
batch's statistics and moves the running ones (momentum 0.1, the unbiased
variance, as ``F.batch_norm``); eval normalizes with the running ones.

``BNNeck`` (OpenGait's ``SeparateBNNecks``): one BatchNorm over the whole
signature (B, P * D, features in (d, p) order), then per part the
L2-normalized feature against L2-normalized class weights, the cosine
logits times ``DeepGaitV2Config.logit_scale``.  A model with a DeepGaitV2
branch has that branch alone, and with classes this head in place of
``classprob`` (``ModelConfig.bnneck_scale``).

Traced (``obsv/spans.py``): spans ``model.dgv2.stem``, ``.stage1`` ..
``.stage4``, ``.pool`` and ``head.bnneck``, with the forward's key as id;
counter ``bn.batch_stats``, one a BatchNorm that normalizes with batch
statistics and moves the running ones (25 a forward of the published
model: 1 + 2 + 9 + 9 + 3 + 1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ugaitnet_tpu_torch.core.config import ModelConfig
from ugaitnet_tpu_torch.models.branches import Conv
from ugaitnet_tpu_torch.models.gaitset import _hpp, _set_max, glorot_
from ugaitnet_tpu_torch.obsv import spans

BN_MOMENTUM, BN_EPS = 0.1, 1e-5
PAD, CUT = 2, 10
# the first block's (T, H, W) stride of each stage in the 3D mode (stage 1
# is 2D and takes H and W)
STRIDES = ((1, 1, 1), (1, 2, 2), (1, 2, 2), (1, 1, 1))

# the paths a model with a deepgaitv2 branch does not take, and why
REFUSED = {
    "sequence parallelism": "its 3D stages convolve across time, so a "
                            "rank's slice of the frames is not separable",
    "tensor parallelism": "no split of its BatchNorm residual stages over "
                          "the model ranks is written",
    "pipeline parallelism": "its branch stage and the BNNeck head would "
                            "carry BatchNorm buffers across devices, which "
                            "the pipeline does not move",
    "global data parallelism": "BatchNorm statistics over the global batch "
                               "need synchronized BatchNorm, which the port "
                               "does not have; the per-shard form "
                               "normalizes each rank's rows",
    "int8": "the int8 encode has no BatchNorm or residual path",
    "Keras export": "the reference's Keras layouts have no DeepGaitV2",
    "remat": "its recompute would move the BatchNorm running statistics a "
             "second time a step; the published model trains without it",
}


def refuse(cfg: ModelConfig, path: str) -> None:
    """Raise ``ValueError`` if ``cfg`` has a deepgaitv2 branch, which
    ``path`` (a key of ``REFUSED``) cannot run."""
    if any(b.kind == "deepgaitv2" for b in cfg.branches):
        raise ValueError(f"{path} cannot run a deepgaitv2 branch: "
                         f"{REFUSED[path]}")


def xavier_(t: torch.Tensor, generator: Optional[torch.Generator]
            ) -> torch.Tensor:
    """``nn.init.xavier_uniform_``'s fans for any rank (fan_in = size(1) x
    the trailing sizes, fan_out = size(0) x them), drawn from
    ``generator``: OpenGait's initializer of its per-part matrices."""
    rf = math.prod(t.shape[2:])
    return glorot_(t, t.shape[1] * rf, t.shape[0] * rf, generator)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (N, C, ...) (module docstring): weight
    drawn N(1, 0.02) and bias 0, OpenGait's ``init_parameters``."""

    def __init__(self, channels: int, generator: Optional[torch.Generator]):
        super().__init__()
        w = torch.empty(channels)
        with torch.no_grad():
            w.normal_(1.0, 0.02, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            spans.count("bn.batch_stats")
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, train, BN_MOMENTUM,
                            BN_EPS)


class BasicBlock(nn.Module):
    """conv3 -> BN -> ReLU -> conv3 -> BN, + shortcut, ReLU, over ``dims``
    spatial dims (2: frames; 3: a clip's (T, H, W)).  The first conv and a
    projecting shortcut carry ``stride``."""

    def __init__(self, ci: int, co: int, stride: Sequence[int], dims: int,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        k3, k1, one = (3,) * dims, (1,) * dims, (1,) * dims
        self.conv1 = Conv(ci, co, k3, stride, dtype, generator, padding=1,
                          bias=False)
        self.bn1 = BatchNorm(co, generator)
        self.conv2 = Conv(co, co, k3, one, dtype, generator, padding=1,
                          bias=False)
        self.bn2 = BatchNorm(co, generator)
        self.shortcut = self.shortcut_bn = None
        if max(stride) > 1 or ci != co:
            self.shortcut = Conv(ci, co, k1, stride, dtype, generator,
                                 bias=False)
            self.shortcut_bn = BatchNorm(co, generator)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.shortcut is not None:
            x = self.shortcut_bn(self.shortcut(x), train)
        return torch.relu(y + x)


class Stem(nn.Module):
    """Per frame: 3x3 conv, BatchNorm, ReLU."""

    def __init__(self, ci: int, co: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = Conv(ci, co, (3, 3), (1, 1), dtype, generator,
                         padding=1, bias=False)
        self.bn = BatchNorm(co, generator)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train))


class DeepGaitV2Branch(nn.Module):
    """(B, T, H, W, C) -> (B, sum(hpp_bins), part_dim), float32."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (1, 4, 4, 1),
                 hpp_bins: Sequence[int] = (16,), part_dim: int = 256,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not len(channels) == len(blocks) == len(STRIDES):
            raise ValueError("deepgaitv2 takes four stages: four channels "
                             "and four block counts")
        self.dtype = dtype
        self.hpp_bins = tuple(hpp_bins)
        self.stem = Stem(in_channels, channels[0], dtype, generator)
        ci = channels[0]
        for i, (co, n, st) in enumerate(zip(channels, blocks, STRIDES)):
            dims = 2 if i == 0 else 3
            st = st[-dims:]
            stage = nn.ModuleList()
            for j in range(n):
                stage.append(BasicBlock(ci, co, st if j == 0 else (1,) * dims,
                                        dims, dtype, generator))
                ci = co
            setattr(self, f"stage{i + 1}", stage)
        parts = sum(self.hpp_bins)
        self.fc_bin = nn.Parameter(xavier_(torch.empty((parts, ci, part_dim)),
                                           generator))

    def forward(self, x: torch.Tensor, train: bool = False, key=None
                ) -> torch.Tensor:
        """``key`` is the spans' id (the train step's count); the branch
        has no dropout."""
        b, t, h, w, c = x.shape
        with spans.span("model.dgv2.stem", key):
            f = x.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w).to(
                self.dtype)
            f = F.pad(f, (PAD, PAD, PAD, PAD))[..., CUT:w + 2 * PAD - CUT]
            f = self.stem(f, train)
            if f.is_cuda:
                f = f.contiguous(memory_format=torch.channels_last)
        with spans.span("model.dgv2.stage1", key):
            for blk in self.stage1:
                f = blk(f, train)
        # (B*T, C, H, W) -> (B, C, T, H, W), a view of the same memory
        # (channels-last -> channels-last-3D on a card)
        v = f.reshape(b, t, *f.shape[1:]).transpose(1, 2)
        for i in (2, 3, 4):
            with spans.span(f"model.dgv2.stage{i}", key):
                for blk in getattr(self, f"stage{i}"):
                    v = blk(v, train)
        with spans.span("model.dgv2.pool", key):
            v = v.transpose(1, 2)                       # (B, T', C, H', W')
            m = _set_max(v.reshape(-1, *v.shape[2:]), b)  # (B, C, H', W')
            parts = torch.cat([_hpp(m, nb) for nb in self.hpp_bins], dim=1)
            # compute-dtype inputs, float32 accumulation and output
            return torch.einsum("bpc,pcd->bpd", parts.to(self.dtype).float(),
                                self.fc_bin.to(self.dtype).float())


class BNNeck(nn.Module):
    """OpenGait's ``SeparateBNNecks`` (module docstring): (B, P, D) ->
    (the normalized feature (B, P, D), logits (B, P, nclasses)), float32."""

    def __init__(self, parts: int, dim: int, nclasses: int, scale: float,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.scale, self.dtype = scale, dtype
        self.bn = BatchNorm(parts * dim, generator)
        self.fc_bin = nn.Parameter(xavier_(torch.empty((parts, dim, nclasses)),
                                           generator))

    def forward(self, sig: torch.Tensor, train: bool, key=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with spans.span("head.bnneck", key):
            b, p, d = sig.shape
            x = self.bn(sig.transpose(1, 2).reshape(b, d * p), train)
            feat = F.normalize(x.reshape(b, d, p).transpose(1, 2), dim=-1)
            w = F.normalize(self.fc_bin, dim=1)
            logits = torch.einsum("bpd,pdc->bpc", feat.to(self.dtype),
                                  w.to(self.dtype)).to(torch.float32)
            return feat, self.scale * logits
