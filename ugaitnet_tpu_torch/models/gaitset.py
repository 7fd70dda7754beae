"""GaitSet-style set-pooling branch with horizontal pyramid pooling.

Port of ``ugaitnet_tpu/models/gaitset.py``.  The public layout is the JAX
package's ``(B, T, H, W, C)``; inside, the frame stream runs NCHW with T
folded into the batch ``(B*T, C, H, W)`` (the JAX package's off-TPU form),
and the set stream runs ``(B, C, H, W)``.

  frame stream (a):  per-frame 5x5 / 3x3 "SAME" convs, 2x2 max pools
  set stream (b):    max over time ("set pooling") at three depths, with
                     residual adds from the frame stream
  HPP:               bins (1, 2, 4, 8, 16) over both streams, each bin a
                     strip of the 16x16 map taken ROW-MAJOR over (H, W),
                     reduced by mean + max; (a, b) interleaved per bin
                     -> 2 * 31 = 62 parts
  part projection:   (62, C3, part_dim) tensor, einsum("bpc,pcd->bpd"), or
                     with ``moe_experts`` E > 0 the MoE projection
                     (``ops/moe.py``): ``router`` (C3, E) and ``expert_proj``
                     (E, C3, part_dim); the branch then returns (parts, the
                     Switch load-balance aux loss)

lrelu is ``max(x, 0.3 x)``, applied after the pools as in the JAX module
(exact by monotonicity).  The frame stream's stage tails (stages 1 and 2:
2x2 max pool, lrelu, and the set max of the pooled frames) go through
``ops/cuda/stage_tail.py:stage_tail_cuda``: the CUDA kernels on the card,
the plain chain (``ops/pooling.py:stage_tail``) on the CPU.  With
``dtype=torch.bfloat16`` the conv inputs and weights are cast to bf16
(outputs bf16) and the part projection takes bf16 inputs with float32
accumulation and output, where the JAX module casts.

The frame stream's a_conv2 and a_conv6 (``HAND_CONVS``) take the hand 3x3
kernel (``ops/cuda/conv3x3.py:conv3x3_cuda``: the CUDA kernel on the card,
the plain ``ops/conv3x3.py:conv3x3`` on the CPU) when the branch runs in
bf16 and no gradient is recorded (``torch.is_grad_enabled()`` is off, as
under the encode's ``inference_mode`` and serving's ``no_grad``, or neither
the input nor the weight requires grad); every other call, the fp32 paths
and the bf16 train step among them, is ``F.conv2d``.  The kernel has no
backward, which the train step would need.  This is a route chosen by
dtype and grad mode, not a fallback: on the card a bf16 call without
autograd to those layers always launches the kernel, 4 per two-branch
forward.

Sequence parallelism (``parallel/sequence.py``): with ``seq_group`` set the
branch holds only its rank's frames, and each set pool is the local max
over them (the stage tail's s), gathered over the group and maxed again;
a global max over T is the max of the ranks' maxima.  Expert parallelism
(``parallel/expert.py``) sets ``expert_group`` and keeps experts
[``expert_start``, ``expert_start`` + E_local) of ``expert_proj``.

Tensor parallelism (``parallel/tensor.py``) sets ``model_group`` and
splits conv pairs: the convs named in ``tp_split`` hold a share of their
output channels (a_conv1/3/5, b_conv1/3, whose input goes through
``copy_in``) or of their input channels (a_conv2/4/6, b_conv2/4, whose
partial output an all-reduce over the group, ``reduce_out``, restores
before the pool, set pool, residual add or leaky ReLU that follows).
With ``part_range`` set the branch projects only parts [p0, p1) and
returns that strip.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ugaitnet_tpu_torch.ops.collectives import (all_gather_rows, copy_in,
                                                reduce_out)
from ugaitnet_tpu_torch.ops.cuda.conv3x3 import conv3x3_cuda
from ugaitnet_tpu_torch.ops.cuda.stage_tail import stage_tail_cuda
from ugaitnet_tpu_torch.ops.moe import moe_capacity, moe_project
from ugaitnet_tpu_torch.ops.pooling import max_pool_2x2

A_CONVS = ("a_conv1", "a_conv2", "a_conv3", "a_conv4", "a_conv5", "a_conv6")
B_CONVS = ("b_conv1", "b_conv2", "b_conv3", "b_conv4")
# the 3x3 convs of the bf16 forward without autograd that take the hand
# kernel (the TPU prototypes' two shapes)
HAND_CONVS = ("a_conv2", "a_conv6")


def glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Glorot-uniform with explicit fans (flax's rule: fans include the
    receptive field, and for part_proj the leading part axis)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


class FrameConv(nn.Module):
    """Bias-free "SAME" 2D conv on NCHW, weight OIHW.  The frame stream
    calls it with T folded into the batch (the JAX ``FrameConv``'s off-TPU
    form); the set stream calls it on (B, C, H, W) (the JAX ``nn.Conv``).
    ``hand``: a 3x3 whose bf16 calls without autograd take the hand kernel
    (module docstring)."""

    def __init__(self, ci: int, co: int, k: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator], hand: bool = False):
        super().__init__()
        self.dtype = dtype
        self.hand = hand and k == 3
        self.weight = nn.Parameter(glorot_(torch.empty((co, ci, k, k)),
                                           k * k * ci, k * k * co, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.hand and self.dtype == torch.bfloat16 and not (
                torch.is_grad_enabled()
                and (x.requires_grad or w.requires_grad)):
            return conv3x3_cuda(x, w)
        return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _group_max(out: torch.Tensor, seq_group=None) -> torch.Tensor:
    """A set pool over this rank's frames -> over the seq group's frames
    (the max of the ranks' maxima); the identity without a group."""
    if seq_group is not None:
        out = torch.amax(all_gather_rows(out[None], seq_group), dim=0)
    return out


def _set_max(a: torch.Tensor, batch: int, seq_group=None) -> torch.Tensor:
    """Set pooling: (B*T, C, H, W) -> (B, C, H, W), max over time; over the
    seq group's frames too when one is given."""
    return _group_max(torch.amax(a.reshape(batch, -1, *a.shape[1:]), dim=1),
                      seq_group)


def _hpp(fmap: torch.Tensor, num_bin: int) -> torch.Tensor:
    """One pyramid level: (B, C, H, W) -> (B, num_bin, C), mean + max per
    strip.  The (H, W) grid is cut row-major into ``num_bin`` strips, as
    the reference reshapes its (B, H, W, C) map."""
    b, c, h, w = fmap.shape
    strips = fmap.reshape(b, c, num_bin, (h * w) // num_bin)
    return (strips.mean(dim=-1) + strips.amax(dim=-1)).transpose(1, 2)


class GaitSetBranch(nn.Module):
    """(B, T, H, W, C) -> (B, num_parts, part_dim)."""

    def __init__(self, in_channels: int,
                 channels: Tuple[int, int, int] = (32, 64, 128),
                 hpp_bins: Sequence[int] = (1, 2, 4, 8, 16),
                 part_dim: int = 256, leaky_alpha: float = 0.3,
                 pad: int = 2, dtype: torch.dtype = torch.float32,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c1, c2, c3 = channels
        self.hpp_bins = tuple(hpp_bins)
        self.leaky_alpha = leaky_alpha
        self.pad = pad
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.seq_group = None
        self.expert_group, self.expert_start = None, 0
        self.model_group, self.tp_split, self.part_range = None, (), None
        # (name, in, out, kernel) in the JAX module's creation order
        a_specs = [(in_channels, c1, 5), (c1, c1, 3), (c1, c2, 3),
                   (c2, c2, 3), (c2, c3, 3), (c3, c3, 3)]
        b_specs = [(c1, c2, 3), (c2, c2, 3), (c2, c3, 3), (c3, c3, 3)]
        for name, (ci, co, k) in zip(A_CONVS + B_CONVS, a_specs + b_specs):
            setattr(self, name, FrameConv(ci, co, k, dtype, generator,
                                          hand=name in HAND_CONVS))
        nparts = 2 * sum(self.hpp_bins)
        if moe_experts > 0:
            e = moe_experts
            self.router = nn.Parameter(glorot_(torch.empty((c3, e)), c3, e,
                                               generator))
            self.expert_proj = nn.Parameter(glorot_(
                torch.empty((e, c3, part_dim)), c3 * e, part_dim * e,
                generator))
        else:
            self.part_proj = nn.Parameter(glorot_(
                torch.empty((nparts, c3, part_dim)), c3 * nparts,
                part_dim * nparts, generator))

    def forward(self, x: torch.Tensor, train: bool = False,
                key=None, group=None):
        """``train`` and ``key`` are accepted for the branch interface; the
        GaitSet branch has no dropout.  ``group``: the data ranks whose
        tokens an MoE projection routes as one set (the global form of
        ``parallel/sharding.py``).  Returns the (B, P, D) parts, or with
        MoE (parts, aux loss)."""
        alpha = self.leaky_alpha

        def lrelu(v):
            return torch.maximum(v, alpha * v)

        mg = self.model_group

        def col(name, v):       # output channels split: copy in
            if name in self.tp_split:
                v = copy_in(v, mg)
            return getattr(self, name)(v)

        def row(name, v):       # input channels split: reduce out
            out = getattr(self, name)(v)
            return reduce_out(out, mg) if name in self.tp_split else out

        b, t, h, w, c = x.shape
        # (B, T, H, W, C) -> (B*T, C, H, W); cast before padding, as JAX.
        # Contiguous NCHW whatever the caller's strides (a contiguous
        # (B, T, H, W, C) volume would give a channels-last view): every
        # conv output then stays NCHW, the layout the stage tail takes
        x = x.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w).to(
            self.dtype, memory_format=torch.contiguous_format)
        p = self.pad
        x = F.pad(x, (p, p, p, p))

        # frame stream, stage 1
        a = lrelu(col("a_conv1", x))
        a = row("a_conv2", a)
        a, sa = stage_tail_cuda(a, b, alpha)           # (B*T, c1, 32, 32)

        # set stream, stage 1
        sq = self.seq_group
        sb = _group_max(sa, sq)
        sb = lrelu(col("b_conv1", sb))
        sb = row("b_conv2", sb)
        sb = lrelu(max_pool_2x2(sb))                   # (B, c2, 16, 16)

        # frame stream, stage 2
        a = lrelu(col("a_conv3", a))
        a = row("a_conv4", a)
        a, sa = stage_tail_cuda(a, b, alpha)           # (B*T, c2, 16, 16)

        sb = sb + _group_max(sa, sq)                    # residual add
        sb = lrelu(col("b_conv3", sb))
        sb = lrelu(row("b_conv4", sb))                 # (B, c3, 16, 16)

        # frame stream, stage 3 + final set pool
        a = lrelu(col("a_conv5", a))
        a = row("a_conv6", a)
        sa = lrelu(_set_max(a, b, sq))                  # (B, c3, 16, 16)

        sb = sb + sa

        feats = []
        for nb in self.hpp_bins:
            feats.append(_hpp(sa, nb))
            feats.append(_hpp(sb, nb))
        parts = torch.cat(feats, dim=1)                # (B, 62, c3)

        if self.moe_experts > 0:
            p, cdim = parts.shape[1], parts.shape[2]
            rows = b * (dist.get_world_size(group) if group is not None
                        else 1)
            cap = moe_capacity(rows * p, self.moe_experts,
                               self.moe_capacity_factor)
            out, aux, _ = moe_project(
                parts.reshape(b * p, cdim), self.router,
                self.expert_proj.to(self.dtype), cap, group=group,
                expert_group=self.expert_group,
                expert_start=self.expert_start)
            return out.reshape(b, p, -1), aux

        if self.part_range is not None:
            p0, p1 = self.part_range
            parts = copy_in(parts, mg)[:, p0:p1]
        # bf16 in, float32 accumulation and output (preferred_element_type)
        return torch.einsum("bpc,pcd->bpd", parts.to(self.dtype).float(),
                            self.part_proj.to(self.dtype).float())
