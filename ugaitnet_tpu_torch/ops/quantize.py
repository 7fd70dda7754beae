"""Int8 encode for every branch family (serving only, never in training).

Port of ``ugaitnet_tpu/ops/quantize.py``:

  * conv weights are int8 with per-output-channel scales
    (``quantize_weight``); each quantized conv's input scale is static,
    from a one-batch float32 calibration pass (``calibrate_*``) that
    records the abs-max of every quantized conv's input;
  * GaitSet: the frame stream (the B*T-sized hot path) stays int8 between
    its six convs; max pools and set pools run on int8 (max is exact under
    one positive scale); the set stream, HPP and the part projection stay
    float;
  * 2D / 3D CNN branches: the convs run int8 with the bias applied after
    the dequantization; ``dense`` and ``code`` stay float.

The quantized weights, scales and the layers that stay float are buffers
of ``nn.Module``s (``QuantizedNet``), so ``.to(device)`` and
``torch.export`` carry them.  Inside, int8 activations are channels-last,
as the JAX package's.

The int8 conv: JAX's ``lax.conv_general_dilated(...,
preferred_element_type=int32)`` accumulates exactly in int32, and no torch
conv does (``F.conv2d`` on int8 returns int8, wrapped).  ``QuantConv``
builds it from an im2col of the int8 input (strided windows by
``unfold``, laid out channels-last, so K runs over (kernel..., cin) as the
JAX kernel's HWIO / DHWIO rows do) and ``ops/knn.py:int8_mm``
(``torch._int_mm``), with K padded to a multiple of 8 and the rows chunked
so the im2col and its int32 product stay near ``IM2COL_BYTES``.

Rounding.  Requantization is ``clip(round(y / s), -127, 127)``, rounding
half to even in both packages.  Where XLA:CPU fuses a multiply and an add
into one fused multiply-add (the dequant + bias of the 2D / 3D convs, the
set stream's scaled residual add), the port rounds once through float64,
which holds the float32 product exactly.  The GaitSet part projection is
JAX's bf16 x bf16 einsum with float32 output: both operands are rounded to
bf16 and multiplied in float32 (bf16 x bf16 products are exact in
float32); TF32 must stay off for it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
from ugaitnet_tpu_torch.models import deepgaitv2 as DG
from ugaitnet_tpu_torch.models.branches import CONV3D_SPEC, _act
from ugaitnet_tpu_torch.models.gaitset import A_CONVS, B_CONVS
from ugaitnet_tpu_torch.ops import fusion
from ugaitnet_tpu_torch.ops.knn import int8_mm
from ugaitnet_tpu_torch.ops.pooling import max_pool_2x2
from ugaitnet_tpu_torch.ops.preprocess import frames_to_planes

# bytes of one chunk's im2col plus its int32 product
IM2COL_BYTES = 1 << 30


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(co, ...) conv / dense weight -> int8 weights in the same layout and
    per-output-channel (co,) scales (every axis but the first reduces)."""
    w = w.detach().to(torch.float32)
    s = torch.amax(w.abs(), dim=tuple(range(1, w.ndim))) / 127.0
    s = torch.clamp_min(s, 1e-12)
    shape = (-1,) + (1,) * (w.ndim - 1)
    wq = torch.clamp(torch.round(w / s.reshape(shape)), -127, 127)
    return wq.to(torch.int8), s


def requant(y: torch.Tensor, s_out: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y / s_out), -127, 127).to(torch.int8)


def maxpool_i8(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of a channels-last (N, H, W, C) map; odd
    extents drop their last row / column (VALID), as reduce_window does."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return torch.amax(x.reshape(n, h // 2, 2, w // 2, 2, c), dim=(2, 4))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA's fused multiply-add."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


class Frozen(nn.Module):
    """The float tensors of a layer that stays float, as buffers."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t.detach().to(torch.float32).clone())


class QuantConv(nn.Module):
    """An int8 conv over a channels-last int8 map, exact int32 sums.

    weight_q: (co, *kernel, ci) int8; kept as the (co, K) GEMM matrix, K
    padded to a multiple of 8.  w_scale (co,), in_scale (), bias (co,) or
    None.  ``same``: "SAME" zero padding (stride 1), else VALID."""

    def __init__(self, weight_q: torch.Tensor, w_scale: torch.Tensor,
                 in_scale, bias: Optional[torch.Tensor],
                 strides: Sequence[int], same: bool):
        super().__init__()
        co, *kernel, ci = weight_q.shape
        self.kernel = tuple(kernel)
        self.cin = ci
        self.strides = tuple(strides)
        self.same = same
        k = math.prod(kernel) * ci
        mat = weight_q.reshape(co, k)
        self.register_buffer("weight_q", F.pad(mat, (0, -(-k // 8) * 8 - k)))
        self.register_buffer("w_scale", w_scale.to(torch.float32).clone())
        self.register_buffer("in_scale", torch.as_tensor(
            in_scale, dtype=torch.float32).clone())
        self.register_buffer("bias", None if bias is None else
                             bias.detach().to(torch.float32).clone())

    def scale(self) -> torch.Tensor:
        """The int32 -> float32 factor per output channel."""
        return self.in_scale * self.w_scale

    def int32(self, q: torch.Tensor) -> torch.Tensor:
        """(n, *spatial, ci) int8 (already padded) -> (n, *out, co) int32."""
        nd = len(self.kernel)
        cols = q
        for d, (k, st) in enumerate(zip(self.kernel, self.strides)):
            cols = cols.unfold(1 + d, k, st)      # (n, *out, ci, *kernel)
        cols = cols.permute(0, *range(1, nd + 1), *range(nd + 2, 2 * nd + 2),
                            nd + 1)               # (n, *out, *kernel, ci)
        out = cols.shape[1:nd + 1]
        k, kp = math.prod(self.kernel) * self.cin, self.weight_q.shape[1]
        cols = F.pad(cols.reshape(-1, k), (0, kp - k))
        return int8_mm(cols, self.weight_q).reshape(q.shape[0], *out, -1)

    def forward(self, q: torch.Tensor,
                epilogue: Callable[[torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
        """q: (N, *spatial, ci) int8 -> epilogue(int32 sums), taken over
        chunks of N and concatenated."""
        if self.same:
            pads = []
            for k in reversed(self.kernel):
                pads += [(k - 1) // 2, k // 2]
            q = F.pad(q, [0, 0] + pads)
        out = [(s - k) // st + 1 for s, k, st in
               zip(q.shape[1:-1], self.kernel, self.strides)]
        per_row = math.prod(out) * (self.weight_q.shape[1]
                                    + 4 * self.weight_q.shape[0])
        chunk = max(1, IM2COL_BYTES // per_row)
        parts = [epilogue(self.int32(q[i:i + chunk]))
                 for i in range(0, q.shape[0], chunk)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _quant_conv(weight: torch.Tensor, bias: Optional[torch.Tensor],
                in_scale: float, strides: Sequence[int], same: bool
                ) -> QuantConv:
    """A float (co, ci, *kernel) conv weight -> its QuantConv."""
    wq, s = quantize_weight(weight)
    return QuantConv(wq.movedim(1, -1), s, in_scale, bias, strides, same)


class QuantizedNet(nn.Module):
    """``branches["branch_<m>"]``: each branch's quantized layers."""

    def __init__(self, branches: Dict[str, nn.Module]):
        super().__init__()
        self.branches = nn.ModuleDict(branches)


# ---------------------------------------------------------------------
# GaitSet


def _abs_scale(v: torch.Tensor) -> float:
    return float(torch.clamp_min(v.abs().amax() / 127.0, 1e-12))


@torch.no_grad()
def calibrate_branch(branch: nn.Module, x: torch.Tensor,
                     cfg: BranchConfig) -> Dict[str, float]:
    """One float32 forward of a GaitSet branch's frame stream over a
    calibration batch x (B, T, H, W, C), recording the abs-max of every
    frame-stream conv's INPUT: {conv_name: input_scale}."""
    alpha = cfg.leaky_alpha

    def lrelu(v):
        return torch.maximum(v, alpha * v)

    def conv(name, v):
        w = getattr(branch, name).weight.to(torch.float32)
        return F.conv2d(v, w, padding=w.shape[-1] // 2)

    b, t, h, w, c = x.shape
    x = F.pad(x.to(torch.float32), (0, 0, 2, 2, 2, 2))
    a = x.reshape(b * t, h + 4, w + 4, c).permute(0, 3, 1, 2)
    scales = {}
    scales["a_conv1"] = _abs_scale(a)
    a = lrelu(conv("a_conv1", a))
    scales["a_conv2"] = _abs_scale(a)
    a = max_pool_2x2(lrelu(conv("a_conv2", a)))
    scales["a_conv3"] = _abs_scale(a)
    a = lrelu(conv("a_conv3", a))
    scales["a_conv4"] = _abs_scale(a)
    a = max_pool_2x2(lrelu(conv("a_conv4", a)))
    scales["a_conv5"] = _abs_scale(a)
    a = lrelu(conv("a_conv5", a))
    scales["a_conv6"] = _abs_scale(a)
    return scales


def quantize_branch_params(branch: nn.Module, calib: Dict[str, float]
                           ) -> nn.Module:
    """A float GaitSet branch -> its quantized layers: the frame-stream
    convs int8 with their static input scales; the set-stream convs and
    the part projection stay float."""
    q = nn.Module()
    for name in A_CONVS:
        setattr(q, name, _quant_conv(getattr(branch, name).weight, None,
                                     calib[name], (1, 1), same=True))
    for name in B_CONVS:
        setattr(q, name, Frozen(weight=getattr(branch, name).weight))
    q.register_buffer("part_proj",
                      branch.part_proj.detach().to(torch.float32).clone())
    return q


def gaitset_branch_int8(qb: nn.Module, x: torch.Tensor,
                        cfg: BranchConfig) -> torch.Tensor:
    """Quantized mirror of GaitSetBranch.forward: (B, T, H, W, C) ->
    (B, parts, part_dim).  The frame stream runs int8; the set stream,
    HPP and the projection in float."""
    alpha = cfg.leaky_alpha

    def lrelu(v):
        return torch.maximum(v, alpha * v)

    def fconv(name, v):
        w = getattr(qb, name).weight
        return F.conv2d(v, w, padding=w.shape[-1] // 2)

    def stage(conv, nxt=None, pool=False):
        """dequant -> lrelu, then requant to the next conv's scale (and an
        int8 pool) or stay float (the last conv)."""
        def epilogue(y):
            v = lrelu(y.to(torch.float32) * conv.scale())
            if nxt is None:
                return v
            v = requant(v, nxt.in_scale)
            return maxpool_i8(v) if pool else v
        return epilogue

    def set_max(a):                       # (B*T, h, w, c) -> (B, h, w, c)
        return torch.amax(a.reshape(b, t, *a.shape[1:]), dim=1)

    b, t, h, w, c = x.shape
    x = F.pad(x.to(torch.float32), (0, 0, 2, 2, 2, 2))
    a0 = x.reshape(b * t, h + 4, w + 4, c)
    a1q = qb.a_conv1(requant(a0, qb.a_conv1.in_scale),
                     stage(qb.a_conv1, qb.a_conv2))
    a2q = qb.a_conv2(a1q, stage(qb.a_conv2, qb.a_conv3, pool=True))

    # set stream stage 1 (float, batch-sized): set-pool over int8, scale
    sb = set_max(a2q).to(torch.float32) * qb.a_conv3.in_scale
    sb = sb.permute(0, 3, 1, 2)
    sb = lrelu(fconv("b_conv1", sb))
    sb = lrelu(fconv("b_conv2", sb))
    sb = max_pool_2x2(sb)

    a3q = qb.a_conv3(a2q, stage(qb.a_conv3, qb.a_conv4))
    a4q = qb.a_conv4(a3q, stage(qb.a_conv4, qb.a_conv5, pool=True))

    # sb + max_T(a4q) * s, one rounding (XLA fuses it)
    sb = _fma(set_max(a4q).to(torch.float32), qb.a_conv5.in_scale,
              sb.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    sb = lrelu(fconv("b_conv3", sb))
    sb = lrelu(fconv("b_conv4", sb))

    a5q = qb.a_conv5(a4q, stage(qb.a_conv5, qb.a_conv6))
    a6 = qb.a_conv6(a5q, stage(qb.a_conv6))
    sa = set_max(a6)                                   # (B, hw, hw, c3)
    sb = sb.permute(0, 2, 3, 1) + sa

    hw2, c3 = sa.shape[1] * sa.shape[2], sa.shape[3]
    feats = []
    for nb in cfg.hpp_bins:
        for fmap in (sa, sb):
            strips = fmap.reshape(b, nb, hw2 // nb, c3)
            feats.append(strips.mean(dim=2) + strips.amax(dim=2))
    parts = torch.cat(feats, dim=1)

    def bf16(v):
        return v.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("bpc,pcd->bpd", bf16(parts), bf16(qb.part_proj))


# ---------------------------------------------------------------------
# 2D / 3D CNN branches


def _dequant_bias(y: torch.Tensor, conv: QuantConv) -> torch.Tensor:
    """int32 sums -> y * (in_scale * w_scale) + bias, one rounding."""
    return _fma(y.to(torch.float32), conv.scale(), conv.bias)


def _sequential_int8(convs: Sequence[QuantConv], q: torch.Tensor,
                     act, pool: bool) -> torch.Tensor:
    """Run int8 convs with requant (and an int8 pool, 2D) between them;
    the last conv's output stays float."""
    for i, conv in enumerate(convs):
        nxt = convs[i + 1] if i + 1 < len(convs) else None

        def epilogue(y, conv=conv, nxt=nxt):
            v = act(_dequant_bias(y, conv))
            if nxt is None:
                return v
            v = requant(v, nxt.in_scale)
            return maxpool_i8(v) if pool else v
        q = conv(q, epilogue)
    return q


@torch.no_grad()
def calibrate_conv2d_branch(branch: nn.Module, x: torch.Tensor,
                            cfg: BranchConfig) -> Dict[str, float]:
    """float32 forward over a calibration volume x (B, T, H, W, C) (the
    branch reads its (B, T*C, H, W) planes) recording each conv's INPUT
    abs-max."""
    act = _act(cfg.activation, cfg.leaky_alpha)
    v = frames_to_planes(x.to(torch.float32))
    n = len(cfg.filters_numbers)
    scales = {}
    for i in range(n):
        scales[f"conv{i}"] = _abs_scale(v)
        conv = getattr(branch, f"conv{i}")
        v = act(F.conv2d(v, conv.weight.to(torch.float32),
                         conv.bias.to(torch.float32)))
        if i != n - 1:
            v = max_pool_2x2(v)
    return scales


@torch.no_grad()
def calibrate_conv3d_branch(branch: nn.Module, x: torch.Tensor,
                            cfg: BranchConfig) -> Dict[str, float]:
    """float32 forward over x (B, T, H, W, C) recording each strided
    conv's INPUT abs-max (``CONV3D_SPEC``)."""
    act = _act(cfg.activation, cfg.leaky_alpha)
    v = x.to(torch.float32).permute(0, 4, 1, 2, 3)
    scales = {}
    for i, (_, _, s) in enumerate(CONV3D_SPEC):
        scales[f"conv{i}"] = _abs_scale(v)
        conv = getattr(branch, f"conv{i}")
        v = act(F.conv3d(v, conv.weight.to(torch.float32),
                         conv.bias.to(torch.float32), stride=s))
    return scales


def quantize_sequential_branch_params(branch: nn.Module,
                                      calib: Dict[str, float]) -> nn.Module:
    """A float 2D / 3D CNN branch -> its quantized layers: the calibrated
    convs int8 (biases float, applied after the dequantization); ``dense``
    and ``code`` stay float."""
    q = nn.Module()
    for name, mod in branch.named_children():
        if name in calib:
            setattr(q, name, _quant_conv(mod.weight, mod.bias, calib[name],
                                         mod.strides, same=False))
        else:
            setattr(q, name, Frozen(weight=mod.weight, bias=mod.bias))
    return q


def _convs(qb: nn.Module) -> list:
    return [m for m in qb.children() if isinstance(m, QuantConv)]


def conv2d_branch_int8(qb: nn.Module, x: torch.Tensor,
                       cfg: BranchConfig) -> torch.Tensor:
    """Quantized mirror of Conv2DBranch.forward (inference, no dropout):
    (B, T, H, W, C) -> (B, ndense_units)."""
    act = _act(cfg.activation, cfg.leaky_alpha)
    convs = _convs(qb)
    v = frames_to_planes(x.to(torch.float32)).permute(0, 2, 3, 1)
    y = _sequential_int8(convs, requant(v, convs[0].in_scale), act,
                         pool=True)
    v = y.reshape(y.shape[0], -1)                 # (h, w, c), as JAX's
    v = F.linear(v, qb.dense.weight, qb.dense.bias)
    return F.linear(v, qb.code.weight, qb.code.bias)


def conv3d_branch_int8(qb: nn.Module, x: torch.Tensor,
                       cfg: BranchConfig) -> torch.Tensor:
    """Quantized mirror of Conv3DBranch.forward: the six strided convs run
    int8, the 1x1x1 code conv float: (B, T, H, W, C) -> (B, -1)."""
    act = _act(cfg.activation, cfg.leaky_alpha)
    convs = _convs(qb)
    y = _sequential_int8(convs, requant(x.to(torch.float32),
                                        convs[0].in_scale), act, pool=False)
    w = qb.code.weight
    code = F.linear(y, w.reshape(w.shape[0], -1), qb.code.bias)
    return code.reshape(code.shape[0], -1)


# ---------------------------------------------------------------------
# the whole net


def quantize_model_params(model: nn.Module, mcfg: ModelConfig,
                          calib_volumes: Sequence) -> QuantizedNet:
    """Calibrate and quantize every branch of a UGaitNet, on its device.

    calib_volumes: one representative (B, T, H, W, C_i) batch per branch
    (arrays or tensors)."""
    dev = model.device
    DG.refuse(mcfg, "int8")
    if mcfg.has_moe:
        raise ValueError("the int8 encode has the per-part projection only, "
                         "as the JAX package's; an MoE part projection "
                         "encodes in float32")
    out = {}
    for bcfg, vol in zip(mcfg.branches, calib_volumes):
        key = f"branch_{bcfg.modality}"
        branch = model.branches[key]
        x = torch.as_tensor(vol).to(dev)
        if bcfg.kind == "gaitset":
            out[key] = quantize_branch_params(
                branch, calibrate_branch(branch, x, bcfg))
        elif bcfg.kind == "conv2d":
            out[key] = quantize_sequential_branch_params(
                branch, calibrate_conv2d_branch(branch, x, bcfg))
        elif bcfg.kind == "conv3d":
            out[key] = quantize_sequential_branch_params(
                branch, calibrate_conv3d_branch(branch, x, bcfg))
        else:
            raise ValueError(f"unknown branch kind {bcfg.kind!r}")
    return QuantizedNet(out).to(dev)


BRANCH_INT8 = {"gaitset": gaitset_branch_int8,
               "conv2d": conv2d_branch_int8,
               "conv3d": conv3d_branch_int8}


def encode_int8(qnet: QuantizedNet, volumes: Sequence[torch.Tensor],
                use_flags: Sequence[torch.Tensor], mcfg: ModelConfig
                ) -> torch.Tensor:
    """Quantized encode -> per-sample flattened signature (the typecode-3
    embedding) with the per-sample L2 of serving."""
    embeddings = [
        fusion.gate(BRANCH_INT8[b.kind](qnet.branches[f"branch_{b.modality}"],
                                        volumes[i], b), use_flags[i])
        for i, b in enumerate(mcfg.branches)]
    sig = fusion.signature(fusion.MERGES[mcfg.merge](embeddings),
                           l2_mode="feature")
    return sig.reshape(sig.shape[0], -1)
