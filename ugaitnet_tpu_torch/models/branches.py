"""Per-modality encoder branches: the 2D CNN and the strided 3D CNN.

Port of ``ugaitnet_tpu/models/branches.py``, the reference paper's own
per-modality branches, as ``nn.Module``s that run NCHW / NCDHW inside:

  * ``Conv2DBranch`` reads the (B, T*C, H, W) plane stack: 4 VALID convs
    with bias, each followed by the activation and, between convs, a 2x2
    max pool; then Flatten -> Dense(2d) -> Dropout -> Dense(d) ("code").
    The JAX branch flattens its last NHWC map in (h, w, c) order, so the
    port permutes to channels-last before the flatten and the ``dense``
    weight keeps the JAX kernel's row order.
  * ``Conv3DBranch`` reads (B, T, H, W, C): the six strided VALID convs of
    ``CONV3D_SPEC``, then a 1x1x1 conv to ``ndense_units`` ("code"),
    flattened channels-last (at 25 x 60 x 60 the last map is 1 x 1 x 1).

Initializers are Keras's, as flax gives them: glorot-uniform kernels (fans
include the receptive field), he-uniform on ``code``, zero biases, drawn
from the model's ``torch.Generator``.  With ``dtype=torch.bfloat16`` the
inputs, weights and biases are cast to bf16 at each layer, as flax's
``dtype=`` does; the branch output is float32.

Dropout (Conv2DBranch, train mode only) draws its keep-mask from a
generator seeded from (the branch's seed, the caller's ``key``), never from
the global RNG.  The train step passes its step count as the key, as the
JAX step folds ``state.step`` into its dropout key, so a run resumed from a
checkpoint draws the masks an uninterrupted run draws.  Its bits cannot
match JAX's key stream (ROADMAP.md section 3), so parity runs in eval mode
or with dropout 0.

Under data parallelism (``parallel/sharding.py``) the key is a
``ShardKey`` in the global form, so that each rank draws the global
batch's mask and keeps its own rows, bitwise the one-process mask; the
per-shard form folds the data index into the key (``fold_key``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ugaitnet_tpu_torch.core.config import FRAME_H, FRAME_W
from ugaitnet_tpu_torch.models.gaitset import glorot_
from ugaitnet_tpu_torch.ops.cuda import conv3d_route
from ugaitnet_tpu_torch.ops.pooling import max_pool_2x2

# (filters, kernel, strides), mj_uwyhNets_ba.py:347-363; shared with the
# int8 mirror (ops/quantize.py:conv3d_branch_int8)
CONV3D_SPEC = (
    (64, (3, 5, 5), (1, 2, 2)),
    (128, (3, 3, 3), (1, 2, 2)),
    (256, (3, 3, 3), (2, 2, 2)),
    (512, (3, 3, 3), (2, 2, 2)),
    (512, (3, 2, 2), (1, 1, 1)),
    (512, (2, 1, 1), (1, 1, 1)),
)


def _act(activation: str, alpha: float) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    if activation == "relu":
        return torch.relu
    # max(x, a*x) == leaky_relu exactly for 0 <= a < 1
    return lambda x: torch.maximum(x, alpha * x)


def he_uniform_(t: torch.Tensor, fan_in: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's he_uniform: U(-sqrt(6 / fan_in), +sqrt(6 / fan_in))."""
    limit = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """A dropout layer's seed, drawn from the model's generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


class ShardKey(NamedTuple):
    """A dropout key for one rank's rows of a global batch: masks are drawn
    for ``rows`` rows under ``key``, and the rank keeps rows [start, start
    + its batch)."""
    key: int
    rows: int
    start: int


DropKey = Union[int, ShardKey]


def fold_key(key: int, index: int) -> int:
    """A key of its own for shard ``index`` (the JAX ``fold_in``)."""
    return hash((int(key), int(index))) % 2 ** 62


def keyed_dropout(x: torch.Tensor, rate: float, seed: int,
                  key: Optional[DropKey]) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - rate, kept values divided
    by it.  The mask is a function of (the layer's seed, key) alone, drawn
    from a generator of its own, so the global RNG is left as it is and a
    recompute (remat) or a resumed run draws the same mask.  A ``ShardKey``
    draws the global batch's mask and keeps this shard's rows."""
    if key is None:
        raise ValueError("train-mode dropout needs a key (the train step "
                         "passes its step count)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape, start = x.shape, 0
    if isinstance(key, ShardKey):
        shape, start = (key.rows, *x.shape[1:]), key.start
        key = key.key
    gen = torch.Generator(device=x.device).manual_seed(
        hash((seed, int(key))) % 2 ** 63)
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    mask = mask[start:start + x.shape[0]]
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Conv(nn.Module):
    """Conv over NCHW (2D) or NCDHW (3D); weight OIHW / OIDHW.  VALID with
    bias unless ``padding`` (zeros on each side of every spatial dim) or
    ``bias=False`` say otherwise (DeepGaitV2's convs: padding 1, no bias).
    ``he``: he-uniform kernel (the ``code`` layer), else glorot.  A VALID
    3D conv with a bias trained in float32 on a card goes through
    ``conv3d_route.conv3d`` where a hand gradient kernel's rule takes it
    (``conv3d_route.hand_grads``): its weight and bias gradients with few
    taps a output channel (``ops/cuda/conv3d_wgrad.py:fits``: the first
    conv of the 3D CNN), its input gradient where its input needs one and
    is large enough (``ops/cuda/conv3d_dgrad.py:fits``: conv1-conv4)."""

    def __init__(self, ci: int, co: int, kernel: Sequence[int],
                 strides: Sequence[int], dtype: torch.dtype,
                 generator: Optional[torch.Generator], he: bool = False,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        rf = math.prod(kernel)
        w = torch.empty((co, ci, *kernel))
        if he:
            he_uniform_(w, rf * ci, generator)
        else:
            glorot_(w, rf * ci, rf * co, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(co)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x, w = x.to(dt), self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        hand = conv3d_route.hand_grads(x, w, b, self.padding)
        if any(hand):
            return conv3d_route.conv3d(x, w, b, self.strides, hand)
        conv = F.conv3d if w.ndim == 5 else F.conv2d
        return conv(x, w, b, stride=self.strides, padding=self.padding)


class Dense(nn.Linear):
    """Linear layer with flax's init (glorot, or he-uniform) and dtype."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator], he: bool = False):
        super().__init__(n_in, n_out)
        self.dtype = dtype
        if he:
            he_uniform_(self.weight, n_in, generator)
        else:
            glorot_(self.weight, n_in, n_out, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv2d_output_hw(hw: Tuple[int, int], sizes: Sequence[int]
                     ) -> Tuple[int, int]:
    """Spatial extent of Conv2DBranch's last map: VALID convs, 2x2 pools
    (floor) between them."""
    h, w = hw
    for i, k in enumerate(sizes):
        h, w = h - k + 1, w - k + 1
        if i != len(sizes) - 1:
            h, w = h // 2, w // 2
    return h, w


class Conv2DBranch(nn.Module):
    """(B, T*C, H, W) planes -> (B, ndense_units)."""

    def __init__(self, in_planes: int,
                 filters_numbers: Sequence[int] = (64, 128, 512, 512),
                 filters_size: Sequence[int] = (7, 5, 3, 2),
                 ndense_units: int = 512, dropout: float = 0.4,
                 activation: str = "leaky", leaky_alpha: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _act(activation, leaky_alpha)
        self.dropout = dropout
        self.convs = len(filters_numbers)
        ci = in_planes
        for i, (f, k) in enumerate(zip(filters_numbers, filters_size)):
            setattr(self, f"conv{i}", Conv(ci, f, (k, k), (1, 1), dtype,
                                           generator))
            ci = f
        h, w = conv2d_output_hw((FRAME_H, FRAME_W), filters_size)
        self.dense = Dense(h * w * ci, 2 * ndense_units, dtype, generator)
        self.code = Dense(2 * ndense_units, ndense_units, dtype, generator,
                          he=True)
        # the dropout masks' seed, from the model's generator
        self._drop_seed = draw_seed(generator)

    def _dropout(self, x: torch.Tensor, key: Optional[int]) -> torch.Tensor:
        return keyed_dropout(x, self.dropout, self._drop_seed, key)

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[int] = None) -> torch.Tensor:
        for i in range(self.convs):
            x = self.act(getattr(self, f"conv{i}")(x))
            if i != self.convs - 1:
                x = max_pool_2x2(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        x = self.dense(x)
        if train and self.dropout > 0.001:
            x = self._dropout(x, key)
        return self.code(x).to(torch.float32)


class Conv3DBranch(nn.Module):
    """Strided 3D CNN over (B, T, H, W, C) -> (B, ndense_units)."""

    def __init__(self, in_channels: int, ndense_units: int = 512,
                 activation: str = "relu", leaky_alpha: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _act(activation, leaky_alpha)
        ci = in_channels
        for i, (f, k, s) in enumerate(CONV3D_SPEC):
            setattr(self, f"conv{i}", Conv(ci, f, k, s, dtype, generator))
            ci = f
        self.code = Conv(ci, ndense_units, (1, 1, 1), (1, 1, 1), dtype,
                         generator, he=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                key: Optional[int] = None) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)                  # -> (B, C, T, H, W)
        for i in range(len(CONV3D_SPEC)):
            x = self.act(getattr(self, f"conv{i}")(x))
        x = self.code(x)
        # channels-last flatten, as the JAX branch's NDHWC reshape
        return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1).to(
            torch.float32)

