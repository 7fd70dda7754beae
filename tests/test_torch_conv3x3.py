"""The port's 3x3 bf16 convolution (``ops/conv3x3.py``), its dispatcher
(``ops/cuda/conv3x3.py``) and the GEMM / copy probes (``ops/cuda/
probes.py``) against the TPU kernels they replace and the JAX package, on
the CPU.

- ``benchmarks/proto_conv.py:_p1_kernel`` (a_conv6's shape, 8 frames, one
  grid step) and ``_p2_kernel`` (a_conv2's, 2 frames) run in test-local
  ``pl.pallas_call``s with their launchers' index maps, in interpret mode,
  on numpy-seeded bf16 inputs in their own layouts (19x19 zero-padded rows;
  the W4 phase packing, weights packed as ``p2_check_and_bench`` packs
  them).  The plain ``conv3x3`` is held to them per element (the limit
  below): all columns of _p1_kernel, columns 4:60 of _p2_kernel, and on
  every column to ``lax.conv_general_dilated`` (float32 accumulation, one
  rounding).  One test shows _p2_kernel's border columns wrong on that
  input, which is why its comparison leaves them out.
- ``_mm_kernel`` (M = 128, mt = 64, K = 576) against ``probes.mm_plain``
  within the same limit, ``_copy_kernel`` against ``probes.scale2_plain``
  bitwise.
- The kernels' launch geometry: ``plan`` (variant, tile, grid, ring,
  shared memory) and the schedule each persistent CTA walks, replayed in
  plain torch (the TMA boxes' addressing, zeros out of bounds): every
  output element written once, the result bitwise ``conv3x3`` /
  ``mm_plain``; ``scale2_plan`` likewise over n and x / y offsets (head,
  body and tail of the vec variant, or the scalar variant's values),
  bitwise ``scale2_plain``.  The walks here mirror the kernels'
  (``csrc/conv3x3.cu``,
  ``csrc/probes.cu``), so the replay checks that the schedule covers the
  output; that the kernels walk it so, only the card tests
  (``test_torch_cuda.py``) check.
- The dispatcher: a CPU tensor takes the plain version with no launch;
  the custom op's fake gives shapes and refuses what the kernel refuses;
  with a CPU stand-in for the op's kernel, registered by this file only,
  ``torch.export`` of a bf16 GaitSet branch without autograd records
  ``ugaitnet::conv3x3`` (twice) through a save and a load.  The branch
  routes a_conv2 and a_conv6 to the dispatcher only in bf16 without
  autograd.
- The tiny flagship in bf16 (``__graft_entry__._flagship_cfg(tiny=True)``,
  weights carried by ``utils/weights.py``), the port's forward without
  autograd (plain ``conv3x3`` at a_conv2 / a_conv6) against the JAX
  package's bf16 forward, and against the port's own ``F.conv2d`` route.

Tolerances.  Wherever a conv or product is compared alone, per element
|a - b| <= ulp(b) + 2^-12 S, S = (|x| conv |w|) (or |x| @ |w|) in float32,
the limit ``chip_smoke.py`` holds the CUDA kernel to: both sides sum exact
bf16 products in float32 in other orders, and the one rounding to bf16 may
then land one ulp apart; where the sum cancels to far below S, the float32
sums themselves differ by more than the result's ulp (a value of -3.2e-6
with S = 7.7 lands two ulps apart).  The counts of elements that differ
and that differ by more than one ulp are measured and asserted below.
The whole bf16
forward: each of its ten bf16 convs and its bf16 leaky ReLUs rounds, so a
one-ulp difference at one layer is carried through the rest;
BF16_FWD_REL below holds the merge's inputs (the gated branch outputs)
and the net's outputs, the port's merge taking JAX's sign_max picks, on
max |a - b| / max |b|; a pick the port would take otherwise must lie
within twice the inputs' difference of a tie (the rule of
``chip_smoke.py:sign_max_rule``).  Both nets get leaky_alpha = bf16(0.3) =
0.30078125: JAX rounds the weak-typed 0.3 to bf16 before it multiplies,
torch multiplies by float32 0.3 (ROADMAP §3), so with 0.3 the two would
differ on every negative activation by design.  XLA:CPU has no bf16 x
bf16 -> float32 dot for the JAX part projection; as in
``test_torch_quantize.py`` a test-local patch gives JAX the same product
on float32 copies of the bf16 operands.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from jax.experimental import pallas as pl

import __graft_entry__ as graft
from benchmarks import proto_conv as PC
from benchmarks.proto_mm import _copy_kernel, _mm_kernel
from ugaitnet_tpu.models import gaitset as JG
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models import gaitset as GS
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops.conv3x3 import conv3x3
from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
from ugaitnet_tpu_torch.ops.cuda import probes as PR
from ugaitnet_tpu_torch.ops.pooling import stage_tail
from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict

torch.set_num_threads(1)

ALPHA_BF16 = 0.30078125          # bf16(0.3)
# the bf16 forward, port vs JAX and port vs its F.conv2d route: max |a - b|
# <= BF16_FWD_REL * max |b| for the sign_max merge's inputs and for each
# output with JAX's picks; measured at most 4.1e-3 (the values at each test;
# see the module docstring)
BF16_FWD_REL = 1e-2


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.array(jnp.asarray(v).astype(jnp.float32))


def _ulp(v):
    """bf16 spacing at |v| (v holds bf16 values), 0 at 0."""
    m, e = np.frexp(np.abs(v).astype(np.float32))
    return np.where(v == 0, 0.0, np.ldexp(1.0, e - 8))


def _apart(got, want, s):
    """(elements that differ, elements more than one ulp of want apart,
    max |got - want| / (ulp(want) + 2^-12 s): the limit is 1)."""
    got, want = _np(got), _np(want)
    d = np.abs(got - want)
    ulp = _ulp(want)
    lim = ulp + 2.0 ** -12 * s
    of_limit = np.where(d == 0, 0.0, d / np.where(lim == 0, 1e-30, lim))
    return int((d != 0).sum()), int((d > ulp).sum()), float(of_limit.max())


def _conv_abs(x, wk):
    """S of an NHWC / HWIO pair, NHWC."""
    return F.conv2d(_nchw(x).float().abs(), _oihw(wk).float().abs(),
                    padding=1).permute(0, 2, 3, 1).numpy()


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(
        _np(x_nhwc).transpose(0, 3, 1, 2))).to(torch.bfloat16)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        _np(w_hwio).transpose(3, 2, 0, 1))).to(torch.bfloat16)


def _lax_conv(x, wk):
    """The prototypes' own reference: float32 accumulation, one rounding."""
    return lax.conv_general_dilated(
        x, wk, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16)


def _inputs(m, h, c, seed):
    rng = np.random.RandomState(seed)
    x = jnp.asarray((rng.randn(m, h, h, c) * .1).astype(np.float32)
                    ).astype(jnp.bfloat16)
    wk = jnp.asarray((rng.randn(3, 3, c, c) * .1).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return x, wk


# ---- _p1_kernel (a_conv6's shape) -----------------------------------------
def pallas_p1(x_pad, w9, nf=8):
    """``proto_conv.p1_conv`` with interpret=True and no VMEM space."""
    m = x_pad.shape[0] // PC.FR
    return pl.pallas_call(
        functools.partial(PC._p1_kernel, nf=nf),
        grid=(m // nf,),
        in_specs=[pl.BlockSpec((nf * PC.FR, 128), lambda i: (i, 0)),
                  pl.BlockSpec((9, 128, 128), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((nf * PC.ACC, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m * PC.ACC, 128), jnp.bfloat16),
        interpret=True,
    )(x_pad, w9)


@pytest.fixture(scope="module")
def p1_case():
    m = 8
    x, wk = _inputs(m, 16, 128, seed=0)
    xp = jnp.zeros((m, 19, 19, 128), jnp.bfloat16)
    xp = xp.at[:, 1:17, 1:17, :].set(x).reshape(m * PC.FR, 128)
    out = pallas_p1(xp, wk.reshape(9, 128, 128))
    got = out.reshape(m, 16, 19, 128)[:, :, :16, :]
    return x, wk, got


def test_p1_kernel_matches_conv3x3(p1_case):
    x, wk, proto = p1_case
    y = conv3x3(_nchw(x), _oihw(wk))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (8, 128, 16, 16)
    n, n_over, of_limit = _apart(y.permute(0, 2, 3, 1), proto,
                                 _conv_abs(x, wk))
    # measured: 25 of 262,144 elements differ, 1 by two ulps (-3.19e-6
    # against -3.22e-6, S = 7.66); 0.53 of the limit
    assert of_limit <= 1.0 and n <= 64 and n_over <= 4


def test_p1_kernel_matches_lax_conv(p1_case):
    """The prototype's own check, in interpret mode: every column."""
    x, wk, proto = p1_case
    n, n_over, of_limit = _apart(proto, _lax_conv(x, wk), _conv_abs(x, wk))
    assert of_limit <= 1.0 and n <= 64 and n_over <= 4


# ---- _p2_kernel (a_conv2's shape) -----------------------------------------
def pallas_p2(xw4, w9, nf=2):
    """``proto_conv.p2_conv`` with interpret=True and no VMEM space."""
    m = xw4.shape[0] // PC.P2FR
    return pl.pallas_call(
        functools.partial(PC._p2_kernel, nf=nf),
        grid=(m // nf,),
        in_specs=[pl.BlockSpec((nf * PC.P2FR, 128), lambda i: (i, 0)),
                  pl.BlockSpec((9, 128, 128), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((nf * 1024, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m * 1024, 128), jnp.bfloat16),
        interpret=True,
    )(xw4, w9)


def _p2_weights(wk):
    """``p2_check_and_bench``'s packing: W[di*3+gs][(pin,ci),(p,co)] =
    w[di, 4*(gs-1)+pin-p+1, ci, co]."""
    w9 = np.zeros((9, 4, 32, 4, 32), np.float32)
    wnp = _np(wk)
    for di in range(3):
        for gs in range(3):
            for pin in range(4):
                for p in range(4):
                    dj = 4 * (gs - 1) + pin - p + 1
                    if 0 <= dj < 3:
                        w9[di * 3 + gs, pin, :, p, :] = wnp[di, dj]
    return jnp.asarray(w9.reshape(9, 128, 128)).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def p2_case():
    m = 2
    x, wk = _inputs(m, 64, 32, seed=1)
    xw4 = jnp.zeros((m, PC.P2I, PC.P2G, 128), jnp.bfloat16)
    xw4 = xw4.at[:, 2:66, :, :].set(x.reshape(m, 64, PC.P2G, 128))
    out = pallas_p2(xw4.reshape(m * PC.P2FR, 128), _p2_weights(wk))
    return x, wk, out.reshape(m, 64, 64, 32)


def test_p2_kernel_matches_conv3x3_interior(p2_case):
    x, wk, proto = p2_case
    y = conv3x3(_nchw(x), _oihw(wk)).permute(0, 2, 3, 1)
    assert tuple(y.shape) == (2, 64, 64, 32)
    n, n_over, of_limit = _apart(y[:, :, 4:60], proto[:, :, 4:60],
                                 _conv_abs(x, wk)[:, :, 4:60])
    # measured: 23 of 229,376 differ, 1 by more than an ulp; 0.70 of
    # the limit
    assert of_limit <= 1.0 and n <= 64 and n_over <= 4


def test_conv3x3_matches_lax_conv_every_column(p2_case, p1_case):
    for x, wk, _ in (p2_case, p1_case):
        y = conv3x3(_nchw(x), _oihw(wk)).permute(0, 2, 3, 1)
        n, n_over, of_limit = _apart(y, _lax_conv(x, wk), _conv_abs(x, wk))
        # measured: 36 / 34 of 262,144 differ, 2 / 1 by more than an ulp;
        # 0.80 / 0.53 of the limit
        assert of_limit <= 1.0 and n <= 64 and n_over <= 4


def test_p2_kernel_border_columns_are_wrong(p2_case):
    """At g = 0 and g = 15 its edge taps read the neighbouring row's
    groups (proto_conv.py:174-182): columns 0 and 63 are far off the
    conv, on every row but the first / last, while columns 4:60 agree."""
    x, wk, proto = p2_case
    want = _np(_lax_conv(x, wk))
    got = _np(proto)
    scale = np.abs(want).max()
    for col in (0, 63):
        err = np.abs(got[:, :, col] - want[:, :, col]).max()
        assert err > 0.05 * scale, col
    assert np.abs(got[:, :, 4:60] - want[:, :, 4:60]).max() < 0.01 * scale


# ---- the probes ------------------------------------------------------------
def test_mm_kernel_matches_mm_plain():
    """_mm_kernel at M = 128, mt = 64, K = 576 (4 weight blocks: the
    prototype reads 4 x 128 of x's 576 columns)."""
    m, mt, kk = 128, 64, 576
    rng = np.random.RandomState(2)
    x = jnp.asarray((rng.randn(m, kk) * .1).astype(np.float32)).astype(
        jnp.bfloat16)
    w = jnp.asarray((rng.randn(kk // 128, 128, 128) * .1).astype(
        np.float32)).astype(jnp.bfloat16)
    proto = pl.pallas_call(
        functools.partial(_mm_kernel, nk=kk // 128),
        grid=(m // mt,),
        in_specs=[pl.BlockSpec((mt, kk), lambda i: (i, 0)),
                  pl.BlockSpec((kk // 128, 128, 128), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((mt, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, 128), jnp.bfloat16),
        interpret=True,
    )(x, w)
    xt = torch.from_numpy(_np(x)).to(torch.bfloat16)
    wt = torch.from_numpy(_np(w)).to(torch.bfloat16)
    PR.reset_launch_counts()
    got = PR.mm_fwd(xt, wt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, 128)
    assert torch.equal(got, PR.mm_plain(xt, wt))
    s = (xt[:, :512].float().abs() @ wt.reshape(512, 128).float().abs()
         ).numpy()
    n, n_over, of_limit = _apart(got, proto, s)
    # measured: 2 of 16,384 differ, by one ulp; 0.005 of the limit
    assert of_limit <= 1.0 and n_over <= 4
    # x's last 64 columns are not read, by the prototype or the port
    xt2 = xt.clone()
    xt2[:, 512:] = 7.0
    assert torch.equal(PR.mm_fwd(xt2, wt), got)
    assert PR.mm_launches == 0


def test_copy_kernel_matches_scale2_bitwise():
    """_copy_kernel on the (T*H*W*C, B) batch-minor view of a small
    (B, T, H, W, C) bf16 tensor, as ``proto_mm.e2`` launches it."""
    b, t, h = 8, 3, 4
    rng = np.random.RandomState(3)
    v = jnp.asarray(rng.randn(b, t, h, h, h).astype(np.float32)
                    ).astype(jnp.bfloat16)
    flat = jnp.transpose(v, (1, 2, 3, 4, 0)).reshape(t * h ** 3, b)
    blk = 32
    proto = pl.pallas_call(
        _copy_kernel, grid=(t * h ** 3 // blk,),
        in_specs=[pl.BlockSpec((blk, b), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((blk, b), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((t * h ** 3, b), jnp.bfloat16),
        interpret=True,
    )(flat)
    xt = torch.from_numpy(_np(v)).to(torch.bfloat16).permute(
        1, 2, 3, 4, 0).contiguous().view(t * h ** 3, b)
    PR.reset_launch_counts()
    got = PR.scale2(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(proto))
    assert torch.equal(got, PR.scale2_plain(xt))
    assert PR.scale2_launches == 0


# ---- the dispatcher and the op ---------------------------------------------
def test_dispatcher_cpu_route_counts_no_launch():
    CV.reset_launch_counts()
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 7, 5, 6).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.randn(5, 7, 3, 3).astype(np.float32))
    got = CV.conv3x3_cuda(x, w)
    want = F.conv2d(x.float(), w.to(torch.bfloat16).float(),
                    padding=1).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert CV.launches == 0


@pytest.mark.parametrize("n, ci, co, h, w, plan", [
    (3200, 128, 128, 16, 16, ("hopper", 8, 16, 64, 132, 4)),    # a_conv6
    (3200, 32, 32, 64, 64, ("hopper", 4, 64, 32, 132, 4)),      # a_conv2
    (3200, 64, 128, 16, 16, ("hopper", 8, 16, 64, 132, 4)),     # TP halves
    (3200, 16, 32, 64, 64, ("hopper", 4, 64, 32, 132, 4)),
    (3, 7, 5, 5, 5, ("general", 5, 5, 32, 3, 1)),               # ragged
    (1, 33, 130, 17, 130, ("general", 1, 128, 128, 68, 1)),     # W > 128
])
def test_launch_plan(n, ci, co, h, w, plan):
    """The variant and its tile, output channels a CTA, grid and ring
    depth; the shared memory the kernel's formula asks for, under the
    H100's.  Hopper: tiles of whole rows of 64, 128 or 256 pixels, one
    persistent CTA an SM, a grid that keeps each CTA on one Co tile.
    General: tiles of at most 128 pixels (whole rows where a row fits),
    one CTA a tile and Co tile."""
    p = CV.plan(n, ci, co, h, w)
    assert (p.variant, p.tr, p.tw, p.bn, p.grid, p.stages) == plan
    # 232,448 bytes: the dynamic shared memory of an H100 CTA
    assert p.smem <= 232_448
    if p.variant == "hopper":
        assert p.tw == w and p.tr * p.tw in (64, 128, 256)
        assert p.grid <= CV.SMS and p.grid % p.n_co == 0
        assert p.smem == CV.hopper_smem(p.tr, w, p.bn, p.cc,
                                        -(-ci // p.cc), p.stages)
    else:
        assert p.tr * p.tw <= CV.TILE_PIXELS
        assert p.smem == (9 * p.bn + (p.tr + 2) * (p.tw + 2)) * 80
    assert p.wp_numel == 9 * (-(-co // p.bn) * p.bn) * (-(-ci // p.cc) *
                                                         p.cc)


@pytest.mark.parametrize("n, ci, co, h, w", [
    (3200, 128, 128, 16, 16), (3200, 32, 32, 64, 64)])
def test_plan_without_tma_takes_general(n, ci, co, h, w):
    """Where the Hopper variant may not run (an x that does not start on a
    16-byte boundary, or ``launch(..., general=True)``), the flagship
    shapes plan the general variant: tiles of 128 pixels in whole rows,
    one CTA a tile and Co tile."""
    p = CV.plan(n, ci, co, h, w, hopper=False)
    assert p.variant == "general" and p.stages == 1
    assert p.tw == w and p.tr * p.tw == CV.TILE_PIXELS
    assert p.grid == n * p.tiles_h * p.tiles_w * p.n_co


def _conv_walk(p, cta):
    """(n, row0, col0, co0) of each tile CTA ``cta`` computes, in the order
    the kernels take them, as ``csrc/conv3x3.cu`` walks them.  Hopper: CTA
    c keeps Co tile c % n_co and walks tiles c // n_co, + grid // n_co, ...
    (its consumer warpgroups take them in turn).  General: one tile and
    Co tile a CTA, the Co tile fastest."""
    if p.variant == "hopper":
        co0 = (cta % p.n_co) * p.bn
        for t in range(cta // p.n_co, p.n * p.tiles_h, p.grid // p.n_co):
            yield t // p.tiles_h, (t % p.tiles_h) * p.tr, 0, co0
        return
    tile, co0 = cta // p.n_co, (cta % p.n_co) * p.bn
    per_frame = p.tiles_h * p.tiles_w
    t = tile % per_frame
    yield (tile // per_frame, (t // p.tiles_w) * p.tr,
           (t % p.tiles_w) * p.tw, co0)


def _mm_walk(p, cta):
    """The first row of each 256-row tile CTA ``cta`` of ``mm_fwd``
    computes, in order, as ``csrc/probes.cu`` walks them."""
    return [t * PR.MM_ROWS for t in range(cta, p.tiles, p.grid)]


def _tma_box(x, f, c0, nc, r0, nr, q0, nq):
    """x[f, c0:c0 + nc, r0:r0 + nr, q0:q0 + nq] with zeros wherever the box
    leaves x, as a TMA box's out-of-bounds fill reads it."""
    out = torch.zeros((nc, nr, nq), dtype=x.dtype)
    ci, h, w = x.shape[1:]
    cs, ce = max(c0, 0), min(c0 + nc, ci)
    rs, re = max(r0, 0), min(r0 + nr, h)
    qs, qe = max(q0, 0), min(q0 + nq, w)
    if cs < ce and rs < re and qs < qe:
        out[cs - c0:ce - c0, rs - r0:re - r0, qs - q0:qe - q0] = \
            x[f, cs:ce, rs:re, qs:qe]
    return out


def _replay_conv(x, w, p):
    """The kernels' schedule in plain torch: for each CTA of ``p.grid`` and
    each tile it walks, the band as the kernel addresses it (Hopper: one
    TMA box (W, tr + 2, cc) a stage at (0, row0 - 1, ch cc); general: the
    zero-haloed (tr + 2) x (tw + 2) band of all Ci), convolved by the plain
    ``conv3x3`` and written to the tile's rows, columns and Co tile.  The
    band is set into a zero frame of x's size, so that the plain conv sums
    each output in the order it does on x.  Returns y and the number of
    writes of each element."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    frames, tiles = [], []
    for cta in range(p.grid):
        for f, row0, col0, co0 in _conv_walk(p, cta):
            if p.variant == "hopper":
                q0, nq = 0, wd
                band = torch.cat([
                    _tma_box(x, f, ch * p.cc, p.cc, row0 - 1, p.tr + 2, 0,
                             wd) for ch in range(-(-ci // p.cc))])[:ci]
            else:
                q0, nq = col0 - 1, p.tw + 2
                band = _tma_box(x, f, 0, ci, row0 - 1, p.tr + 2, q0, nq)
            frame = torch.zeros((ci, h, wd), dtype=x.dtype)
            rs, re = max(row0 - 1, 0), min(row0 + p.tr + 1, h)
            qs, qe = max(q0, 0), min(q0 + nq, wd)
            frame[:, rs:re, qs:qe] = band[:, rs - row0 + 1:re - row0 + 1,
                                          qs - q0:qe - q0]
            frames.append(frame)
            tiles.append((f, row0, col0, co0))
    out = conv3x3(torch.stack(frames), w)
    y = torch.zeros((n, co, h, wd), dtype=torch.bfloat16)
    hits = torch.zeros((n, co, h, wd), dtype=torch.int32)
    for i, (f, row0, col0, co0) in enumerate(tiles):
        sel = (slice(co0, co0 + p.bn), slice(row0, row0 + p.tr),
               slice(col0, col0 + p.tw))
        y[f][sel] = out[i][sel]
        hits[f][sel] += 1
    return y, hits


@pytest.mark.parametrize("n, ci, co, h, w, sms", [
    (2, 128, 128, 16, 16, 6),      # a_conv6 at small N: 8 items, 6 CTAs
    (3, 32, 32, 64, 64, 5),        # a_conv2: 48 tiles over 5 CTAs
    (2, 64, 128, 16, 16, 4),       # TP halves
    (2, 16, 32, 64, 64, 7),
    (2, 32, 32, 13, 64, 3),        # H not a multiple of the tile's rows
    (2, 48, 40, 32, 32, 3),        # W = 32, Co < BN
    (2, 48, 40, 64, 64, 3),        # W = 64 with BN = 64: 2-row tiles
    (3, 7, 5, 5, 5, 132),          # ragged: the general variant
    (4, 12, 40, 9, 20, 132),
    (1, 33, 130, 17, 130, 132),
])
def test_conv_schedule_replay(n, ci, co, h, w, sms):
    """Every output element is written by exactly one (CTA, tile, Co tile)
    of ``plan``'s schedule, and the replay equals ``conv3x3`` bitwise: the
    boxes' coordinates, the halo rows and columns, the channel stages and
    the ragged last tiles address what the conv needs.  A small ``sms``
    makes each persistent CTA walk several tiles."""
    rng = np.random.RandomState(n * 1000 + ci + co)
    x = torch.from_numpy(rng.randn(n, ci, h, w).astype(np.float32)).to(
        torch.bfloat16)
    wt = torch.from_numpy((rng.randn(co, ci, 3, 3) * 0.2).astype(
        np.float32)).to(torch.bfloat16)
    p = CV.plan(n, ci, co, h, w, sms=sms)
    assert p.variant == ("general" if w not in (16, 32, 64) else "hopper")
    if p.variant == "hopper":
        assert p.grid == min(sms // p.n_co * p.n_co, n * p.tiles_h * p.n_co)
    y, hits = _replay_conv(x, wt, p)
    assert bool((hits == 1).all())
    assert torch.equal(y, conv3x3(x, wt))


@pytest.mark.parametrize("m, k, sms", [
    (1, 128, 132),                 # below one tile
    (255, 256, 132),
    (1000, 576, 3),                # 4 tiles over 3 CTAs, the last ragged
    (513, 1152, 2),
    (5 * 256 + 64, 256, 4),
])
def test_mm_schedule_replay(m, k, sms):
    """mm_fwd's tile walk: each persistent CTA's 256-row tiles, x's rows
    past M read as zero (the box's fill) and never stored; every row
    written once, and the replay equals ``mm_plain`` bitwise."""
    rng = np.random.RandomState(m + k)
    x = torch.from_numpy((rng.randn(m, k) * .1).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy((rng.randn(k // 128, 128, 128) * .1).astype(
        np.float32)).to(torch.bfloat16)
    p = PR.mm_plan(m, sms)
    assert p.grid == min(sms, -(-m // PR.MM_ROWS))
    y = torch.zeros((m, 128), dtype=torch.bfloat16)
    hits = torch.zeros(m, dtype=torch.int32)
    for cta in range(p.grid):
        for r0 in _mm_walk(p, cta):
            tile = torch.zeros((PR.MM_ROWS, k), dtype=torch.bfloat16)
            rows = min(PR.MM_ROWS, m - r0)
            tile[:rows] = x[r0:r0 + rows]
            y[r0:r0 + rows] = PR.mm_plain(tile, w)[:rows]
            hits[r0:r0 + rows] += 1
    assert bool((hits == 1).all())
    assert torch.equal(y, PR.mm_plain(x, w))


def _scale2_walk(p, cta):
    """The [start, stop) value ranges CTA ``cta`` of ``p`` writes, as
    ``csrc/probes.cu`` walks them.  vec: chunks [cta, cta + 1) SCALE2_SPAN
    of the body, and in CTA 0 the head and the tail values; scalar: values
    [cta, cta + 1) SCALE2_SPAN."""
    span = PR.SCALE2_SPAN
    if p.variant == "scalar":
        yield cta * span, min((cta + 1) * span, p.n)
        return
    yield (p.head + 8 * cta * span,
           p.head + 8 * min((cta + 1) * span, p.chunks))
    if cta == 0:
        t0 = p.head + 8 * p.chunks
        yield 0, p.head
        yield t0, t0 + p.tail


def _replay_scale2(x, y):
    """scale2 of x into y (both 1-D, y's values as they were where no CTA
    writes) in plain torch, each range of each CTA's walk of the plan for
    x's and y's offsets (``PR.offset16``).  Returns the plan and the
    number of writes of each value."""
    p = PR.scale2_plan(x.numel(), PR.offset16(x), PR.offset16(y))
    hits = torch.zeros(x.numel(), dtype=torch.int32)
    for cta in range(p.grid):
        for a, b in _scale2_walk(p, cta):
            y[a:b] = PR.scale2_plain(x[a:b])
            hits[a:b] += 1
    return p, hits


SCALE2_CTA_VALUES = 8 * PR.SCALE2_SPAN        # values a vec CTA


@pytest.mark.parametrize("n", [
    1, 7, 8, 4097, SCALE2_CTA_VALUES - 1, 3 * SCALE2_CTA_VALUES + 1,
    5 * SCALE2_CTA_VALUES + 13])
@pytest.mark.parametrize("x_off", range(8))
def test_scale2_plan_replay(n, x_off):
    """For x at ``x_off`` values past a 16-byte boundary and y at each
    offset 0-7: the vec variant exactly where the offsets agree and a
    whole chunk follows the boundary, its body on a 16-byte boundary in
    both, one CTA a SCALE2_SPAN of chunks; else the scalar variant.  Every
    value written once (head, body and tail), and each replay bitwise
    ``scale2_plain``."""
    rng = np.random.RandomState(n + x_off)
    src = torch.from_numpy(rng.randn(n + 8).astype(np.float32)).to(
        torch.bfloat16)
    buf = torch.empty(n + 8, dtype=torch.bfloat16)
    base = PR.offset16(src)
    x = src[(x_off - base) % 8:][:n]
    assert PR.offset16(x) == x_off
    for y_off in range(8):
        y = buf[(y_off - PR.offset16(buf)) % 8:][:n].fill_(float("nan"))
        p, hits = _replay_scale2(x, y)
        vec = x_off == y_off and n >= (8 - x_off) % 8 + 8
        assert p.variant == ("vec" if vec else "scalar")
        if vec:
            assert (x_off + p.head) % 8 == 0 and 0 <= p.tail < 8 and \
                p.head + 8 * p.chunks + p.tail == n and p.chunks >= 1
            assert p.grid == -(-p.chunks // PR.SCALE2_SPAN)
        else:
            assert p.grid == -(-n // PR.SCALE2_SPAN)
        assert bool((hits == 1).all()), (n, x_off, y_off, p.variant)
        assert torch.equal(y, PR.scale2_plain(x))


def test_scale2_planted_fault_leaves_the_last_values():
    """chip_smoke.py's planted fault: the launch over all but the last 8
    values of x into a NaN-filled y leaves those 8 unwritten, so its
    bitwise check must fail."""
    n = 3 * SCALE2_CTA_VALUES + 3
    x = torch.from_numpy(np.random.RandomState(1).randn(n).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.full_like(x, float("nan"))
    p, _ = _replay_scale2(x[:-8], y[:-8])
    assert p.n == n - 8
    assert int(torch.isnan(y.float()).sum()) == 8
    assert not torch.equal(y, PR.scale2_plain(x))


def test_scale2_plan_refusals_and_cpu_route():
    """n = 0 is refused; a CPU tensor takes the plain version (into
    ``out`` where given) with no launch; a tensor on neither the CPU nor
    a card is refused."""
    with pytest.raises(ValueError):
        PR.scale2_plan(0)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 37).astype(
        np.float32)).to(torch.bfloat16)
    PR.reset_launch_counts()
    out = torch.empty_like(x)
    assert PR.scale2(x, out) is out and torch.equal(out, x * 2)
    assert torch.equal(PR.scale2(x), x * 2)
    assert PR.scale2_launches == 0 and \
        set(PR.scale2_variant_launches.values()) == {0}
    with pytest.raises(ValueError):
        PR.scale2(x.to("meta"))


def test_op_fake_shapes_and_refusals():
    """No fallback: a tensor that is not on the CPU goes to the custom op.
    On the meta device (as under torch.export's fake tensors) the op's
    fake implementation gives the output shape and refuses what the
    kernel refuses; nothing launches."""
    CV.reset_launch_counts()
    bf = torch.bfloat16
    x = torch.empty((4, 6, 9, 11), device="meta", dtype=bf)
    y = CV.conv3x3_cuda(x, torch.empty((5, 6, 3, 3), device="meta"))
    assert tuple(y.shape) == (4, 5, 9, 11) and y.dtype == bf
    assert y.device.type == "meta"
    w = torch.empty((5, 6, 3, 3), device="meta", dtype=bf)
    with pytest.raises(ValueError, match="bfloat16"):
        CV.conv3x3_cuda(x.float(), w)
    with pytest.raises(ValueError, match="takes x"):
        CV.conv3x3_cuda(torch.empty((6, 9, 11), device="meta", dtype=bf), w)
    with pytest.raises(ValueError, match="are not"):
        CV.conv3x3_cuda(x, torch.empty((5, 6, 5, 5), device="meta",
                                       dtype=bf))
    with pytest.raises(ValueError, match="contiguous"):
        CV.conv3x3_cuda(x.transpose(2, 3), w)
    assert CV.launches == 0


def test_the_op_launches_only_on_a_card():
    x = torch.zeros((2, 3, 4, 4), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        CV.conv3x3_op(x, w)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        CV.launch(x, w)


def _branch(dtype):
    gen = torch.Generator().manual_seed(0)
    return GS.GaitSetBranch(2, channels=(4, 4, 8), part_dim=8,
                            leaky_alpha=ALPHA_BF16, dtype=dtype,
                            generator=gen)


def _volume(seed=5):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        2, 3, 12, 12, 2).astype(np.float32))


@pytest.mark.parametrize("dtype, grad, calls", [
    ("bfloat16", False, [((6, 4, 16, 16), (4, 4, 3, 3)),
                         ((6, 8, 4, 4), (8, 8, 3, 3))]),
    ("bfloat16", True, []),
    ("float32", False, []),
    ("float32", True, []),
])
def test_branch_routes_a_conv2_and_a_conv6(monkeypatch, dtype, grad,
                                           calls):
    """bf16 without autograd: a_conv2 and a_conv6 go to the dispatcher
    (bf16 operands); a grad-recording bf16 call and any fp32 call never
    reach it.  The outputs of both routes agree (on the CPU both are
    plain convs)."""
    seen = []

    def counted(x, w):
        seen.append((tuple(x.shape), tuple(w.shape)))
        assert x.dtype == w.dtype == torch.bfloat16
        return conv3x3(x, w)

    monkeypatch.setattr(GS, "conv3x3_cuda", counted)
    branch = _branch(getattr(torch, dtype))
    x = _volume()
    with torch.set_grad_enabled(grad):
        out = branch(x)
    assert seen == calls
    assert tuple(out.shape) == (2, 62, 8) and bool(torch.isfinite(out).all())
    if grad:
        out.sum().backward()
        assert branch.a_conv2.weight.grad is not None


def test_branch_without_grad_on_the_inputs_takes_the_kernel(monkeypatch):
    """Grad mode on, but neither the input nor the weights require grad
    (frozen weights): nothing to differentiate, so the kernel's route."""
    seen = []
    monkeypatch.setattr(GS, "conv3x3_cuda",
                        lambda x, w: seen.append(1) or conv3x3(x, w))
    branch = _branch(torch.bfloat16).requires_grad_(False)
    branch(_volume())
    assert len(seen) == 2


# A CPU stand-in for the op's CUDA kernel, registered in this test process
# only (the port registers none: its dispatcher sends a CPU tensor to the
# plain version and never to the op).  Every call is recorded.
_standin_calls = []


def _standin(x, w):
    _standin_calls.append(tuple(x.shape))
    return conv3x3(x, w).clone()


@pytest.fixture(scope="module")
def cpu_standin():
    CV.conv3x3_op.register_kernel("cpu")(_standin)
    yield _standin_calls


def test_export_of_a_bf16_branch_records_the_op(cpu_standin, tmp_path,
                                                monkeypatch):
    """torch.export of a bf16 GaitSet branch on non-CPU (meta) tensors
    without autograd records ``ugaitnet::conv3x3`` at a_conv2 and a_conv6
    (the stage tail, not under test here, takes its plain chain), through
    a save and a load.  The same export on the CPU, the dispatcher made to
    take the op there as it does on a card, loads and computes the
    branch's values through the op."""
    from ugaitnet_tpu_torch.eval.export import CUSTOM_OP_MODULES, _custom_ops
    monkeypatch.setattr(GS, "stage_tail_cuda", stage_tail)
    branch = _branch(torch.bfloat16).eval()

    def calls(prog):
        return [n.target.name() for n in prog.graph.nodes
                if n.op == "call_function"
                and isinstance(n.target, torch._ops.OpOverload)
                and n.target.namespace == "ugaitnet"]

    with torch.no_grad():
        prog = torch.export.export(
            copy.deepcopy(branch).to("meta"),
            (torch.empty((2, 3, 12, 12, 2), device="meta"),))
    assert _custom_ops(prog) == ["ugaitnet::conv3x3"]
    assert calls(prog) == ["ugaitnet::conv3x3"] * 2
    assert CUSTOM_OP_MODULES["ugaitnet::conv3x3"] == CV.__name__
    path = str(tmp_path / "branch_meta.pt2")
    torch.export.save(prog, path)
    assert calls(torch.export.load(path)) == ["ugaitnet::conv3x3"] * 2

    monkeypatch.setattr(GS, "conv3x3_cuda",
                        lambda x, w: CV.conv3x3_op(x, w.to(torch.bfloat16)))
    x = _volume(6)
    with torch.no_grad():
        prog = torch.export.export(branch, (x,))
    path = str(tmp_path / "branch.pt2")
    torch.export.save(prog, path)
    loaded = torch.export.load(path)
    assert calls(loaded) == ["ugaitnet::conv3x3"] * 2
    del cpu_standin[:]
    with torch.no_grad():
        got = loaded.module()(x)
    assert cpu_standin == [(6, 4, 16, 16), (6, 8, 4, 4)]
    monkeypatch.setattr(GS, "conv3x3_cuda", CV.conv3x3_cuda)
    with torch.no_grad():
        want = branch(x)
    assert torch.equal(got, want)


# ---- the slice in bf16 against the JAX package -----------------------------
class _F32Einsum:
    """``jax.numpy`` with einsum taking float32 copies of its operands."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, a, b, preferred_element_type=None):
        return jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32))


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


@pytest.fixture(scope="module")
def bf16_nets():
    """The tiny flagship in bf16 with leaky_alpha = bf16(0.3) in both
    packages, the port carrying the JAX weights; both forwards on one
    numpy-seeded batch (the JAX one with the float32 part projection).
    The sign_max merge's inputs are recorded on both sides, and the
    port's merge takes the JAX forward's picks: where two branch values
    lie within rounding of a tie, a pick may go either way and move its
    element (and, through the batch-axis L2, its column) by O(1), so the
    outputs are compared with one set of picks and the picks apart."""
    from ugaitnet_tpu.ops import fusion as JF
    from ugaitnet_tpu_torch.ops import fusion as TF
    jcfg = graft._flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(
        jcfg, compute_dtype="bfloat16", branches=tuple(
            dataclasses.replace(b, leaky_alpha=ALPHA_BF16)
            for b in jcfg.branches))
    jmodel = JNet(jcfg)
    params = jax.jit(lambda key: init_params(jmodel, key, batch=2))(
        jax.random.PRNGKey(0))
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    tmodel.eval()
    rng = np.random.RandomState(7)
    vols = [rng.randn(4, 25, 60, 60, 2).astype(np.float32),
            rng.randn(4, 25, 60, 60, 1).astype(np.float32)]
    flags = [np.array([1, 1, 0, 1], np.float32),
             np.array([1, 0, 1, 1], np.float32)]
    jin = []
    jmerge = JF.MERGES["sign_max"]

    def jtap(embs):
        jin.extend(_np(e) for e in embs)
        return jmerge(embs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "jnp", _F32Einsum())
        mp.setitem(JF.MERGES, "sign_max", jtap)
        jout = jmodel.apply(params, [jnp.asarray(v) for v in vols],
                            [jnp.asarray(f) for f in flags], train=False)
    picks = torch.from_numpy(np.abs(jin[0]) >= np.abs(jin[1]))
    tv = [torch.from_numpy(v) for v in vols]
    tf = [torch.from_numpy(f) for f in flags]

    def port(route):
        """The port's forward through ``route`` at a_conv2 / a_conv6, its
        merge taking the JAX picks: (outputs, merge inputs, conv calls)."""
        tin, calls = [], []

        def conv(x, w):
            calls.append(tuple(x.shape))
            return route(x, w)

        def forced(embs):
            tin.extend(_np(e) for e in embs)
            return torch.where(picks, embs[0], embs[1])

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(GS, "conv3x3_cuda", conv)
            mp.setitem(TF.MERGES, "sign_max", forced)
            with torch.no_grad():
                out = tmodel(tv, tf)
        return out, tin, calls

    tout, tin, calls = port(conv3x3)
    cout, cin, _ = port(lambda x, w: F.conv2d(x, w, padding=1))
    return dict(jout=jout, jin=jin, tout=tout, tin=tin, cout=cout, cin=cin,
                calls=calls)


KEYS = ("signature", "classprob_logits", "flatten")


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_bf16_forward_takes_the_conv_route(bf16_nets):
    """4 dispatcher calls per two-branch forward: a_conv2, a_conv6."""
    assert bf16_nets["calls"] == [(100, 8, 64, 64), (100, 16, 16, 16)] * 2


@pytest.mark.parametrize("i", [0, 1], ids=["branch_of", "branch_gray"])
def test_bf16_branch_matches_jax(bf16_nets, i):
    """The merge's inputs (the gated branch values), and the port's own
    sign_max picks: any that differs from JAX's lies within twice the
    inputs' difference of a tie."""
    got, want = bf16_nets["tin"][i], bf16_nets["jin"][i]
    assert got.shape == want.shape == (4, 62, 16)
    # measured: 1.9e-4 (of) and 1.2e-3 (gray); no pick switched
    assert _rel(got, want) <= BF16_FWD_REL
    (ta, tb), (ja, jb) = bf16_nets["tin"], bf16_nets["jin"]
    err = max(_rel(ta, ja), _rel(tb, jb))
    gap = np.abs(np.abs(ja) - np.abs(jb)) / max(np.abs(ja).max(),
                                                 np.abs(jb).max())
    switched = (np.abs(ta) >= np.abs(tb)) != (np.abs(ja) >= np.abs(jb))
    assert (gap[switched] <= 2 * err).all()


@pytest.mark.parametrize("key", KEYS)
def test_bf16_forward_matches_jax(bf16_nets, key):
    got, want = bf16_nets["tout"][key], bf16_nets["jout"][key]
    assert tuple(got.shape) == tuple(want.shape)
    assert bool(torch.isfinite(got).all())
    # measured: signature 2.9e-3, classprob_logits 4.1e-3, flatten 2.9e-3
    assert _rel(got, want) <= BF16_FWD_REL


@pytest.mark.parametrize("key", KEYS)
def test_bf16_forward_matches_the_conv2d_route(bf16_nets, key):
    got, want = bf16_nets["tout"][key], bf16_nets["cout"][key]
    # measured: 2.1e-3, 2.0e-3, 2.1e-3; the merge inputs 0 (of) and
    # 3.6e-4 (gray)
    assert _rel(got, want) <= BF16_FWD_REL
    for a, b in zip(bf16_nets["tin"], bf16_nets["cin"]):
        assert _rel(a, b) <= BF16_FWD_REL
