"""The GaitSet stage tail (2x2 max pool + leaky ReLU + set max over T) of
the port against the TPU kernel it replaces and the JAX package's chain, on
the CPU.

- ``benchmarks/proto_tail.py:_tail_kernel`` runs in a test-local
  ``pl.pallas_call`` with the index maps of its launcher ``tail()``, in
  interpret mode; it equals ``xla_chain`` bitwise, and so does the port's
  plain ``ops/pooling.py:stage_tail`` after (B, T, H, W, C) -> (B*T, C, H, W).
- The port's gradient equals ``jax.vjp`` of the JAX package's own chain
  (``ops/pooling.py:max_pool_2x2``, ``jnp.maximum(p, 0.3 p)``,
  ``models/gaitset.py:_set_max``) bitwise, on random inputs and on tied ones
  (constant clips, repeated frames, zero windows).
- The dispatcher ``ops/cuda/stage_tail.py:stage_tail_cuda`` takes the plain
  version for a CPU tensor and launches nothing; any other tensor goes to
  the custom op ``ugaitnet::stage_tail``, whose fake implementation gives
  the shapes (and refuses what the kernels refuse) and whose one real
  implementation is the card's.  With a CPU stand-in for the kernels,
  registered by this file only, the op's autograd gives the plain
  gradient and ``torch.export`` records the op, through a save and a load.
  The GaitSet branch calls the dispatcher twice.

Tolerance: none; every comparison is bitwise.  In bfloat16 the port is
given alpha = 0.30078125, bfloat16's 0.3: JAX rounds the weak-typed 0.3 to
bfloat16 before it multiplies, torch multiplies by float32 0.3 and rounds
the product (the port's rule, which its kernel keeps), so at alpha = 0.3
the two differ only where the leaky ReLU's negative side wins.
"""

import concurrent.futures
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks.proto_tail import _tail_kernel, xla_chain
from ugaitnet_tpu.models.gaitset import _set_max as j_set_max
from ugaitnet_tpu.ops.pooling import max_pool_2x2 as j_max_pool_2x2

from ugaitnet_tpu_torch.models import gaitset as GS
from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
from ugaitnet_tpu_torch.ops.pooling import stage_tail

torch.set_num_threads(1)

ALPHA = 0.3
# bfloat16's nearest value to 0.3: what the JAX chain multiplies by in bf16
ALPHA_BF16 = float(jnp.asarray(ALPHA, jnp.bfloat16).astype(jnp.float32))
DTYPES = {"float32": (jnp.float32, torch.float32, ALPHA),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ALPHA_BF16)}


def pallas_tail(y, ih=4, alpha=ALPHA):
    """``proto_tail.tail`` with interpret=True, no VMEM memory space and the
    input's dtype for the outputs: y (B, T, H, W, C) -> (pooled, set max)."""
    b, t, h, w, c = y.shape
    yt = jnp.transpose(y, (1, 2, 3, 4, 0)).reshape(t * h * w * c, b)
    nchunk = h // ih
    blk = ih * w * c
    oblk = blk // 4
    o1, o2 = pl.pallas_call(
        functools.partial(_tail_kernel, ih=ih, w=w, c=c, alpha=alpha),
        grid=(nchunk, t),
        in_specs=[pl.BlockSpec((blk, b), lambda ic, tt: (tt * nchunk + ic, 0))],
        out_specs=(
            pl.BlockSpec((oblk, b), lambda ic, tt: (tt * nchunk + ic, 0)),
            pl.BlockSpec((oblk, b), lambda ic, tt: (ic, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((t * h * w * c // 4, b), y.dtype),
            jax.ShapeDtypeStruct((h * w * c // 4, b), y.dtype),
        ),
        interpret=True,
    )(yt)
    pooled = jnp.transpose(o1.reshape(t, h // 2, w // 2, c, b),
                           (4, 0, 1, 2, 3))
    setm = jnp.transpose(o2.reshape(h // 2, w // 2, c, b), (3, 0, 1, 2))
    return pooled, setm


def _np(v):
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _to_port(y, tdt):
    """(B, T, H, W, C) numpy float32 -> (B*T, C, H, W) torch."""
    b, t, h, w, c = y.shape
    return torch.from_numpy(np.array(
        y.transpose(0, 1, 4, 2, 3).reshape(b * t, c, h, w))).to(tdt)


def _from_port(a, b=None):
    """(B*T, C, h, w) torch, given b, or (B, C, h, w) -> channels-last
    numpy."""
    a = a.detach().float()
    if b is None:
        return a.permute(0, 2, 3, 1).numpy()
    return a.reshape(b, -1, *a.shape[1:]).permute(0, 1, 3, 4, 2).numpy()


def _inputs(shape, seed, tied=False):
    """Random volumes; tied: a constant clip, a zero clip, repeated frames,
    zero windows and a constant negative band, so that every tie rule of the
    backward (window, T, p == 0) is reached."""
    rng = np.random.RandomState(seed)
    y = rng.randn(*shape).astype(np.float32)
    if tied:
        y[0] = 0.37
        y[1] = 0.0
        y[2, 1:] = y[2, :1]
        y[3, :, :4, :4] = 0.0
        y[3, :, 4:6] = -0.25
    return y


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pallas_tail_kernel_equals_xla_chain(dtype):
    jdt, _, _ = DTYPES[dtype]
    y = jnp.asarray(_inputs((8, 3, 8, 8, 4), 0)).astype(jdt)
    got, want = pallas_tail(y, ih=4), xla_chain(y)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == jdt
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_equals_pallas_tail_kernel(dtype):
    jdt, tdt, alpha = DTYPES[dtype]
    y = jnp.asarray(_inputs((8, 3, 8, 8, 4), 1)).astype(jdt)
    pooled, setm = pallas_tail(y, ih=4)
    a, s = stage_tail(_to_port(_np(y), tdt), 8, alpha)
    assert a.dtype == s.dtype == tdt
    assert tuple(a.shape) == (24, 4, 4, 4) and tuple(s.shape) == (8, 4, 4, 4)
    np.testing.assert_array_equal(_from_port(a, 8), _np(pooled))
    np.testing.assert_array_equal(_from_port(s), _np(setm))


def test_bf16_alpha_rounding_differs_only_on_the_negative_side():
    """At alpha = 0.3 torch's bf16 product (0.3 in float32, then rounded)
    and JAX's (bf16(0.3) = 0.30078125) differ; only negative outputs move,
    and the set max, whose maxima are positive here, not at all."""
    y = jnp.asarray(_inputs((8, 3, 8, 8, 4), 1)).astype(jnp.bfloat16)
    pooled, setm = (_np(v) for v in xla_chain(y))
    a, s = stage_tail(_to_port(_np(y), torch.bfloat16), 8, ALPHA)
    a = _from_port(a, 8)
    diff = a != pooled
    assert diff.any()
    assert (pooled[diff] < 0).all() and (a[diff] < 0).all()
    np.testing.assert_array_equal(_from_port(s), setm)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(3, 2, 7, 9, 5), (2, 1, 6, 5, 3),
                                   (4, 5, 11, 11, 1)])
def test_port_equals_xla_chain_ragged(dtype, shape):
    """Odd H or W (the last row / column dropped), T = 1, C not a multiple
    of anything."""
    jdt, tdt, alpha = DTYPES[dtype]
    y = jnp.asarray(_inputs(shape, 2)).astype(jdt)
    pooled, setm = xla_chain(y)
    a, s = stage_tail(_to_port(_np(y), tdt), shape[0], alpha)
    np.testing.assert_array_equal(_from_port(a, shape[0]), _np(pooled))
    np.testing.assert_array_equal(_from_port(s), _np(setm))


def _j_chain(v):
    p = j_max_pool_2x2(v)
    a = jnp.maximum(p, ALPHA * p)
    return a, j_set_max(a)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("shape", [(4, 3, 8, 8, 5), (4, 2, 9, 7, 3)])
def test_gradient_equals_jax_vjp(dtype, tied, shape):
    jdt, tdt, alpha = DTYPES[dtype]
    b, t, h, w, c = shape
    rng = np.random.RandomState(3)
    y = jnp.asarray(_inputs(shape, 4, tied)).astype(jdt)
    ga = jnp.asarray(rng.randn(b, t, h // 2, w // 2, c)).astype(jdt)
    gs = jnp.asarray(rng.randn(b, h // 2, w // 2, c)).astype(jdt)
    (a_j, s_j), vjp = jax.vjp(_j_chain, y)
    (dx_j,) = vjp((ga, gs))

    x = _to_port(_np(y), tdt).requires_grad_(True)
    a, s = ST.stage_tail_cuda(x, b, alpha)
    g_a = _to_port(_np(ga), tdt).reshape(a.shape)
    g_s = torch.from_numpy(np.array(_np(gs).transpose(0, 3, 1, 2))).to(tdt)
    (dx,) = torch.autograd.grad((a, s), x, (g_a, g_s))
    assert dx.dtype == tdt
    np.testing.assert_array_equal(_from_port(a, b), _np(a_j))
    np.testing.assert_array_equal(_from_port(s), _np(s_j))
    np.testing.assert_array_equal(_from_port(dx, b), _np(dx_j))


def test_gradient_splits_ties_evenly():
    """A constant clip: every window and every frame ties, so each element
    of a window gets 1/4 of its share, each of the T frames 1/T of g_s; at
    p == 0 the leaky ReLU passes g/2 + 0.3 g/2."""
    t = 5
    for val, slope in ((0.5, 1.0), (-0.5, ALPHA), (0.0, 0.5 + 0.5 * ALPHA)):
        x = torch.full((t, 1, 2, 2), val, requires_grad=True)
        a, s = ST.stage_tail_cuda(x, 1, ALPHA)
        (dx,) = torch.autograd.grad((a, s), x, (torch.zeros_like(a),
                                                torch.ones_like(s)))
        want = torch.full_like(x, np.float32(np.float32(slope) / t) / 4)
        torch.testing.assert_close(dx, want, rtol=1e-6, atol=0)


def test_dispatcher_cpu_route_counts_no_launch():
    ST.reset_launch_counts()
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(6, 3, 8, 6).astype(np.float32))
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ak, sk = ST.stage_tail_cuda(xk, 2)
    ap, sp = stage_tail(xp, 2, ALPHA)
    assert torch.equal(ak, ap) and torch.equal(sk, sp)
    (ak.sum() + 2 * sk.sum()).backward()
    (ap.sum() + 2 * sp.sum()).backward()
    assert torch.equal(xk.grad, xp.grad)
    with torch.no_grad():
        assert all(torch.equal(u, v) for u, v in
                   zip(ST.stage_tail_cuda(x, 2), stage_tail(x, 2, ALPHA)))
    assert (ST.fwd_launches, ST.bwd_launches) == (0, 0)


def test_dispatcher_checks_and_the_ops_fake_shapes():
    """No fallback: a tensor that is not on the CPU goes to the custom op.
    On the meta device (as under torch.export's fake tensors) the op's
    fake implementation gives the output shapes, forward and backward, and
    refuses what the kernels refuse; nothing launches."""
    ST.reset_launch_counts()
    x = torch.empty((6, 3, 8, 6), device="meta", requires_grad=True)
    a, s = ST.stage_tail_cuda(x, 2)
    assert tuple(a.shape) == (6, 3, 4, 3) and tuple(s.shape) == (2, 3, 4, 3)
    assert a.device.type == s.device.type == "meta"
    (dx,) = torch.autograd.grad((a, s), x, (torch.ones_like(a),
                                            torch.ones_like(s)))
    assert tuple(dx.shape) == (6, 3, 8, 6) and dx.device.type == "meta"
    with pytest.raises(ValueError, match="do not split"):
        ST.stage_tail_cuda(x, 4)
    with pytest.raises(ValueError, match="empty pooled output"):
        ST.stage_tail_cuda(torch.empty((2, 3, 1, 6), device="meta"), 1)
    with pytest.raises(ValueError, match="takes"):
        ST.stage_tail_cuda(torch.empty((2, 3, 6), device="meta"), 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ST.stage_tail_cuda(x.detach().half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ST.stage_tail_cuda(x.detach().transpose(2, 3), 2)
    assert (ST.fwd_launches, ST.bwd_launches) == (0, 0)


def test_the_op_launches_only_on_a_card():
    """The op's one real implementation is the CUDA one; the launch
    wrappers refuse a tensor that is not on a card."""
    x = torch.zeros((4, 2, 4, 4))
    with pytest.raises(NotImplementedError):
        ST.stage_tail_op(x, 2, ALPHA)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ST.launch_fwd(x, 2, ALPHA)
    a, s = stage_tail(x, 2, ALPHA)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ST.launch_bwd(x, a, s, a, s, 2, ALPHA)


# A CPU stand-in for the op's CUDA kernels, registered in this test process
# only (the port registers none: its dispatcher sends a CPU tensor to the
# plain chain and never to the op).  It lets the op's autograd wiring and
# its torch.export round trip run here.  Every call is recorded.
_standin_calls = []


def _standin_fwd(x, batch, alpha):
    _standin_calls.append("fwd")
    return tuple(v.clone() for v in stage_tail(x, batch, alpha))


def _standin_bwd(x, a, s, g_a, g_s, batch, alpha):
    """The plain chain's gradient.  An op's kernel runs below autograd in
    its thread, so the gradient is taken in a fresh one."""
    _standin_calls.append("bwd")

    def grad():
        xx = x.detach().requires_grad_(True)
        return torch.autograd.grad(stage_tail(xx, batch, alpha), xx,
                                   (g_a, g_s))[0]

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(grad).result()


@pytest.fixture(scope="module")
def cpu_standin():
    ST.stage_tail_op.register_kernel("cpu")(_standin_fwd)
    ST.stage_tail_backward_op.register_kernel("cpu")(_standin_bwd)
    yield _standin_calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("outputs", ["both", "a", "s"])
def test_op_autograd_equals_plain_gradient(cpu_standin, dtype, tied,
                                           outputs):
    """The op's autograd (what it saves, the order of g_a and g_s, an
    unused output's zero gradient) through the stand-in kernels gives the
    plain chain's gradient, bitwise."""
    b, t, c, h, w = 4, 3, 5, 8, 6
    y = _inputs((b, t, h, w, c), 6, tied)
    x = _to_port(y, torch.float32).to(dtype)
    rng = np.random.RandomState(7)
    g_a = torch.from_numpy(rng.randn(b * t, c, h // 2, w // 2)).to(dtype)
    g_s = torch.from_numpy(rng.randn(b, c, h // 2, w // 2)).to(dtype)
    pick = {"both": lambda a, s: (a, s), "a": lambda a, s: (a,),
            "s": lambda a, s: (s,)}[outputs]
    grads = {"both": (g_a, g_s), "a": (g_a,), "s": (g_s,)}[outputs]
    del cpu_standin[:]
    xo = x.clone().requires_grad_(True)
    ao, so = ST.stage_tail_op(xo, b, ALPHA)
    (do,) = torch.autograd.grad(pick(ao, so), xo, grads)
    xp = x.clone().requires_grad_(True)
    ap, sp = stage_tail(xp, b, ALPHA)
    (dp,) = torch.autograd.grad(pick(ap, sp), xp, grads)
    assert cpu_standin == ["fwd", "bwd"]
    assert torch.equal(ao, ap) and torch.equal(so, sp)
    assert do.dtype == dtype and torch.equal(do, dp)


def test_export_records_the_op(cpu_standin, tmp_path):
    """torch.export of a module that calls the dispatcher on a non-CPU
    tensor records ``ugaitnet::stage_tail`` (not the plain chain); the
    saved program loads, still calls the op, and computes the plain
    chain's values through it."""
    from ugaitnet_tpu_torch.eval.export import _custom_ops

    class Tail(torch.nn.Module):
        def forward(self, x):
            a, s = ST.stage_tail_cuda(x, 2, ALPHA)
            return a.sum(1), s

    prog = torch.export.export(Tail(),
                               (torch.empty((6, 3, 8, 6), device="meta"),))
    assert _custom_ops(prog) == ["ugaitnet::stage_tail"]
    path = str(tmp_path / "tail.pt2")
    torch.export.save(prog, path)
    loaded = torch.export.load(path)
    assert _custom_ops(loaded) == ["ugaitnet::stage_tail"]
    x = torch.from_numpy(np.random.RandomState(8).randn(6, 3, 8, 6)
                         .astype(np.float32))
    del cpu_standin[:]
    got = loaded.module()(x)
    a, s = stage_tail(x, 2, ALPHA)
    assert cpu_standin == ["fwd"]
    assert torch.equal(got[0], a.sum(1)) and torch.equal(got[1], s)


def test_export_names_the_module_of_each_op():
    """The loader imports the module of each op in ``meta["custom_ops"]``
    before it loads a program: for the stage tail and the bf16 3x3 conv,
    the module that registers each."""
    from ugaitnet_tpu_torch.eval import export as E
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    assert set(E.CUSTOM_OP_MODULES) == {"ugaitnet::stage_tail",
                                        "ugaitnet::conv3x3"}
    for op, module in (("stage_tail", ST), ("conv3x3", CV)):
        mod = E.CUSTOM_OP_MODULES[f"ugaitnet::{op}"]
        assert importlib.import_module(mod) is module
        assert hasattr(torch.ops.ugaitnet, op)


def test_gaitset_branch_calls_the_dispatcher_twice(monkeypatch):
    """Stages 1 and 2 of the frame stream go through the stage tail (2 per
    branch forward); stage 3's set max and the set stream's pool do not."""
    from ugaitnet_tpu_torch.core.config import BranchConfig
    calls = []

    def counted(x, batch, alpha):
        calls.append((tuple(x.shape), batch, alpha))
        return stage_tail(x, batch, alpha)

    monkeypatch.setattr(GS, "stage_tail_cuda", counted)
    gen = torch.Generator().manual_seed(0)
    bcfg = BranchConfig()
    branch = GS.GaitSetBranch(2, channels=(4, 4, 8), part_dim=8,
                              leaky_alpha=bcfg.leaky_alpha, generator=gen)
    x = torch.randn(2, 3, 12, 12, 2, generator=gen)
    out = branch(x)
    assert tuple(out.shape) == (2, 62, 8)
    assert calls == [((6, 4, 16, 16), 2, ALPHA), ((6, 4, 8, 8), 2, ALPHA)]
