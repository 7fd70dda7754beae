"""The hand input gradient of the 3D CNN's strided convs
(``ops/cuda/conv3d_dgrad.py``, ``csrc/conv3d_dgrad.cu``) and the autograd
Function that routes each gradient of a conv (``ops/cuda/conv3d_route.py:
conv3d``).  Imports no JAX, so the card tests run where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3d_dgrad.py

On the CPU: the plain version against float64 autograd of ``F.conv3d`` at
strides (1, 2, 2), (2, 2, 2), (1, 1, 1) and others, on ragged shapes with
input rows and columns no output reads; the rule's refusals; the routed
backward's dx, dW and db, with the rule forced (``conv3d_route.engages``
replaced by ``conv3d_route.fits``, the shared rule without the device
test), against ``F.conv3d``'s autograd, alone and through a whole
``Conv3DBranch``.

On the card (``-m cuda``): dx against float64 at the cell's conv1 and
conv2 and on ragged shapes, read as max |kernel - float64| / max |float64|
against LIMIT = 1e-5 (float32 sums of at most Co x 27 products); dx
written whole into memory left dirty; two launches bitwise; planted faults
(a tap shifted, a phase skipped, unread rows left unzeroed) that must read
above the limit; one ``Conv3DBranch`` train step through the hand paths
against cuDNN; the counter recorded from the autograd thread; refusals.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from ugaitnet_tpu_torch.models.branches import (CONV3D_SPEC, Conv,
                                                Conv2DBranch, Conv3DBranch)
from ugaitnet_tpu_torch.obsv import spans
from ugaitnet_tpu_torch.ops.cuda import conv3d_dgrad as CD
from ugaitnet_tpu_torch.ops.cuda import conv3d_route as R
from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW

LIMIT = 1e-5
CELL = {"of": 2, "gray": 1}
ENGAGES = R.engages           # the shared rule with its device test

# (N, Ci, T, H, W, Co, kernel, stride): conv1 / conv2 cut down (a last row
# and column no output reads at (1, 2, 2)), stride 1, stride 3, a 1 x 1 x 1
# kernel at stride 2 (phases no tap reaches), Ci past one block of 64 and
# Co off a multiple of 16, a mixed kernel
RAGGED = [(3, 5, 7, 12, 14, 6, (3, 3, 3), (1, 2, 2)),
          (2, 7, 9, 11, 13, 9, (3, 3, 3), (2, 2, 2)),
          (2, 3, 6, 7, 8, 5, (3, 3, 3), (1, 1, 1)),
          (1, 2, 8, 10, 11, 3, (2, 3, 2), (3, 3, 2)),
          (2, 4, 5, 7, 9, 6, (1, 1, 1), (1, 2, 2)),
          (2, 70, 5, 9, 9, 20, (3, 3, 3), (2, 2, 1)),
          (1, 3, 4, 9, 6, 17, (2, 4, 1), (1, 2, 3))]
STRIDES = {"1x2x2": RAGGED[0], "2x2x2": RAGGED[1], "1x1x1": RAGGED[2]}


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def make(n, ci, t, h, w, co, kernel, stride, dtype, device="cpu", seed=0):
    """gy of the VALID conv's output shape and a weight."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = tuple((a - k) // s + 1 for a, k, s in zip((t, h, w), kernel,
                                                     stride))
    gy = torch.randn((n, co, *out), generator=g, dtype=dtype, device=device)
    wt = torch.randn((co, ci, *kernel), generator=g, dtype=dtype,
                     device=device)
    return gy, wt


def reference(gy, wt, size, stride):
    """dx by float64 autograd of F.conv3d."""
    x = torch.zeros((gy.shape[0], wt.shape[1], *size), dtype=torch.float64,
                    device=gy.device, requires_grad=True)
    y = F.conv3d(x, wt.double(), stride=stride)
    return torch.autograd.grad(y, x, gy.double())[0]


def unread(size, kernel, stride, out):
    """Whether some input row no output reads exists."""
    return any(s * (o - 1) + k < a for a, k, s, o in zip(size, kernel,
                                                         stride, out))


@pytest.mark.parametrize("case", RAGGED)
def test_plain_matches_autograd(case):
    gy, wt = make(*case, torch.float64)
    size, stride = case[2:5], case[7]
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    ref = reference(gy, wt, size, stride)
    assert dx.shape == ref.shape
    assert rel_err(dx, ref) < 1e-12


@pytest.mark.parametrize("name", sorted(STRIDES))
def test_plain_zeroes_what_no_output_reads(name):
    """At (1, 2, 2) the last row and column of the cut-down conv1 are read
    by no output; elsewhere every position is."""
    case = STRIDES[name]
    gy, wt = make(*case, torch.float64)
    size, kernel, stride = case[2:5], case[6], case[7]
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    assert unread(size, kernel, stride, gy.shape[2:]) is (name == "1x2x2")
    edges = (dx[:, :, :, -1].abs().max(), dx[..., -1].abs().max())
    if name == "1x2x2":
        assert edges == (0, 0)
    else:
        assert min(edges) > 0


def test_wrapper_refuses_what_is_no_valid_conv():
    gy, wt = make(*RAGGED[0], torch.float32)
    size, stride = RAGGED[0][2:5], RAGGED[0][7]
    with pytest.raises(ValueError):
        CD.conv3d_dgrad(gy[:, :, :-1], wt, size, stride)
    with pytest.raises(ValueError):
        CD.conv3d_dgrad(gy[0], wt, size, stride)
    with pytest.raises(ValueError):
        CD.conv3d_dgrad(gy, wt[:-1], size, stride)
    with pytest.raises(ValueError):
        CD.conv3d_dgrad(gy.to("meta"), wt.to("meta"), size, stride)


def dgrad_rule(x, w):
    """The input gradient's rule but the device: the shared one and the
    kernel's own."""
    return R.fits(x, w) and CD.fits(x, w)


def x_w(dtype=torch.float32, ndim=5, x_grad=True, channels_last=False,
        size=16):
    """x (2, 64, 16, 16, size) on the meta device, 2^19 elements at size
    16: just the rule's MIN_TILES tiles."""
    w = torch.zeros((8, 64) + (3,) * (ndim - 2), dtype=dtype,
                    device="meta", requires_grad=True)
    x = torch.zeros((2, 64) + (16,) * (ndim - 3) + (size,), dtype=dtype,
                    device="meta")
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    return x.requires_grad_(x_grad), w


@pytest.mark.parametrize("what", ["takes", "2d", "bf16", "no input grad",
                                  "no grad mode", "too small",
                                  "channels last", "no card"])
def test_rule(what):
    x, w = x_w()
    if what == "2d":
        x, w = x_w(ndim=4, size=16 * 16)
    elif what == "bf16":
        x, w = x_w(torch.bfloat16)
    elif what == "no input grad":
        x, w = x_w(x_grad=False)
    elif what == "too small":
        x, w = x_w(size=15)
    elif what == "channels last":
        x, w = x_w(channels_last=True)
    if what == "no grad mode":
        with torch.no_grad():
            assert not dgrad_rule(x, w)
    else:
        assert dgrad_rule(x, w) is (what in ("takes", "no card"))
    b = torch.zeros(w.shape[0], device="meta")
    assert not R.hand_grads(x, w, b, 0)[0]        # no card here


def test_chip_smoke_counts_the_convs_the_rule_takes():
    """chip_smoke.py phase 9 expects 2 launches a step for each of them."""
    import chip_smoke
    assert chip_smoke.dgrad_convs(CONV3D_SPEC, CD.shape_rule) == 4
    assert chip_smoke.dgrad_convs(CONV3D_SPEC, CD.shape_rule, n=2) == 2


def cell_inputs(n=120, clip=(25, 60, 60)):
    """The input shape of each conv of a 3D CNN branch at batch n."""
    shapes, ci, size = [], 2, clip
    for co, kern, stride in CONV3D_SPEC:
        shapes.append((n, ci, *size))
        size = tuple((a - k) // s + 1 for a, k, s in zip(size, kern,
                                                         stride))
        ci = co
    return shapes


def test_rule_at_the_cell_takes_conv1_to_conv4():
    """At the cell's 120 rows the rule takes conv1-conv4, where the kernel
    beat cuDNN on an H100, and leaves conv5 (dx of 15 tiles); conv0's input
    is data and needs no gradient."""
    taken = [CD.shape_rule(s) for s in cell_inputs()]
    assert taken[1:] == [True, True, True, True, False]
    assert [math.prod(s) // CD.TILE for s in cell_inputs()[1:]] == [
        16905, 6654, 1350, 120, 15]


@pytest.fixture
def recorder(monkeypatch):
    """The weight shapes of the convs whose input gradient the hand
    kernel (its plain version, on the CPU) computes."""
    seen = []
    dgrad = CD.conv3d_dgrad

    def record(gy, w, size, stride):
        seen.append(tuple(w.shape))
        return dgrad(gy, w, size, stride)
    monkeypatch.setattr(CD, "conv3d_dgrad", record)
    return seen


@pytest.fixture
def cpu_rule(monkeypatch):
    """The shared rule without its device test, so CPU tensors engage:
    the Function then runs the plain version in its backward.  The weight
    gradient's rule stays off, as it is on the CPU."""
    monkeypatch.setattr(R, "engages", R.fits)
    monkeypatch.setattr(CW, "fits", lambda x, w: False)


def branch3d(ci, dtype=torch.float32, seed=0):
    return Conv3DBranch(ci, ndense_units=16, activation="leaky",
                        dtype=dtype,
                        generator=torch.Generator().manual_seed(seed))


def clip(ci, n=2, seed=1):
    """(n, 25, 60, 60, ci) in the layout the input pipeline hands the
    branch: a view of (n, T, C, H, W) frames, so that past the branch's
    permute every map is NCDHW (a channels-last clip makes cuDNN's, and
    the CPU's, maps channels-last, which the rule leaves to cuDNN)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 25, ci, 60, 60), generator=g).permute(
        0, 1, 3, 4, 2)


def taken(n):
    """The weight shapes of the convs past conv0 whose input gradient the
    rule takes at batch n, in the backward's order."""
    return [(co, s[1], *k) for (co, k, _), s in zip(CONV3D_SPEC[1:],
                                                    cell_inputs(n)[1:])
            if CD.shape_rule(s)][::-1]


@pytest.mark.parametrize("mod", sorted(CELL))
def test_rule_takes_the_large_convs_past_conv0(cpu_rule, recorder, mod):
    """At 2 rows: conv1 and conv2; not conv0 (its input is data), the
    smaller conv3-conv5 or the code layer."""
    ci = CELL[mod]
    branch3d(ci)(clip(ci)).sum().backward()
    assert recorder == taken(2) == [(256, 128, 3, 3, 3), (128, 64, 3, 3, 3)]


@pytest.mark.parametrize("what", ["conv2d", "bf16", "padding", "frozen input",
                                  "eval", "no card"])
def test_rule_leaves_other_paths(cpu_rule, recorder, monkeypatch, what):
    """Each path is refused for its own reason, not its size (the size rule
    at 0)."""
    monkeypatch.setattr(CD, "MIN_TILES", 0)
    if what == "conv2d":
        b = Conv2DBranch(50, ndense_units=16,
                         generator=torch.Generator().manual_seed(0))
        b(torch.randn(2, 50, 60, 60)).sum().backward()
    elif what == "bf16":
        branch3d(2, torch.bfloat16)(clip(2)).sum().backward()
    elif what == "padding":
        c = Conv(4, 8, (3, 3, 3), (2, 2, 2), torch.float32,
                 torch.Generator().manual_seed(0), padding=1)
        c(torch.randn(2, 4, 7, 7, 7, requires_grad=True)).sum().backward()
    elif what == "frozen input":
        c = Conv(4, 8, (3, 3, 3), (2, 2, 2), torch.float32,
                 torch.Generator().manual_seed(0))
        c(torch.randn(2, 4, 7, 7, 7)).sum().backward()
    elif what == "eval":
        with torch.no_grad():
            branch3d(2).eval()(clip(2))
    else:
        monkeypatch.setattr(R, "engages", ENGAGES)
        branch3d(2)(clip(2).requires_grad_()).sum().backward()
    assert recorder == []


@pytest.mark.parametrize("route", ["dx", "dw", "both", "neither"])
@pytest.mark.parametrize("bias", [True, False])
def test_function_routes_each_gradient(route, bias):
    """The Function's dx, dW and db, each from the hand kernel (its plain
    version) where the route given at the forward says so and from
    convolution_backward otherwise, against F.conv3d's autograd."""
    hand = (route in ("dx", "both"), route in ("dw", "both"))
    gy, w = make(*RAGGED[1], torch.float64)
    size, stride = RAGGED[1][2:5], RAGGED[1][7]
    x = torch.randn((gy.shape[0], w.shape[1], *size), dtype=torch.float64,
                    requires_grad=True)
    w.requires_grad_()
    b = torch.randn(w.shape[0], dtype=torch.float64,
                    requires_grad=True) if bias else None
    leaves = [t for t in (x, w, b) if t is not None]
    got = torch.autograd.grad(R.conv3d(x, w, b, stride, hand), leaves,
                              gy)
    ref = torch.autograd.grad(F.conv3d(x, w, b, stride=stride), leaves, gy)
    for g, r in zip(got, ref):
        assert rel_err(g, r) < 1e-12


@pytest.mark.parametrize("mod", sorted(CELL))
@pytest.mark.parametrize("rules", ["dgrad", "both"])
def test_routed_branch_gradients_on_the_cpu(monkeypatch, mod, rules):
    """Conv3DBranch's parameter and input gradients through the routed
    Function (plain versions in its backward) against F.conv3d's
    autograd, same weights and batch; with the size rule at 0 and a clip
    that needs a gradient, every conv takes the hand input gradient."""
    ci = CELL[mod]
    x = clip(ci)
    monkeypatch.setattr(CD, "MIN_TILES", 0)
    monkeypatch.setattr(R, "engages", R.fits)

    def grads(dgrad, wgrad):
        b = branch3d(ci)
        monkeypatch.setattr(CD, "fits", dgrad)
        monkeypatch.setattr(CW, "fits", wgrad)
        xg = x.clone().requires_grad_()
        b(xg).square().sum().backward()
        return {"input": xg.grad, **{k: p.grad
                                     for k, p in b.named_parameters()}}
    off = lambda *a: False
    hand = grads(CD.fits, CW.fits if rules == "both" else off)
    ref = grads(off, off)
    for k in ref:
        assert rel_err(hand[k], ref[k].double()) < 1e-5, k


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the cell's conv1 and conv2 (N = 120, past conv0: both branches alike)
CELL_CONVS = {"conv1": (120, 64, 23, 28, 28, 128, (3, 3, 3), (1, 2, 2)),
              "conv2": (120, 128, 21, 13, 13, 256, (3, 3, 3), (2, 2, 2))}


def on_card(case, cuda, seed=0):
    gy, wt = make(*case, torch.float32, cuda, seed)
    return gy, wt, case[2:5], case[7]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELL_CONVS))
def test_cuda_cell_shapes_against_float64(cuda, name):
    gy, wt, size, stride = on_card(CELL_CONVS[name], cuda)
    n0 = CD.launches
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    assert CD.launches == n0 + 1
    ref = CD.dgrad_plain(gy.double(), wt.double(), size, stride)
    assert rel_err(dx, ref) < LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
def test_cuda_ragged_shapes_against_float64(cuda, case):
    gy, wt, size, stride = on_card(case, cuda)
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    assert rel_err(dx, reference(gy, wt, size, stride)) < LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "sliced", "offset"])
def test_cuda_gy_layouts_against_float64(cuda, layout):
    """gy as autograd may hand it in other layouts: channels-last, a slice
    of a wider tensor, one float past a 16-byte boundary."""
    case = RAGGED[0]
    gy, wt, size, stride = on_card(case, cuda)
    if layout == "channels_last":
        gy = gy.contiguous(memory_format=torch.channels_last_3d)
    elif layout == "sliced":
        gy = torch.cat([gy, gy], 1)[:, ::2]
    else:
        gy = torch.cat([gy.new_zeros(1), gy.reshape(-1)])[1:].view(gy.shape)
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    assert rel_err(dx, reference(gy, wt, size, stride)) < LIMIT


@pytest.mark.cuda
def test_cuda_writes_dx_whole_into_dirty_memory(cuda):
    """dx takes the block a NaN-filled tensor of its size left: every
    element, the unread rows included, is written."""
    gy, wt, size, stride = on_card(CELL_CONVS["conv1"], cuda)
    CD.conv3d_dgrad(gy, wt, size, stride)      # the packed weights' block
    junk = torch.full((gy.shape[0], wt.shape[1], *size), float("nan"),
                      device=cuda)
    ptr = junk.data_ptr()
    del junk
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    assert dx.data_ptr() == ptr
    assert bool(torch.isfinite(dx).all())
    assert dx[:, :, :, -1].abs().max() == 0 and dx[..., -1].abs().max() == 0


@pytest.mark.cuda
def test_cuda_bitwise_repeat(cuda):
    gy, wt, size, stride = on_card(CELL_CONVS["conv1"], cuda)
    a = CD.conv3d_dgrad(gy, wt, size, stride)
    b = CD.conv3d_dgrad(gy, wt, size, stride)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["tap_shifted", "phase_skipped",
                                   "unread_rows_unzeroed"])
def test_cuda_planted_faults_fail(cuda, fault):
    gy, wt, size, stride = on_card(CELL_CONVS["conv1"], cuda)
    dx = CD.conv3d_dgrad(gy, wt, size, stride)
    ref = CD.dgrad_plain(gy.double(), wt.double(), size, stride)
    if fault == "tap_shifted":
        reading = rel_err(dx[..., 1:], ref[..., :-1])
    elif fault == "phase_skipped":
        dx[:, :, :, 1::2, 1::2] = 0
        reading = rel_err(dx, ref)
    else:
        dx[:, :, :, -1] = dx[..., -1] = ref.abs().max()
        reading = rel_err(dx, ref)
    assert reading > 10 * LIMIT


@pytest.mark.cuda
def test_cuda_branch_step_hand_vs_cudnn(cuda, monkeypatch):
    """One Conv3DBranch train step (forward, backward, SGD update) through
    the hand paths against the cuDNN path, same weights and batch."""
    x = clip(2, n=120).to(cuda)

    def step(dgrad, wgrad):
        monkeypatch.setattr(CD, "fits", dgrad)
        monkeypatch.setattr(CW, "fits", wgrad)
        b = branch3d(2).to(cuda)
        n0 = CD.launches
        b(x).square().sum().backward()
        grads = {k: p.grad.clone() for k, p in b.named_parameters()}
        with torch.no_grad():
            for p in b.parameters():
                p -= 1e-3 * p.grad
        return grads, dict(b.named_parameters()), CD.launches - n0
    hand, hp, nh = step(CD.fits, CW.fits)
    off = lambda *a: False
    ref, rp, nr = step(off, off)
    assert (nh, nr) == (len(taken(120)), 0) == (4, 0)
    for k in ref:
        assert rel_err(hand[k], ref[k].double()) < 1e-4, k
        assert rel_err(hp[k], rp[k].double()) < 1e-6, k


@pytest.mark.cuda
def test_cuda_counter_from_the_autograd_thread(cuda):
    """The kernel launches in the backward, on autograd's device thread;
    a profiled step records ``conv3d.dgrad_hand`` there, once a launch
    (conv1 and conv2 at 4 rows)."""
    from torch.profiler import ProfilerActivity, profile
    b = branch3d(1).to(cuda)
    x = clip(1, n=4).to(cuda)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        b(x).sum().backward()
        torch.cuda.synchronize()
    assert spans.snapshot()["counters"].get("conv3d.dgrad_hand") == len(
        taken(4)) == 2
    spans.clear()


@pytest.mark.cuda
def test_cuda_refuses_other_dtypes(cuda):
    gy, wt, size, stride = on_card(RAGGED[0], cuda)
    with pytest.raises(ValueError):
        CD.conv3d_dgrad(gy.double(), wt.double(), size, stride)
    with pytest.raises(ValueError):
        CD.conv3d_dgrad(gy, wt.cpu(), size, stride)
