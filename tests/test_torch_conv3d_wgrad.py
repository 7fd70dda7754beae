"""The hand weight gradient of the 3D CNN's first conv
(``ops/cuda/conv3d_wgrad.py``, ``csrc/conv3d_wgrad.cu``).  Imports no JAX,
so the card tests run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3d_wgrad.py

On the CPU: the plain version against ``torch.nn.grad.conv3d_weight`` in
float64; the dispatch rule (which layers of ``Conv3DBranch`` engage, and
that none does for ``Conv2DBranch``, bf16, eval, int8 or export), read
with ``conv3d_route.engages`` replaced by ``conv3d_route.fits``, the shared
rule without the device test, and the input gradient's rule off; the
autograd Function's gradients against ``F.conv3d``'s, the same way.

On the card (``-m cuda``): dW and db against float64 at the cell's shapes
and on ragged ones, read as max |kernel - float64| / max |float64| against
LIMIT = 1e-5 (float32 sums over up to 2.16 M positions: the kernel reads
~1e-7 at the cell's shapes; one tap shifted, one (n, t) slab skipped and
the bias left out read 1e-3 and more); two launches bitwise; one
``Conv3DBranch`` train step through the hand path against the cuDNN path;
the counter recorded from the autograd thread; refusals.
"""

import pytest
import torch
import torch.nn.functional as F

from ugaitnet_tpu_torch.core.config import BranchConfig
from ugaitnet_tpu_torch.models.branches import Conv2DBranch, Conv3DBranch
from ugaitnet_tpu_torch.obsv import spans
from ugaitnet_tpu_torch.ops import quantize as Q
from ugaitnet_tpu_torch.ops.cuda import conv3d_dgrad as CD
from ugaitnet_tpu_torch.ops.cuda import conv3d_route as R
from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW

LIMIT = 1e-5
CELL = {"of": 2, "gray": 1}
KERNEL, STRIDE = (3, 5, 5), (1, 2, 2)

# (N, Ci, T, H, W, Co, kernel, stride): the cell's conv0 cut down, odd
# extents, Ci = 3, other strides, Co not a multiple of 64 and above it,
# 192 taps, and 6 taps (a CTA of 8 threads, no full warp)
RAGGED = [(3, 2, 7, 13, 15, 64, (3, 5, 5), (1, 2, 2)),
          (5, 3, 6, 11, 9, 7, (2, 3, 3), (2, 1, 3)),
          (1, 1, 9, 17, 10, 5, (3, 5, 5), (3, 3, 1)),
          (7, 3, 5, 9, 12, 100, (1, 4, 2), (1, 2, 2)),
          (2, 3, 4, 8, 8, 16, (4, 4, 4), (1, 1, 1)),
          (3, 1, 4, 7, 9, 70, (1, 2, 3), (1, 1, 2))]


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def make(n, ci, t, h, w, co, kernel, stride, dtype, device="cpu",
         x_ndhwc=True, gy_format=torch.contiguous_format, seed=0):
    """x (N, Ci, T, H, W), as the branch's NDHWC view or contiguous, and gy
    of the VALID conv's output shape in ``gy_format``."""
    g = torch.Generator(device=device).manual_seed(seed)
    if x_ndhwc:
        x = torch.randn((n, t, h, w, ci), generator=g, dtype=dtype,
                        device=device).permute(0, 4, 1, 2, 3)
    else:
        x = torch.randn((n, ci, t, h, w), generator=g, dtype=dtype,
                        device=device)
    out = CW.out_size((t, h, w), kernel, stride)
    gy = torch.randn((n, co, *out), generator=g, dtype=dtype, device=device)
    return x, gy.contiguous(memory_format=gy_format)


def reference(x, gy, kernel, stride):
    co, ci = gy.shape[1], x.shape[1]
    dw = torch.nn.grad.conv3d_weight(x.double(), (co, ci, *kernel),
                                     gy.double(), stride=stride)
    return dw, gy.double().sum((0, 2, 3, 4))


@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("x_ndhwc", [True, False])
def test_plain_matches_conv3d_weight(case, x_ndhwc):
    x, gy = make(*case, torch.float64, x_ndhwc=x_ndhwc)
    dw, db = CW.conv3d_wgrad(x, gy, case[6], case[7])
    rw, rb = reference(x, gy, case[6], case[7])
    assert dw.shape == rw.shape and db.shape == rb.shape
    assert rel_err(dw, rw) < 1e-12 and rel_err(db, rb) < 1e-12


def test_refusals():
    x, gy = make(*RAGGED[0], torch.float32)
    with pytest.raises(ValueError):
        CW.conv3d_wgrad(x, gy[:, :, :-1], KERNEL, STRIDE)   # not VALID
    with pytest.raises(ValueError):
        CW.conv3d_wgrad(x[0], gy[0], KERNEL, STRIDE)
    with pytest.raises(ValueError):
        CW.conv3d_wgrad(x.to("meta"), gy.to("meta"), KERNEL, STRIDE)


@pytest.fixture
def recorder(monkeypatch):
    """The weight shapes of the convs that take the hand path."""
    seen = []
    conv3d = R.conv3d

    def record(x, w, b, stride, hand):
        seen.append(tuple(w.shape))
        return conv3d(x, w, b, stride, hand)
    monkeypatch.setattr(R, "conv3d", record)
    return seen


@pytest.fixture
def cpu_rule(monkeypatch):
    """The shared rule without its device test, so CPU tensors engage: the
    Function then runs the plain version in its backward.  The input
    gradient's rule stays off, as it is on the CPU."""
    monkeypatch.setattr(R, "engages", R.fits)
    monkeypatch.setattr(CD, "fits", lambda x, w: False)


def branch3d(ci, dtype=torch.float32, seed=0):
    return Conv3DBranch(ci, ndense_units=16, activation="leaky",
                        dtype=dtype,
                        generator=torch.Generator().manual_seed(seed))


def clip(ci, n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 25, 60, 60, ci), generator=g)


@pytest.mark.parametrize("mod", sorted(CELL))
def test_rule_takes_conv0_only(cpu_rule, recorder, mod):
    ci = CELL[mod]
    branch3d(ci)(clip(ci)).sum().backward()
    assert recorder == [(64, ci, 3, 5, 5)]


def test_rule_needs_a_card(recorder):
    """The rule takes no CPU tensor: CPU training keeps F.conv3d."""
    branch3d(2)(clip(2)).sum().backward()
    assert recorder == []


@pytest.mark.parametrize("what", ["conv2d", "bf16", "eval", "frozen",
                                  "export", "int8"])
def test_rule_leaves_other_paths(cpu_rule, recorder, what):
    if what == "conv2d":
        b = Conv2DBranch(50, ndense_units=16,
                         generator=torch.Generator().manual_seed(0))
        b(torch.randn(2, 50, 60, 60)).sum().backward()
    elif what == "bf16":
        branch3d(2, torch.bfloat16)(clip(2)).sum().backward()
    elif what == "eval":
        with torch.no_grad():
            branch3d(2).eval()(clip(2))
    elif what == "frozen":
        b = branch3d(2).requires_grad_(False)
        b(clip(2).requires_grad_()).sum().backward()
    elif what == "export":
        torch.export.export(branch3d(2), (clip(2),))
    else:
        b = branch3d(1)
        bcfg = BranchConfig(kind="conv3d", modality="gray", ndense_units=16)
        qb = Q.quantize_sequential_branch_params(
            b, Q.calibrate_conv3d_branch(b, clip(1), bcfg))
        Q.conv3d_branch_int8(qb, clip(1), bcfg)
    assert recorder == []


@pytest.mark.parametrize("taps, engages", [((255, 1, 1), True),
                                           ((256, 1, 1), False),
                                           ((1, 3, 3), True),
                                           ((64, 3, 3), False)])
def test_rule_threshold(taps, engages):
    ci, kh, kw = taps
    w = torch.zeros((8, ci, 1, kh, kw), requires_grad=True)
    x = torch.zeros(1, ci, 2, 4, 4)
    assert (R.fits(x, w) and CW.fits(x, w)) is engages
    assert not R.hand_grads(x, w, torch.zeros(8), 0)[1]     # no card here
    assert not R.fits(x.double(), w.detach().double().requires_grad_())


@pytest.mark.parametrize("mod", sorted(CELL))
def test_hand_path_gradients_on_the_cpu(monkeypatch, mod):
    """Conv3DBranch's gradients through the Function (plain version in its
    backward) against F.conv3d's autograd, same weights and batch."""
    ci = CELL[mod]
    x = clip(ci)

    monkeypatch.setattr(R, "engages", R.fits)
    monkeypatch.setattr(CD, "fits", lambda x, w: False)

    def grads(rule):
        b = branch3d(ci)
        monkeypatch.setattr(CW, "fits", rule)
        b(x).square().sum().backward()
        return {k: p.grad for k, p in b.named_parameters()}
    hand, ref = grads(CW.fits), grads(lambda x, w: False)
    for k in ref:
        assert rel_err(hand[k], ref[k].double()) < 1e-5, k


def test_input_gradient_when_asked(cpu_rule):
    """A hand-path conv whose input needs a gradient gets it from
    convolution_backward (conv0's input is data and never does)."""
    x, _ = make(*RAGGED[1], torch.float64)
    x32 = x.float().requires_grad_()
    w = torch.randn((7, 3, 2, 3, 3), requires_grad=True)
    b = torch.randn(7, requires_grad=True)
    R.conv3d(x32, w, b, (2, 1, 3),
             R.hand_grads(x32, w, b, 0)).square().sum().backward()
    got = (x32.grad, w.grad, b.grad)
    x32.grad = w.grad = b.grad = None
    F.conv3d(x32, w, b, stride=(2, 1, 3)).square().sum().backward()
    for g, r in zip(got, (x32.grad, w.grad, b.grad)):
        assert rel_err(g, r.double()) < 1e-5


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def cell_case(mod):
    return (120, CELL[mod], 25, 60, 60, 64, KERNEL, STRIDE)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", sorted(CELL))
@pytest.mark.parametrize("gy_format", [torch.contiguous_format,
                                       torch.channels_last_3d])
def test_cuda_cell_shapes_against_float64(cuda, mod, gy_format):
    case = cell_case(mod)
    x, gy = make(*case, torch.float32, cuda, gy_format=gy_format)
    n0 = CW.launches
    dw, db = CW.conv3d_wgrad(x, gy, KERNEL, STRIDE)
    assert CW.launches == n0 + 1
    rw, rb = CW.wgrad_plain(x.double(), gy.double(), KERNEL, STRIDE)
    assert rel_err(dw, rw) < LIMIT and rel_err(db, rb) < LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("x_ndhwc", [True, False])
def test_cuda_ragged_shapes_against_float64(cuda, case, x_ndhwc):
    x, gy = make(*case, torch.float32, cuda, x_ndhwc=x_ndhwc)
    dw, db = CW.conv3d_wgrad(x, gy, case[6], case[7])
    rw, rb = CW.wgrad_plain(x.double(), gy.double(), case[6], case[7])
    assert rel_err(dw, rw) < LIMIT and rel_err(db, rb) < LIMIT


ODD_KERNEL = (1, 4, 8)      # 32 taps: a CTA of 40 threads, one full warp


def odd_gy(layout, cuda):
    """x (2, 1, 2, 19, 8) and a gy (2, 8, 2, 16, 1) for a 1 x 4 x 8 conv,
    in a layout autograd seldom hands over: ``t_inside_h``, t the fastest
    axis after w, so that the 32 positions of a chunk span exactly the 32
    floats gy[n, co] holds, out of order; ``expanded`` across n (stride 0);
    ``offset``, one float past a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 1, 2, 19, 8), generator=g, device=cuda)
    if layout == "t_inside_h":
        gy = torch.randn((2, 8, 16, 2, 1), generator=g, device=cuda)
        gy = gy.permute(0, 1, 3, 2, 4)
    elif layout == "expanded":
        gy = torch.randn((1, 8, 2, 16, 1), generator=g, device=cuda)
        gy = gy.expand(2, -1, -1, -1, -1)
    else:
        gy = torch.randn(2 * 8 * 32 + 1, generator=g, device=cuda)
        gy = gy[1:].view(2, 8, 2, 16, 1)
    return x, gy


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["t_inside_h", "expanded", "offset"])
def test_cuda_gy_layouts_against_float64(cuda, layout):
    """gy's positions in an order other than (n, t, h, w), or not aligned:
    the kernel's 16-byte copies of gy rows must not take them."""
    x, gy = odd_gy(layout, cuda)
    dw, db = CW.conv3d_wgrad(x, gy, ODD_KERNEL, (1, 1, 1))
    rw, rb = CW.wgrad_plain(x.double(), gy.double(), ODD_KERNEL, (1, 1, 1))
    assert rel_err(dw, rw) < LIMIT and rel_err(db, rb) < LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["tap_shifted", "slab_skipped",
                                   "bias_left_out"])
def test_cuda_planted_faults_fail(cuda, fault):
    x, gy = make(*cell_case("gray"), torch.float32, cuda)
    rw, rb = CW.wgrad_plain(x.double(), gy.double(), KERNEL, STRIDE)
    if fault == "tap_shifted":
        dw, _ = CW.conv3d_wgrad(x, gy, KERNEL, STRIDE)
        reading = rel_err(dw[..., 1:], rw[..., :-1])
    elif fault == "slab_skipped":
        gz = gy.clone()
        gz[7, :, 11] = 0
        reading = rel_err(CW.conv3d_wgrad(x, gz, KERNEL, STRIDE)[0], rw)
    else:
        reading = rel_err(torch.zeros_like(rb), rb)
    assert reading > 10 * LIMIT


@pytest.mark.cuda
def test_cuda_bitwise_repeat(cuda):
    x, gy = make(*cell_case("of"), torch.float32, cuda)
    a = CW.conv3d_wgrad(x, gy, KERNEL, STRIDE)
    b = CW.conv3d_wgrad(x, gy, KERNEL, STRIDE)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_cuda_branch_step_hand_vs_cudnn(cuda, monkeypatch):
    """One Conv3DBranch train step (forward, backward, SGD update) through
    the hand path against the cuDNN path, same weights and batch."""
    x = clip(2, n=120).to(cuda)

    def step(rule):
        monkeypatch.setattr(CW, "fits", rule)
        b = branch3d(2).to(cuda)
        n0 = CW.launches
        b(x).square().sum().backward()
        grads = {k: p.grad.clone() for k, p in b.named_parameters()}
        with torch.no_grad():
            for p in b.parameters():
                p -= 1e-3 * p.grad
        return grads, dict(b.named_parameters()), CW.launches - n0
    hand, hp, nh = step(CW.fits)
    ref, rp, nr = step(lambda x, w: False)
    assert (nh, nr) == (1, 0)
    for k in ref:
        assert rel_err(hand[k], ref[k].double()) < 1e-4, k
        assert rel_err(hp[k], rp[k].double()) < 1e-6, k


@pytest.mark.cuda
def test_cuda_counter_from_the_autograd_thread(cuda):
    """The kernel launches in the backward, on autograd's device thread;
    a profiled step records ``conv3d.wgrad_hand`` there."""
    from torch.profiler import ProfilerActivity, profile
    b = branch3d(1).to(cuda)
    x = clip(1, n=4).to(cuda)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        b(x).sum().backward()
        torch.cuda.synchronize()
    assert spans.snapshot()["counters"].get("conv3d.wgrad_hand") == 1
    spans.clear()


@pytest.mark.cuda
def test_cuda_refuses_other_dtypes(cuda):
    x, gy = make(*RAGGED[0], torch.float32, cuda)
    with pytest.raises(ValueError):
        CW.conv3d_wgrad(x.double(), gy.double(), KERNEL, STRIDE)
    with pytest.raises(ValueError):
        CW.conv3d_wgrad(x, gy.cpu(), KERNEL, STRIDE)
