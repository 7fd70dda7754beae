"""The CUDA batch-all triplet kernel and the GaitSet stage tail against
the port's plain versions, and the serving path's card-side ops (top-k
order, augmentation, the int8 cross term and int8 conv sums) against the
same ops on the CPU or an exact int64 product, on the card.  Imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Without a CUDA device
the tests skip.  Tolerances, as chip_smoke.py states them: values rtol
1e-5; gradients max |kernel - plain| <= 1e-2 * max |plain| per case.  The
limit scales with the case because batch-all gradients shrink as 1/count;
the plain version's own float32 rounding (it sums +-1/count per triplet,
where the kernel counts in integers) reads up to ~1e-3 on it, and a
backward that drops the g^T term or returns zeros reads above 0.6.

The kernels are also held to themselves, exactly: dist is bitwise
symmetric with a zero diagonal, the per-part counts equal the active
triplets that torch counts over the kernel's own dist, and the backward's
g equals those integer counts times the scale, bitwise.  The stage tail is
held bitwise in float32 and bfloat16, forward and gradient, ties included,
and an exported program calls its kernel.  With two cards or more, the
kernels and a GaitSet branch run on a card that is not the current device,
and pipeline parallelism places a branch on cuda:1 (skipped on one card)."""

import numpy as np
import pytest
import torch

from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
from ugaitnet_tpu_torch.ops.pooling import stage_tail
from ugaitnet_tpu_torch.ops.triplet import (batch_all_triplet_loss,
                                            pairwise_dist)

VAL_RTOL = 1e-5
GRAD_REL = 1e-2

# (parts, B, D, seed, ids per label); parts None = rank-2 (B, D)
# D = 8 and 40 are not multiples of the kernels' 32-wide D-chunk (nor of
# the finish kernel's 128 columns); D = 10 and B = 37 take the 4-byte copies
CASES = [(1, 12, 8, 0, 4), (5, 12, 16, 0, 4), (62, 8, 16, 0, 4),
         (None, 10, 8, 1, 2), (3, 12, 8, 2, 4), (62, 120, 256, 4, 10),
         (4, 256, 64, 6, 4), (2, 160, 32, 0, 16), (3, 50, 40, 7, 5),
         (2, 37, 10, 3, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(cuda, parts, b, d, seed, k):
    rng = np.random.RandomState(seed)
    shape = (b, d) if parts is None else (b, parts, d)
    emb = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(
        np.repeat(np.arange(b // k + 1), k)[:b].astype(np.int32)).to(cuda)
    return emb, labels


@pytest.mark.cuda
@pytest.mark.parametrize("parts,b,d,seed,k", CASES)
def test_cuda_kernel_matches_plain(cuda, parts, b, d, seed, k):
    emb, labels = _case(cuda, parts, b, d, seed, k)
    xp = emb.clone().requires_grad_(True)
    want = batch_all_triplet_loss(xp, labels)
    want.backward()
    xk = emb.clone().requires_grad_(True)
    got = K.batch_all_triplet_loss_cuda(xk, labels)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=VAL_RTOL)
    want_g = xp.grad.cpu().numpy()
    np.testing.assert_allclose(xk.grad.cpu().numpy(), want_g, rtol=0,
                               atol=GRAD_REL * np.abs(want_g).max())


@pytest.mark.cuda
@pytest.mark.parametrize("labels", [np.zeros(6), np.arange(6)])
def test_cuda_degenerate_batches(cuda, labels):
    emb = torch.randn(6, 2, 8, device=cuda).requires_grad_(True)
    lab = torch.as_tensor(labels, dtype=torch.int32, device=cuda)
    val = K.batch_all_triplet_loss_cuda(emb, lab)
    val.backward()
    assert float(val.detach()) == 0.0
    assert torch.equal(emb.grad, torch.zeros_like(emb.grad))


@pytest.mark.cuda
def test_cuda_launch_counts_and_dtype(cuda):
    K.reset_launch_counts()
    emb = torch.randn(12, 3, 8, device=cuda, dtype=torch.bfloat16)
    emb.requires_grad_(True)
    lab = torch.as_tensor(np.repeat(np.arange(3), 4), device=cuda)
    K.batch_all_triplet_loss_cuda(emb, lab).backward()
    assert (K.fwd_launches, K.bwd_launches) == (1, 1)
    assert emb.grad.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("parts,b,d,seed,k", CASES)
def test_cuda_dist_symmetric_zero_diagonal(cuda, parts, b, d, seed, k):
    emb, labels = _case(cuda, parts, b, d, seed, k)
    dist, _, _ = K.launch_fwd(emb, labels, 0.2)
    assert torch.equal(dist, dist.transpose(1, 2))
    assert torch.equal(torch.diagonal(dist, dim1=1, dim2=2),
                       torch.zeros(dist.shape[:2], device=cuda))
    x = emb[None] if emb.ndim == 2 else emb.transpose(0, 1)
    want = pairwise_dist(x)
    assert float((dist - want).abs().max()) <= 1e-5 * float(want.max())


@pytest.mark.cuda
@pytest.mark.parametrize("parts,b,d,seed,k", CASES)
def test_cuda_counts_and_g_exact(cuda, parts, b, d, seed, k):
    """Counts and g against torch over the kernel's own dist, exactly."""
    margin = 0.2
    emb, labels = _case(cuda, parts, b, d, seed, k)
    dist, _, count = K.launch_fwd(emb, labels, margin)
    scale = torch.where(count > 0, 1.0 / (count.clamp_min(1.0) * len(count)),
                        torch.zeros_like(count))
    _, g = K.launch_bwd(emb, labels, dist, scale, margin)
    same = labels[:, None] == labels[None, :]
    act = ((margin + dist[:, :, :, None] - dist[:, :, None, :]) > 0) \
        & same[:, :, None] & ~same[:, None, :]            # act[p, a, j, k]
    assert torch.equal(count.to(torch.int64), act.sum((1, 2, 3)))
    want_g = (act.sum(3) - act.sum(2)).to(torch.float32) * scale[:, None, None]
    assert torch.equal(g, want_g)


@pytest.mark.cuda
def test_cuda_nearest_tie_order(cuda):
    """Exact ties on the card keep jax.lax.top_k's order: the lower gallery
    index first, as on the CPU."""
    from ugaitnet_tpu_torch.ops.knn import knn_predict, nearest, pairwise_l2
    rng = np.random.RandomState(0)
    base = rng.randn(50, 64).astype(np.float32)
    gallery = np.concatenate([base, base, base])          # every row 3 times
    probes = torch.from_numpy(base[:20])
    d2 = pairwise_l2(probes, torch.from_numpy(gallery)).to(cuda)
    d2[:, :50] = d2[:, 50:100]               # bitwise ties on the card too
    vals, idx = nearest(d2, 5)
    want_vals, want_idx = nearest(d2.cpu(), 5)
    assert torch.equal(idx.cpu(), want_idx)
    assert torch.equal(vals.cpu(), want_vals)
    labels = np.arange(150) % 7
    assert np.array_equal(
        knn_predict(base, gallery, labels, k=3, device=cuda),
        knn_predict(base, gallery, labels, k=3, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("is_of", [True, False])
def test_cuda_augment_matches_cpu(cuda, is_of):
    """The float64-emulated fused multiply-adds of the affine and the
    photometric min-max agree across devices within 1e-6 of the largest
    value (float64 FMA contraction on the card may move a value by an
    ulp)."""
    from ugaitnet_tpu_torch.ops import augment as A
    gen = torch.Generator().manual_seed(3)
    p = A.random_transform_params(gen, 6, device="cpu")
    p = p._replace(apply=torch.ones(6, dtype=torch.bool))
    x = torch.randn(6, 25, 60, 60, 2 if is_of else 1, generator=gen)
    want = A.augment_batch(x, p, is_of)
    got = A.augment_batch(x.to(cuda), A.TransformParams(
        *(v.to(cuda) for v in p)), is_of).cpu()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def _packed_set(tmp_path):
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    make_synthetic_dataset(num_subjects=6, videos_per_subject=3,
                           subseqs_per_video=2, seed=4).save(str(tmp_path))
    return GaitDataset.load(str(tmp_path))          # memory-mapped stores


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
def test_cuda_prefetch_loader_matches_synchronous_load(cuda, tmp_path,
                                                       normalize):
    """PrefetchLoader (gather on its thread into page-locked buffers,
    non-blocking copies) yields bitwise the batches GaitPipeline.load gives
    for the same (seed, epoch, i): augmentation and expand-3 dropout on,
    with and without the plane-wise standardization (--normstats)."""
    from ugaitnet_tpu_torch.core.config import DataConfig
    from ugaitnet_tpu_torch.data.pipeline import (GaitPipeline,
                                                  PrefetchLoader,
                                                  batch_generator,
                                                  compute_normalization_stats)
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    ds = _packed_set(tmp_path)
    cfg = DataConfig(batch_size=8, expand_level=3, repetitions=2)
    norm_stats = None
    if normalize:
        norm_stats = {}
        for m in ("of", "gray"):
            mean, std = compute_normalization_stats(ds, m)
            norm_stats[m] = (mean[None], std[None])
    pipe = GaitPipeline(ds, cfg, ("of", "gray"), labmap=ds.label_map(),
                        norm_stats=norm_stats, device=cuda)
    seed, epoch = 3, 2

    def sampler():
        return BalancedGaitSampler(ds.labels, ds.gaits, 8, 2, seed=seed)

    got = list(PrefetchLoader(pipe, sampler(), seed, epoch))
    want = [pipe.load(idx, batch_generator(seed, epoch, i))
            for i, idx in enumerate(sampler().epoch())]
    assert len(got) == len(want) == len(sampler()) > 1
    for (gv, gf, gl), (wv, wf, wl) in zip(got, want):
        assert gv[0].device.type == "cuda"
        for a, b in zip(list(gv) + list(gf) + [gl], list(wv) + list(wf)
                        + [wl]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_on_cuda_and_cpu(cuda, tmp_path):
    """A state trained on the card restores bitwise onto the card and onto
    the CPU: parameters, Adam's step counts and moments, the lr."""
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.core.config import (BranchConfig, ModelConfig,
                                                TrainConfig)
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import init_state, set_lr
    b = dict(kind="gaitset", gaitset_channels=(4, 4, 8), part_dim=8)
    mcfg = ModelConfig(branches=(BranchConfig(modality="of", **b),
                                 BranchConfig(modality="gray", **b)),
                       merge="sign_max", nclasses=4)
    tcfg = TrainConfig(lr=1e-3)
    state = init_state(UGaitNet(mcfg, device=cuda), tcfg)
    for _ in range(3):
        state.optimizer.zero_grad()
        sum((p * p).sum() for p in state.model.parameters()).backward()
        state.optimizer.step()
        state.step += 1
    set_lr(state, 2.5e-4)
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    for dev in (cuda, torch.device("cpu")):
        fresh = ckpt.restore_checkpoint(str(tmp_path), 3, init_state(
            UGaitNet(mcfg, device=dev, seed=5), tcfg))
        assert fresh.step == 3
        assert fresh.optimizer.param_groups[0]["lr"] == \
            state.optimizer.param_groups[0]["lr"]
        for k, v in state.model.state_dict().items():
            got = fresh.model.state_dict()[k]
            assert got.device.type == dev.type and torch.equal(got.cpu(),
                                                               v.cpu()), k
        want_st = state.optimizer.state_dict()["state"]
        got_st = fresh.optimizer.state_dict()["state"]
        for i, st in want_st.items():
            for k, v in st.items():
                assert torch.equal(got_st[i][k].cpu(), v.cpu()), (i, k)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 8, 128])
def test_cuda_int8_cross_term_exact(cuda, p):
    """The int8 gallery's cross term on the card (cuBLASLt through
    ``int8_mm``, probe rows padded to its layout rules) equals an exact
    int64 product, at the flagship's D = 15,872."""
    from ugaitnet_tpu_torch.ops.knn import int8_mm
    rng = np.random.RandomState(p)
    a = rng.randint(-127, 128, (p, 15872)).astype(np.int8)
    b = rng.randint(-127, 128, (2200, 15872)).astype(np.int8)
    got = int8_mm(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    want = torch.from_numpy(a).long() @ torch.from_numpy(b).long().T
    assert got.dtype == torch.int32 and torch.equal(got.cpu().long(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,strides,same,cin,cout", [
    ((3, 3), (1, 1), True, 32, 32), ((7, 7), (1, 1), False, 50, 64),
    ((3, 5, 5), (1, 2, 2), False, 2, 64)])
def test_cuda_int8_conv_matches_cpu(cuda, kernel, strides, same, cin, cout):
    """QuantConv's int32 sums on the card equal the CPU's, bitwise."""
    from ugaitnet_tpu_torch.ops.quantize import QuantConv
    rng = np.random.RandomState(cin)
    spatial = (25, 60, 60) if len(kernel) == 3 else (64, 64)
    x = torch.from_numpy(rng.randint(-127, 128, (4, *spatial, cin))
                         .astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (cout, *kernel, cin))
                         .astype(np.int8))
    conv = QuantConv(w, torch.ones(cout), 1.0, None, strides, same)
    want = conv(x, lambda y: y)
    got = conv.to(cuda)(x.to(cuda), lambda y: y)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


# ---- the GaitSet stage tail (ops/cuda/stage_tail.py) -----------------------
# (B, T, C, H, W): the vector path (W a multiple of 8), W = 12 (float32's
# vectors, not bfloat16's), odd H and W, T = 1, one channel
TAIL_CASES = [(2, 3, 4, 16, 16), (3, 2, 5, 8, 12), (2, 4, 3, 7, 9),
              (4, 1, 2, 6, 10), (1, 5, 1, 11, 5)]


def _tail_input(cuda, b, t, c, h, w, dtype, tied):
    rng = np.random.RandomState(h * w + c)
    x = rng.randn(b * t, c, h, w).astype(np.float32)
    if tied:                       # a constant clip, zero windows, repeats
        x[:t] = 0.5
        x[-1, :, :2, :2] = 0.0
        if b > 1 and t > 1:
            x[t:2 * t] = x[t]
    return torch.from_numpy(x).to(cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("b,t,c,h,w", TAIL_CASES)
def test_cuda_stage_tail_matches_plain(cuda, dtype, tied, b, t, c, h, w):
    """Forward bitwise; the gradient bitwise too (the kernel rounds as
    torch's autograd formulas do, one rounding per op)."""
    x = _tail_input(cuda, b, t, c, h, w, dtype, tied)
    ST.reset_launch_counts()
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    ak, sk = ST.stage_tail_cuda(xk, b)
    ap, sp = stage_tail(xp, b, 0.3)
    assert torch.equal(ak, ap) and torch.equal(sk, sp)
    g = torch.Generator(device=cuda).manual_seed(0)
    ga = torch.randn(ap.shape, device=cuda, generator=g).to(dtype)
    gs = torch.randn(sp.shape, device=cuda, generator=g).to(dtype)
    (dk,) = torch.autograd.grad((ak, sk), xk, (ga, gs))
    (dp,) = torch.autograd.grad((ap, sp), xp, (ga, gs))
    torch.cuda.synchronize()
    assert dk.dtype == dtype and torch.equal(dk, dp)
    assert (ST.fwd_launches, ST.bwd_launches) == (1, 1)


@pytest.mark.cuda
def test_cuda_stage_tail_raises(cuda):
    x = torch.randn(6, 3, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ST.stage_tail_cuda(x.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ST.stage_tail_cuda(x.transpose(2, 3), 2)
    with pytest.raises(ValueError, match="do not split"):
        ST.stage_tail_cuda(x, 4)


@pytest.mark.cuda
def test_cuda_stage_tail_export_calls_the_kernel(cuda, tmp_path):
    """torch.export records the op; the saved program, loaded, launches the
    forward kernel and gives the plain chain's values bitwise."""
    from ugaitnet_tpu_torch.eval.export import _custom_ops

    class Tail(torch.nn.Module):
        def forward(self, x):
            return ST.stage_tail_cuda(x, 2, 0.3)

    x = _tail_input(cuda, 2, 3, 4, 16, 16, torch.float32, True)
    prog = torch.export.export(Tail(), (x,))
    path = str(tmp_path / "tail.pt2")
    torch.export.save(prog, path)
    loaded = torch.export.load(path)
    assert _custom_ops(loaded) == ["ugaitnet::stage_tail"]
    ST.reset_launch_counts()
    with torch.no_grad():
        a, s = loaded.module()(x)
    ap, sp = stage_tail(x, 2, 0.3)
    assert torch.equal(a, ap) and torch.equal(s, sp)
    assert (ST.fwd_launches, ST.bwd_launches) == (1, 0)


# ---- kernels on a card that is not the current device -------------------
@pytest.fixture
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def _tiny_gaitset(nclasses=4):
    from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
    b = dict(kind="gaitset", gaitset_channels=(4, 4, 8), part_dim=8)
    return ModelConfig(branches=(BranchConfig(modality="of", **b),
                                 BranchConfig(modality="gray", **b)),
                       merge="sign_max", nclasses=nclasses)


def _tiny_batch(device, b=8, seed=0):
    from ugaitnet_tpu_torch.train.train_step import Batch
    rng = np.random.RandomState(seed)
    vols = (rng.randn(b, 25, 60, 60, 2), rng.randn(b, 25, 60, 60, 1))
    flags = (np.ones(b), np.ones(b))
    flags[0][1] = 0.0
    labels = np.repeat(np.arange(b // 2), 2) % 4
    return Batch(tuple(torch.from_numpy(v.astype(np.float32)).to(device)
                       for v in vols),
                 tuple(torch.from_numpy(f.astype(np.float32)).to(device)
                       for f in flags),
                 torch.from_numpy(labels.astype(np.int32)).to(device))


@pytest.mark.cuda
def test_cuda_kernels_on_a_card_that_is_not_current(cards, monkeypatch):
    """cuda:0 is current and the tensors live on the last card: the stage
    tail (forward and gradient, bitwise against the plain chain there), the
    triplet kernels (the rule of test_cuda_kernel_matches_plain) and a
    GaitSet branch's forward and backward (the kernel route against the
    plain tail on that card: output bitwise, gradients within GRAD_REL of
    max) launch on the tensors' card."""
    from ugaitnet_tpu_torch.models import gaitset as GS
    dev = cards[-1]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ST.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        x = _tail_input(dev, 2, 3, 4, 16, 16, dtype, True)
        xk, xp = (x.clone().requires_grad_(True) for _ in range(2))
        ak, sk = ST.stage_tail_cuda(xk, 2)
        ap, sp = stage_tail(xp, 2, 0.3)
        assert ak.device == dev and torch.equal(ak, ap) \
            and torch.equal(sk, sp)
        ga, gs = torch.randn_like(ap), torch.randn_like(sp)
        (dk,) = torch.autograd.grad((ak, sk), xk, (ga, gs))
        (dp,) = torch.autograd.grad((ap, sp), xp, (ga, gs))
        assert torch.equal(dk, dp)
    assert (ST.fwd_launches, ST.bwd_launches) == (2, 2)

    emb, labels = _case(dev, 62, 120, 256, 4, 10)
    xp, xk = (emb.clone().requires_grad_(True) for _ in range(2))
    want = batch_all_triplet_loss(xp, labels)
    want.backward()
    K.reset_launch_counts()
    got = K.batch_all_triplet_loss_cuda(xk, labels)
    got.backward()
    assert (K.fwd_launches, K.bwd_launches) == (1, 1)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=VAL_RTOL)
    want_g = xp.grad.cpu().numpy()
    np.testing.assert_allclose(xk.grad.cpu().numpy(), want_g, rtol=0,
                               atol=GRAD_REL * np.abs(want_g).max())

    vol = _tiny_batch(dev).volumes[0]
    outs = []
    for route in ("kernel", "plain"):
        gen = torch.Generator().manual_seed(0)
        branch = GS.GaitSetBranch(2, channels=(4, 4, 8), part_dim=8,
                                  generator=gen).to(dev)
        with monkeypatch.context() as m:
            if route == "plain":
                m.setattr(GS, "stage_tail_cuda", stage_tail)
            ST.reset_launch_counts()
            out = branch(vol)
            out.square().sum().backward()
            outs.append((out.detach(), [p.grad for p in branch.parameters()],
                         (ST.fwd_launches, ST.bwd_launches)))
    (ok, gk, nk), (op, gp, np_) = outs
    assert nk == (2, 2) and np_ == (0, 0)
    assert torch.equal(ok, op)
    for a, b in zip(gk, gp):
        assert a.device == dev
        tol = GRAD_REL * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_cuda_pipeline_across_two_cards(cards, monkeypatch):
    """make_pipeline_train_step with branch 1 on cuda:1 against the
    one-process step on cuda:0, from the same weights and batch (SGD at lr
    0, so the gradients stay in .grad): losses within 1e-5, each gradient
    within GRAD_REL of its max, and a planted fault (branch 1's gradient
    dropped) above that; the stage tail launches on both cards (2 + 2 per
    branch) and the triplet kernels once each on the head's."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.parallel import pipeline as P
    from ugaitnet_tpu_torch.train.train_step import (init_state,
                                                     make_train_step)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mcfg = _tiny_gaitset()
    tcfg = TrainConfig(optimizer="sgd", lr=0.0)
    batch = _tiny_batch(cards[0])

    def run(pipeline, fault=False):
        state = init_state(UGaitNet(mcfg, device=cards[0], seed=0), tcfg)
        step = (P.make_pipeline_train_step(state.model, state.optimizer,
                                           mcfg, tcfg, cards[:2])
                if pipeline else make_train_step(mcfg, tcfg))
        ST.reset_launch_counts()
        K.reset_launch_counts()
        with monkeypatch.context() as m:
            if fault:
                m.setattr(P, "add_branch_grads", lambda *a: None)
            _, met = step(state, batch)
        launches = (ST.fwd_launches, ST.bwd_launches, K.fwd_launches,
                    K.bwd_launches)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in state.model.named_parameters()}
        return {k: float(v) for k, v in met.items()}, grads, launches

    m1, g1, n1 = run(False)
    mp, gp, np_ = run(True)
    _, gf, _ = run(True, fault=True)
    assert n1 == np_ == (4, 4, 1, 1)
    for k, v in m1.items():
        assert abs(mp[k] - v) <= 1e-5 * max(abs(v), 1e-12), k

    def err(g):
        return max(float((g[k] - g1[k]).abs().max())
                   / max(float(g1[k].abs().max()), 1e-30) for k in g1)

    assert err(gp) <= GRAD_REL
    assert err(gf) > GRAD_REL
