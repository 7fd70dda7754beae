"""The CUDA batch-all triplet kernel against the port's plain version, and
the serving path's card-side ops (top-k order, augmentation) against the
same ops on the CPU, on the card.  Imports no JAX, so it runs where only the port is installed:

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
g equals those integer counts times the scale, bitwise.
"""

import numpy as np
import pytest
import torch

from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
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
