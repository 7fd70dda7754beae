"""The port's batch-all triplet loss against the JAX package.

The plain PyTorch version (ugaitnet_tpu_torch/ops/triplet.py) is held to the
XLA form (ops/triplet.batch_all_triplet_loss) and to the Pallas kernels run
in interpret mode (batch_all_triplet_loss_pallas(..., interpret=True)), on
the cases of tests/test_pallas_triplet.py.  The CUDA kernel is held to the
plain version on the card in tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: values rtol 1e-5 (float32 sums of up to ~1e4 hinge terms in
another order); gradients rtol 2e-4 / atol 2e-5, as the JAX package's own
Pallas-vs-XLA test states them.

The CUDA kernels' launch plan (tiles, grids, shared memory) is pure Python
and is checked here; the distance diagonal's divergence from the reference
is shown here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.ops.pallas.triplet_kernel import (
    batch_all_triplet_loss_pallas)
from ugaitnet_tpu.ops.triplet import batch_all_triplet_loss as j_triplet
from ugaitnet_tpu.ops.triplet import pairwise_dist as j_pairwise

from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
from ugaitnet_tpu_torch.ops.triplet import (batch_all_triplet_loss,
                                            hard_triplet_loss,
                                            make_triplet_loss, pairwise_dist,
                                            semi_hard_triplet_loss)

torch.set_num_threads(1)

VAL_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _torch_value_grad(emb, labels, fn=batch_all_triplet_loss):
    x = torch.from_numpy(emb).requires_grad_(True)
    val = fn(x, torch.from_numpy(labels), margin=0.2)
    val.backward()
    return float(val.detach()), x.grad.numpy()


def _jax_value_grad(fn, emb, labels):
    return jax.value_and_grad(lambda e: fn(e, jnp.asarray(labels)))(
        jnp.asarray(emb))


def _case(parts, b, d, seed, k=4):
    rng = np.random.RandomState(seed)
    shape = (b, d) if parts is None else (b, parts, d)
    emb = rng.randn(*shape).astype(np.float32)
    labels = np.repeat(np.arange(b // k + 1), k)[:b].astype(np.int32)
    return emb, labels


def test_pairwise_dist_matches():
    emb, _ = _case(3, 12, 8, seed=5)
    x = np.transpose(emb, (1, 0, 2))
    want = np.asarray(j_pairwise(jnp.asarray(x)))
    got = pairwise_dist(torch.from_numpy(x)).numpy()
    off = ~np.eye(12, dtype=bool)[None].repeat(3, 0)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=1e-6)
    # the diagonal is sqrt(2|x|^2 - 2 x.x): 0, or the root of a rounding
    # residue (|x|^2 ~ 8 here: sqrt(8 * 2^-23 * few) < 5e-3) in either one
    assert np.abs(np.diagonal(got, axis1=1, axis2=2)).max() < 5e-3
    assert np.abs(np.diagonal(want, axis1=1, axis2=2)).max() < 5e-3


@pytest.mark.parametrize("parts,b,d", [(62, 120, 256), (62, 12, 16)])
def test_distance_diagonal_divergence(parts, b, d):
    """No unmasked port can reproduce the reference's distance diagonal.

    On batch-axis-normalized inputs (as ``l2_mode="reference"`` gives), the
    JAX formula leaves d2[i, i] = 2|xi|^2 - 2 xi.xi as a float32 rounding
    residue that depends on the BLAS's summation order: the same formula in
    torch leaves another one.  The port's diagonal is the exact value 0,
    the same on every backend; its off-diagonal stays within the tolerance
    of test_pairwise_dist_matches.  (ROADMAP.md section 3, "Not faults".)
    """
    rng = np.random.RandomState(0)
    emb = rng.randn(b, parts, d).astype(np.float32)
    emb /= np.sqrt(np.maximum(np.sum(emb * emb, axis=0, keepdims=True),
                              1e-12))
    x = np.ascontiguousarray(np.transpose(emb, (1, 0, 2)))
    ref_d2 = np.asarray(j_pairwise(jnp.asarray(x), squared=True))
    xt = torch.from_numpy(x)
    sq = torch.sum(xt * xt, dim=-1)
    torch_d2 = torch.clamp_min(
        sq[..., :, None] + sq[..., None, :] - 2.0 * xt @ xt.transpose(-1, -2),
        0.0).numpy()
    ref_diag = np.diagonal(ref_d2, axis1=1, axis2=2)
    torch_diag = np.diagonal(torch_d2, axis1=1, axis2=2)
    assert np.count_nonzero(ref_diag) > 0 and np.count_nonzero(torch_diag) > 0
    assert not np.array_equal(ref_diag, torch_diag), (
        np.count_nonzero(ref_diag), np.count_nonzero(torch_diag))

    got = pairwise_dist(xt).numpy()
    want = np.asarray(j_pairwise(jnp.asarray(x)))
    assert np.array_equal(np.diagonal(got, axis1=1, axis2=2),
                          np.zeros((parts, b), np.float32))
    off = ~np.eye(b, dtype=bool)
    np.testing.assert_allclose(got[:, off], want[:, off], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("parts,b,d", [
    (1, 12, 8), (62, 8, 16), (62, 120, 256), (16, 256, 256), (4, 512, 256),
    (2, 160, 32), (1, 4096, 256)])
def test_launch_plan(parts, b, d):
    """The CUDA kernels' launch geometry, checked where there is no card."""
    pl = K.plan(parts, b, d)

    def covers_once(tile, grid, n):
        hits = np.zeros(n, np.int64)
        for t in range(grid):
            assert t * tile < n, "a CTA with no rows"
            hits[t * tile:(t + 1) * tile] += 1
        return (hits == 1).all()

    assert covers_once(pl.fwd_ta, pl.fwd_grid_x, b)       # anchors
    assert covers_once(pl.rows_ta, pl.rows_grid_x, b)     # g rows
    assert covers_once(pl.fin_ti, pl.fin_grid_x, b)       # dx rows
    assert covers_once(K.COLS, pl.fin_grid_y, d)          # dx columns
    assert pl.fwd_ta in (8, 16, 32) and pl.fin_ti in (8, 16, 32)
    assert pl.rows_ta in (1, 2, 4, 8, 16)
    for smem in (pl.fwd_smem, pl.rows_smem, pl.fin_smem):
        assert 0 < smem <= K.MAX_SMEM == 232_448
    assert pl.fwd_smem == K.fwd_smem_bytes(pl.fwd_ta, b)
    assert pl.rows_smem == K.rows_smem_bytes(pl.rows_ta, b)
    assert pl.fin_smem == K.finish_smem_bytes(pl.fin_ti, b)
    # one (sum, count) slot per forward CTA, which launch_fwd sums over dim 1
    dist, sums, counts = K.fwd_outputs(pl, parts, b, "meta")
    assert dist.shape == (parts, b, b)
    assert sums.shape == counts.shape == (parts, pl.fwd_grid_x)
    assert sums.sum(1).shape == (parts,)


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="too large"):
        K.plan(1, 8192, 256)


# (parts, B, D) of tests/test_pallas_triplet.py; None = rank-2 (B, D)
CASES = [(1, 12, 8, 0), (5, 12, 16, 0), (62, 8, 16, 0), (None, 10, 8, 1),
         (3, 12, 8, 2)]


@pytest.mark.parametrize("parts,b,d,seed", CASES)
def test_plain_matches_xla_and_pallas(parts, b, d, seed):
    emb, labels = _case(parts, b, d, seed, k=2 if parts is None else 4)
    got_v, got_g = _torch_value_grad(emb, labels)
    xla_v, xla_g = _jax_value_grad(
        lambda e, l: j_triplet(e, l, margin=0.2), emb, labels)
    pal_v, pal_g = _jax_value_grad(
        lambda e, l: batch_all_triplet_loss_pallas(e, l, margin=0.2,
                                                   interpret=True),
        emb, labels)
    assert got_v > 0
    for want_v, want_g in ((xla_v, xla_g), (pal_v, pal_g)):
        np.testing.assert_allclose(got_v, float(want_v), rtol=VAL_RTOL)
        np.testing.assert_allclose(got_g, np.asarray(want_g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", ["same", "distinct"])
def test_degenerate_batches_zero_loss_finite_grad(kind):
    rng = np.random.RandomState(3)
    emb = rng.randn(6, 2, 8).astype(np.float32)
    labels = (np.zeros(6) if kind == "same" else np.arange(6)).astype(np.int32)
    val, grad = _torch_value_grad(emb, labels)
    assert val == 0.0
    assert np.isfinite(grad).all() and (grad == 0).all()


def test_past_128_matches_gridded_pallas():
    """B = 160: the size the JAX package sends to its gridded kernels."""
    rng = np.random.RandomState(0)
    b = 160
    emb = rng.randn(b, 2, 32).astype(np.float32)
    labels = (np.arange(b) % 10).astype(np.int32)
    got_v, got_g = _torch_value_grad(emb, labels)
    want_v, want_g = _jax_value_grad(
        lambda e, l: batch_all_triplet_loss_pallas(
            e, l, 0.2, interpret=True, grid_variant=True), emb, labels)
    np.testing.assert_allclose(got_v, float(want_v), rtol=VAL_RTOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    emb, labels = _case(3, 12, 8, seed=2)
    K.reset_launch_counts()
    for kind in ("batch_all", "batch_all_pallas", "batch_all_xla"):
        got = _torch_value_grad(emb, labels, make_triplet_loss(kind, 0.2))
        want = _torch_value_grad(emb, labels)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert K.fwd_launches == 0 and K.bwd_launches == 0
    for kind, fn in (("semi_hard", semi_hard_triplet_loss),
                     ("hard", hard_triplet_loss)):
        got = make_triplet_loss(kind, 0.2)
        assert got.func is fn and got.keywords == {"margin": 0.2}


def test_kernel_wrapper_validates_inputs():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.launch_fwd(x, torch.zeros(4, dtype=torch.int32), 0.2)
    with pytest.raises(ValueError, match="floating point"):
        K.batch_all_triplet_loss_cuda(
            torch.zeros(4, 3, dtype=torch.int64, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"))
