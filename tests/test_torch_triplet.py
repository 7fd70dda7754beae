"""The port's batch-all triplet loss against the JAX package.

The plain PyTorch version (ugaitnet_tpu_torch/ops/triplet.py) is held to the
XLA form (ops/triplet.batch_all_triplet_loss) and to the Pallas kernels run
in interpret mode (batch_all_triplet_loss_pallas(..., interpret=True)), on
the cases of tests/test_pallas_triplet.py.  The CUDA kernel is held to the
plain version on the card in tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: values rtol 1e-5 (float32 sums of up to ~1e4 hinge terms in
another order); gradients rtol 2e-4 / atol 2e-5, as the JAX package's own
Pallas-vs-XLA test states them.
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
                                            make_triplet_loss, pairwise_dist)

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
    for kind in ("semi_hard", "hard"):
        with pytest.raises(NotImplementedError):
            make_triplet_loss(kind)


def test_kernel_wrapper_validates_inputs():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.launch_fwd(x, torch.zeros(4, dtype=torch.int32), 0.2)
    with pytest.raises(ValueError, match="floating point"):
        K.batch_all_triplet_loss_cuda(
            torch.zeros(4, 3, dtype=torch.int64, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"))
