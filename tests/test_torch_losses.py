"""The port's losses (``ops/losses.py`` and the triplet kinds of
``ops/triplet.py``) against the JAX package's, on the CPU, on the same
seeded numpy inputs: values and gradients (``jax.grad`` against autograd).

The JAX triplet kinds run with their ``pairwise_dist`` diagonal zeroed,
as the port's is (ROADMAP.md section 3).

Tolerances, with the largest error measured on a CPU (torch on one
thread):
  * values: rtol 1e-5 (float32 in two frameworks; measured <= 2.1e-6).
  * gradients: max |port - JAX| <= 1e-5 x max |JAX| (measured <= 2.3e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.ops import losses as JL
from ugaitnet_tpu.ops import triplet as JT

from ugaitnet_tpu_torch.ops import losses as TL
from ugaitnet_tpu_torch.ops import triplet as TT

torch.set_num_threads(1)

VAL_RTOL = 1e-5
GRAD_REL = 1e-5

_JAX_PAIRWISE = JT.pairwise_dist


def _exact_diagonal_dist(x, squared=False):
    d = _JAX_PAIRWISE(x, squared)
    return jnp.where(jnp.eye(d.shape[-1], dtype=bool), 0.0, d)


@pytest.fixture(autouse=True)
def zero_diagonal(monkeypatch):
    monkeypatch.setattr(JT, "pairwise_dist", _exact_diagonal_dist)


def _value_grads(jfn, tfn, arrays, nondiff=()):
    """(JAX value, JAX grads, port value, port grads) of fn(*arrays,
    *nondiff), the gradient taken w.r.t. every array."""
    jv, jg = jax.value_and_grad(
        lambda *a: jfn(*a, *[jnp.asarray(n) for n in nondiff]),
        argnums=tuple(range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts, *[torch.as_tensor(n) for n in nondiff])
    tg = torch.autograd.grad(tv, ts, allow_unused=True)
    tg = [np.zeros_like(a) if g is None else g.numpy()
          for a, g in zip(arrays, tg)]
    return float(jv), [np.asarray(g) for g in jg], float(tv.detach()), tg


def _check(jv, jg, tv, tg):
    assert np.isfinite(tv) and np.isfinite(jv)
    np.testing.assert_allclose(tv, jv, rtol=VAL_RTOL, atol=1e-7)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all() and np.isfinite(b).all()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_REL * np.abs(b).max() + 1e-12)


def _emb(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


PK = np.repeat(np.arange(3), 4).astype(np.int32)       # 3 ids x 4


@pytest.mark.parametrize("shape", [(12, 3, 16), (12, 16)])
@pytest.mark.parametrize("margin", [0.2, 1.0])
def test_semi_hard_matches_jax(shape, margin):
    got = _value_grads(
        lambda e, l: JT.semi_hard_triplet_loss(e, l, margin),
        lambda e, l: TT.semi_hard_triplet_loss(e, l, margin),
        [_emb(shape, 1)], [PK])
    assert got[2] > 0
    _check(*got)


@pytest.mark.parametrize("shape", [(12, 3, 16), (12, 16)])
@pytest.mark.parametrize("soft", [False, True])
def test_hard_matches_jax(shape, soft):
    got = _value_grads(
        lambda e, l: JT.hard_triplet_loss(e, l, 1.0, soft),
        lambda e, l: TT.hard_triplet_loss(e, l, 1.0, soft),
        [_emb(shape, 2)], [PK])
    assert got[2] > 0
    _check(*got)


def test_semi_hard_chunks_parts():
    """More parts than one chunk: the chunked mean over parts equals the
    JAX per-part vmap."""
    P = TT._PART_CHUNK * 2 + 3
    _check(*_value_grads(
        lambda e, l: JT.semi_hard_triplet_loss(e, l, 0.2),
        lambda e, l: TT.semi_hard_triplet_loss(e, l, 0.2),
        [_emb((12, P, 8), 3)], [PK]))


DEGENERATE = {"all one label": np.zeros(6, np.int32),
              "all distinct": np.arange(6, dtype=np.int32),
              "singleton class": np.array([0, 0, 1, 1, 2, 1], np.int32)}


@pytest.mark.parametrize("name", sorted(DEGENERATE))
@pytest.mark.parametrize("kind", ["semi_hard", "hard", "contrastive"])
def test_degenerate_batches_finite_and_equal(kind, name):
    labels = DEGENERATE[name]
    jfn, tfn = {
        "semi_hard": (lambda e, l: JT.semi_hard_triplet_loss(e, l, 1.0),
                      lambda e, l: TT.semi_hard_triplet_loss(e, l, 1.0)),
        "hard": (lambda e, l: JT.hard_triplet_loss(e, l, 1.0),
                 lambda e, l: TT.hard_triplet_loss(e, l, 1.0)),
        "contrastive": (JT.contrastive_aux_loss, TT.contrastive_aux_loss),
    }[kind]
    _check(*_value_grads(jfn, tfn, [0.05 * _emb((6, 2, 4), 4)], [labels]))


CODED = np.array([101, 102, 103, 104, 201, 202, 203, 204, 301, 305, 309,
                  399], np.int64)


def test_contrastive_aux_matches_jax():
    got = _value_grads(JT.contrastive_aux_loss, TT.contrastive_aux_loss,
                       [_emb((12, 3, 8), 5)], [CODED])
    assert got[2] > 0
    _check(*got)


def test_contrastive_aux_ignores_the_x100_code():
    emb = torch.from_numpy(_emb((12, 3, 8), 5))
    got = TT.contrastive_aux_loss(emb, torch.from_numpy(CODED))
    same = TT.contrastive_aux_loss(emb, torch.from_numpy(CODED // 100 * 100))
    assert float(got) == float(same) > 0


def _probs(b, n, seed):
    logits = _emb((b, n), seed) * 3.0
    e = np.exp(logits - logits.max(1, keepdims=True))
    return logits, (e / e.sum(1, keepdims=True)).astype(np.float32)


def _onehot(b, n, seed):
    lab = np.random.RandomState(seed).randint(0, n, b)
    return np.eye(n, dtype=np.float32)[lab]


@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (None, 0.0)])
def test_focal_matches_jax(from_logits, alpha, gamma):
    logits, probs = _probs(10, 7, 6)
    x = logits if from_logits else probs
    _check(*_value_grads(
        lambda p, y: JL.sigmoid_focal_crossentropy(p, y, alpha, gamma,
                                                   from_logits),
        lambda p, y: TL.sigmoid_focal_crossentropy(p, y, alpha, gamma,
                                                   from_logits),
        [x], [_onehot(10, 7, 7)]))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_categorical_crossentropy_matches_jax(smoothing):
    _, probs = _probs(10, 7, 8)
    probs[0, 0] = 0.0               # below the clip
    _check(*_value_grads(
        lambda p, y: JL.categorical_crossentropy(p, y, smoothing),
        lambda p, y: TL.categorical_crossentropy(p, y, smoothing),
        [probs], [_onehot(10, 7, 9)]))


PAIR_LABELS = {"mixed": np.array([1, 0, 0, 1, 0, 1, 1, 0], np.int32),
               "no negatives": np.ones(8, np.int32),
               "no positives": np.zeros(8, np.int32)}


@pytest.mark.parametrize("name", sorted(PAIR_LABELS))
@pytest.mark.parametrize("margin", [0.5, 30.0])
def test_verif_pair_loss_matches_jax(name, margin):
    got = _value_grads(
        lambda a, b, l: JL.verif_pair_loss(a, b, l, margin),
        lambda a, b, l: TL.verif_pair_loss(a, b, l, margin),
        [_emb((8, 16), 10), _emb((8, 16), 11)], [PAIR_LABELS[name]])
    _check(*got)


def test_verif_pair_loss_identical_embeddings_finite():
    """No residual at all: the 1e-12 under the sqrt keeps the gradient
    finite on both sides."""
    e = _emb((8, 16), 12)
    _check(*_value_grads(
        lambda a, b, l: JL.verif_pair_loss(a, b, l, 0.5),
        lambda a, b, l: TL.verif_pair_loss(a, b, l, 0.5),
        [e, e.copy()], [PAIR_LABELS["mixed"]]))


@pytest.mark.parametrize("delta", [0.5, 2.0])
def test_smooth_l1_pair_loss_matches_jax(delta):
    _check(*_value_grads(
        lambda a, b: JL.smooth_l1_pair_loss(a, b, delta),
        lambda a, b: TL.smooth_l1_pair_loss(a, b, delta),
        [_emb((8, 16), 13), _emb((8, 16), 14)]))


def test_make_triplet_loss_dispatches_the_kinds():
    emb, lab = torch.from_numpy(_emb((12, 3, 16), 1)), torch.from_numpy(PK)
    for kind, fn in (("semi_hard", TT.semi_hard_triplet_loss),
                     ("hard", TT.hard_triplet_loss)):
        assert float(TT.make_triplet_loss(kind, 0.3)(emb, lab)) == \
            float(fn(emb, lab, margin=0.3))
