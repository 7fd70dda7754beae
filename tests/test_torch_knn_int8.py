"""The port's int8 gallery (``ops/knn.py``: ``quantize_gallery``,
``pairwise_l2_int8``, ``int8_mm``; ``SignatureService(gallery_dtype=
"int8")``) held against the JAX package on the CPU.

Tolerances:
  * int8 codes and gallery scales: bitwise (the same per-row formula;
    division and round-half-to-even are exact operations in both).
  * |g|^2: rtol 1e-6 (float32 sums in another order than numpy's pairwise
    sum).
  * the probe scales and codes and the int32 cross term: bitwise against
    the JAX function as jit compiles it (XLA turns the probes' ``/ 127``
    into a multiply by float32(1/127); the port does the same).
  * d^2: |port - JAX| <= 1e-6 x (|p|^2 + |g|^2): only |p|^2 and |g|^2 are
    float32 sums in another order.
  * service neighbor distances: rtol 1e-4 / atol 1e-4, as the float32
    service's (tests/test_torch_eval.py); labels equal.
  * the JAX package's own int8 cases (tests/test_knn_int8.py) with its own
    limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from ugaitnet_tpu.eval.serving import SignatureService as JService
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import knn as JK

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.serving import SignatureService
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import knn as TK
from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict

torch.set_num_threads(1)

G2_RTOL = 1e-6
D2_REL = 1e-6
DIST_RTOL, DIST_ATOL = 1e-4, 1e-4
MODS = ("of", "gray")
DS_KW = dict(num_subjects=3, videos_per_subject=4, subseqs_per_video=2,
             num_cams=2, template_seed=0)


def _clustered_codes(n, d, c, rng, spread=0.05):
    """tests/test_knn_int8.py's draw: unit codes around c unit centers."""
    centers = rng.randn(c, d).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.randint(0, c, n)
    codes = centers[lab] + spread * rng.randn(n, d).astype(np.float32)
    codes /= np.linalg.norm(codes, axis=1, keepdims=True)
    return codes.astype(np.float32), lab


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_d2(probes, gallery):
    q, scale, g2 = TK.quantize_gallery(gallery)
    return TK.pairwise_l2_int8(_t(probes), q, scale, g2).numpy()


def _jax_d2(probes, gallery):
    q, scale, g2 = JK.quantize_gallery(gallery)
    return np.asarray(jax.jit(JK.pairwise_l2_int8)(
        jnp.asarray(probes), jnp.asarray(q), jnp.asarray(scale),
        jnp.asarray(g2)))


@pytest.mark.parametrize("shape,outlier", [((300, 992), False),
                                           ((64, 40), True)])
def test_quantize_gallery_matches_jax(shape, outlier):
    rng = np.random.RandomState(3)
    codes = rng.randn(*shape).astype(np.float32)
    if outlier:
        codes[5] *= 1000.0
        codes[7] = 0.0                       # an all-zero row
    q, scale, g2 = JK.quantize_gallery(codes)
    tq, tscale, tg2 = TK.quantize_gallery(codes)
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), q)
    assert np.array_equal(tscale.numpy(), scale)
    np.testing.assert_allclose(tg2.numpy(), g2, rtol=G2_RTOL)


def test_pairwise_l2_int8_matches_jax():
    rng = np.random.RandomState(0)
    gal, _ = _clustered_codes(300, 992, 16, rng)
    probes = rng.randn(40, 992).astype(np.float32)

    @jax.jit
    def jax_parts(p, q):
        # the probe half of JK.pairwise_l2_int8, as jit compiles it
        ps = jnp.maximum(jnp.max(jnp.abs(p), axis=1, keepdims=True),
                         1e-30) / 127.0
        qp = jnp.clip(jnp.round(p / ps), -127, 127).astype(jnp.int8)
        return ps[:, 0], qp, jax.lax.dot_general(
            qp, q, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)

    q, _, _ = JK.quantize_gallery(gal)
    ps, qp, dot = map(np.asarray, jax_parts(jnp.asarray(probes),
                                            jnp.asarray(q)))
    tqp, tps = TK.quantize_rows(_t(probes), xla_scale=True)
    assert np.array_equal(tps.numpy(), ps)
    assert np.array_equal(tqp.numpy(), qp)
    tdot = TK.int8_mm(tqp, _t(q))
    assert tdot.dtype == torch.int32 and np.array_equal(tdot.numpy(), dot)
    want, got = _jax_d2(probes, gal), _port_d2(probes, gal)
    scale = (probes ** 2).sum(1)[:, None] + (gal ** 2).sum(1)[None, :]
    assert np.all(np.abs(got - want) <= D2_REL * scale)


def test_int8_mm_exact_against_int64():
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 128, (5, 37)).astype(np.int8)      # K not % 8
    b = rng.randint(-127, 128, (11, 37)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    assert np.array_equal(TK.int8_mm(_t(a), _t(b)).numpy(), want)


# --- the JAX package's own cases (tests/test_knn_int8.py) -------------

def test_int8_distance_close_and_top1_parity():
    rng = np.random.RandomState(0)
    gal, glab = _clustered_codes(512, 128, 16, rng)
    probes, _ = _clustered_codes(64, 128, 16, rng)
    d2_ref = TK.pairwise_l2(_t(probes), _t(gal)).numpy()
    d2_i8 = _port_d2(probes, gal)
    assert np.max(np.abs(d2_ref - d2_i8)) < 5e-2
    i_ref, i_i8 = np.argmin(d2_ref, 1), np.argmin(d2_i8, 1)
    rows = np.arange(len(i_ref))
    gap = d2_ref[rows, i_i8] - d2_ref[rows, i_ref]
    assert np.all((i_ref == i_i8) | (gap < 1e-2))
    assert np.sum(glab[i_ref] != glab[i_i8]) <= 1


def test_quantize_outlier_row_isolated():
    rng = np.random.RandomState(2)
    gal = rng.randn(64, 32).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    gal[0] *= 1000.0
    q, _, _ = TK.quantize_gallery(gal)
    assert int(q[1:].abs().max()) == 127
    probes = rng.randn(8, 32).astype(np.float32)
    probes /= np.linalg.norm(probes, axis=1, keepdims=True)
    probes[0] *= 1000.0
    d2_ref = TK.pairwise_l2(_t(probes), _t(gal)).numpy()
    d2_i8 = _port_d2(probes, gal)
    assert np.max(np.abs(d2_i8[1:, 1:] - d2_ref[1:, 1:])) < 5e-2
    assert np.array_equal(np.argmin(d2_ref[1:], 1), np.argmin(d2_i8[1:], 1))


def test_quantize_empty_gallery():
    q, scale, g2 = TK.quantize_gallery(np.zeros((0, 16), np.float32))
    assert tuple(q.shape) == (0, 16) and q.dtype == torch.int8
    assert tuple(scale.shape) == (0,) and tuple(g2.shape) == (0,)


# --- the int8 SignatureService ----------------------------------------

def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


@pytest.fixture(scope="module")
def services():
    jcfg = graft._flagship_cfg(tiny=True)
    jmodel = JNet(jcfg)
    params = jax.jit(lambda key: init_params(jmodel, key, batch=2))(
        jax.random.PRNGKey(0))
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    jsvc = JService(jmodel, params, MODS, knn=3, buckets=(4, 8),
                    gallery_dtype="int8")
    jsvc.build_gallery(j_synth(seed=1, **DS_KW), batch_size=8)
    tsvc = SignatureService(tmodel, MODS, knn=3, buckets=(4, 8),
                            gallery_dtype="int8")
    tsvc.build_gallery(make_synthetic_dataset(seed=1, **DS_KW), batch_size=8)
    return jsvc, tsvc, make_synthetic_dataset(seed=2, **DS_KW)


def _raw(ds, idx):
    return {f"raw_{m}": ds.modalities[m].volumes[idx] for m in MODS}


def test_int8_service_identify_matches_jax(services):
    jsvc, tsvc, probe = services
    q, scale, g2 = tsvc._gallery_codes, tsvc._gallery_scale, tsvc._gallery_sq
    jq, jscale, jg2 = (np.asarray(a) for a in jsvc._gallery_codes)
    n = len(tsvc._host_codes)
    assert q.dtype == torch.int8 and q.shape == jq.shape
    # the port's codes differ from JAX's by float32 forward rounding, which
    # may move a code across a rounding boundary: compare on its own codes
    want = JK.quantize_gallery(tsvc._host_codes)
    assert np.array_equal(q[:n].numpy(), want[0])
    assert np.array_equal(scale[:n].numpy(), want[1])
    np.testing.assert_allclose(g2[:n].numpy(), want[2], rtol=G2_RTOL)
    # dead slots as the JAX service sets them
    assert not q[n:].any() and np.array_equal(scale[n:].numpy(), jscale[n:])
    assert np.array_equal(g2[n:].numpy(), jg2[n:])
    raw = _raw(probe, np.arange(11))                # 11 > 8: chunked
    raw["present_of"] = (np.arange(11) % 4 != 2).astype(np.float32)
    want, wd = jsvc.identify_raw(raw)
    got, gd = tsvc.identify_raw(raw)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(gd, wd, rtol=DIST_RTOL, atol=DIST_ATOL)
    codes = tsvc.encode_raw(raw)
    for use_avg in (True, False):
        wl, wdv = jsvc.identify_video(raw, use_avg=use_avg)
        tl, tdv = tsvc.identify_video(raw, use_avg=use_avg)
        assert tl == wl
        np.testing.assert_allclose(tdv, wdv, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert np.array_equal(tsvc.identify_codes(codes)[0],
                          jsvc.identify_codes(codes)[0])


def test_int8_service_enroll_remove_matches_jax(services):
    """Enroll in place (all three card buffers keep their storage), remove
    by tombstones, grow past capacity; labels equal the JAX service's."""
    jbase, tbase, probe = services
    jsvc = JService(jbase.model, jbase.params, MODS, knn=3, buckets=(4, 8),
                    gallery_dtype="int8")
    tsvc = SignatureService(tbase.model, MODS, knn=3, buckets=(4, 8),
                            gallery_dtype="int8")
    codes, labels = tbase._host_codes, tbase._host_labels
    for svc in (jsvc, tsvc):
        svc.set_gallery(codes[:12], labels[:12])    # capacity 16, 8 classes
    bufs = (tsvc._gallery_codes, tsvc._gallery_scale, tsvc._gallery_sq)
    ptrs = [b.data_ptr() for b in bufs]
    new = tbase.encode_raw(_raw(probe, np.arange(2)))
    raw = _raw(probe, np.arange(0, 24, 6))
    steps = [("enroll", (np.concatenate([new, new]),
                         np.array([900, 901, 900, 901]))),
             ("remove", (901,)), ("enroll", (codes[12:], labels[12:]))]
    for i, (op, args) in enumerate(steps):
        for svc in (jsvc, tsvc):
            getattr(svc, op)(*args)
        if i == 0:
            now = (tsvc._gallery_codes, tsvc._gallery_scale,
                   tsvc._gallery_sq)
            assert [b.data_ptr() for b in now] == ptrs
            q, s, _ = TK.quantize_gallery(np.concatenate([new, new]))
            assert torch.equal(tsvc._gallery_codes[12:16], q)
            assert torch.equal(tsvc._gallery_scale[12:16], s)
            assert np.array_equal(tsvc.identify_codes(new)[0], [900, 901])
        assert np.array_equal(tsvc.identify_raw(raw)[0],
                              jsvc.identify_raw(raw)[0])
        assert np.array_equal(tsvc.identify_codes(new)[0],
                              jsvc.identify_codes(new)[0])
    assert tsvc._gallery_size == jsvc._gallery_size == 24 + 4 - 2
    assert tsvc._capacity == 32
    assert 901 not in tsvc.identify_codes(new)[0]
