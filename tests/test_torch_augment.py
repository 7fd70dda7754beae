"""The port's training augmentation (ops/augment.py, data/pipeline.py with
``augmenting=True``) held against the JAX package on the CPU.

JAX key streams cannot be reproduced in torch, so the same TransformParams
and keep-masks go into both packages; the port's own draws are held by
their distributions and invariants.

Tolerances:
  * ops/augment.py functions: bitwise.  The port reproduces the two fused
    multiply-adds XLA:CPU contracts in the affine (the zoom coordinate
    ``z * (i - c) + c`` and the bilinear ``lo + w * (hi - lo)``) by one
    float64 rounding; without them the affine is ~2e-5 off (coordinates
    near 60 carry ulps of 4e-6 into the weights).
  * preprocess_batch(augmenting=True): max |port - JAX| <= 1e-6 x max |JAX|
    per output.  Inside the whole jitted preprocess XLA fuses the
    dequantize, standardization and the affine differently from the
    functions alone (measured: a few ulps, <= 1.2e-6 abs on values up to
    ~6, and bitwise for most configurations); flags and labels are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.core.config import DataConfig as JDataConfig
from ugaitnet_tpu.data import pipeline as JPipe
from ugaitnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from ugaitnet_tpu.ops import augment as JA

from ugaitnet_tpu_torch.core.config import DataConfig
from ugaitnet_tpu_torch.data import pipeline as TPipe
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.ops import augment as TA

torch.set_num_threads(1)

PREP_REL = 1e-6
MODS = ("of", "gray")


def _params(key, batch, photometric=True):
    jp = JA.random_transform_params(key, batch, photometric=photometric)
    tp = TA.TransformParams(*(torch.from_numpy(np.array(v)) for v in jp))
    return jp, tp


def _frames(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _case(name):
    """(JAX result, port result) of one ops/augment.py function on frames
    (B, T, H, W, C) with H != W, so swapped axes cannot pass."""
    x = _frames((5, 4, 20, 24, 2), seed=1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jp, tp = _params(jax.random.PRNGKey(2), 5)
    one = lambda p: jax.tree_util.tree_map(lambda a: a[1], p)  # noqa: E731
    if name.startswith("mirror"):
        is_of, neg = "of" in name, "neg" in name
        want = jax.vmap(lambda v: JA.mirror_volume(v, is_of, neg))(jx)
        return want, TA.mirror_volume(tx, is_of, neg)
    if name == "affine":
        want = jax.jit(jax.vmap(JA.affine_volume))(jx, jp.tx, jp.ty, jp.zx,
                                                   jp.zy)
        return want, TA.affine_volume(tx, tp.tx, tp.ty, tp.zx, tp.zy)
    if name == "affine_single":
        want = jax.jit(JA.affine_volume)(jx[1], jp.tx[1], jp.ty[1], jp.zx[1],
                                         jp.zy[1])
        return want, TA.affine_volume(tx[1], tp.tx[1], tp.ty[1], tp.zx[1],
                                      tp.zy[1])
    if name == "photometric":
        want = jax.jit(jax.vmap(JA.photometric_volume))(
            jx, jp.brightness, jp.channel_shift)
        return want, TA.photometric_volume(tx, tp.brightness,
                                           tp.channel_shift)
    if name.startswith("batch"):
        is_of = name == "batch_of"
        want = jax.jit(lambda v, p: JA.augment_batch(v, p, is_of))(jx, jp)
        return want, TA.augment_batch(tx, tp, is_of)
    assert name == "volume"
    want = jax.jit(lambda v, p: JA.augment_volume(v, p, False))(jx[1],
                                                                one(jp))
    return want, TA.augment_volume(tx[1], TA.TransformParams(
        *(v[1] for v in tp)), False)


@pytest.mark.parametrize("name", [
    "mirror_of", "mirror_gray", "mirror_of_neg", "mirror_gray_neg",
    "affine", "affine_single", "photometric", "batch_of", "batch_gray",
    "volume"])
def test_augment_functions_bitwise(name):
    want, got = _case(name)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want)), name


def test_mirror_keeps_the_plane_layout():
    """A frames view of planes goes through the augmentation and comes out
    as a view of (B, T, C, H, W) memory again: no layout copy."""
    x = torch.randn(2, 3, 2, 8, 10).movedim(2, -1)      # frames view
    out = TA.mirror_volume(x, is_of=True)
    assert out.movedim(-1, 2).is_contiguous()
    assert torch.equal(out[..., 0], -torch.flip(x[..., 0], dims=(-1,)))
    assert torch.equal(out[..., 1], torch.flip(x[..., 1], dims=(-1,)))


def _raw(b, seed, normalize, hw=(20, 24)):
    rng = np.random.RandomState(seed)
    raw = {
        "raw_of": rng.randint(-3000, 3000, (b, 50) + hw).astype(np.int16),
        "raw_gray": rng.randint(0, 255, (b, 25) + hw).astype(np.uint8),
        "present_of": (rng.rand(b) > 0.3).astype(np.float32),
        "present_gray": np.ones((b,), np.float32),
        "labels": np.repeat(np.arange(b // 2), 2).astype(np.int32),
    }
    if normalize:
        raw["source"] = rng.randint(0, 2, (b,)).astype(np.int32)
        for m, n in (("of", 50), ("gray", 25)):
            raw[f"norm_mean_{m}"] = rng.randn(2, n).astype(np.float32) * 0.1
            raw[f"norm_std_{m}"] = (rng.rand(2, n) + 0.5).astype(np.float32)
    return raw


@pytest.mark.parametrize("expand", [1, 3])
@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_augmenting_matches(expand, normalize):
    b, cfg = 6, JDataConfig()
    raw = _raw(b, 3 + expand, normalize)
    key = jax.random.PRNGKey(5)
    jvols, jflags, jlab = JPipe.preprocess_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, key, MODS, (2, 1),
        (100.0, 1.0), 2, expand, True, cfg, normalize=normalize)
    # the per-modality params and masks the JAX call drew from its key
    k_aug, k_drop = jax.random.split(key, 2)
    params = [TA.TransformParams(*(np.array(v) for v in JA.random_transform_params(
        jax.random.fold_in(k_aug, mi), b, shift_choices=cfg.shift_range,
        zoom_range=cfg.zoom_range, brightness_range=cfg.brightness_range,
        channel_shift_range=cfg.channel_shift_range,
        photometric=(m != "of")))) for mi, m in enumerate(MODS)]
    clip = params[0].clip_of
    assert clip.any() and not clip.all()    # both coin sides are exercised
    masks = np.asarray(JPipe._dropout_masks(k_drop, b, 2, expand))
    tvols, tflags, tlab = TPipe.preprocess_batch(
        raw, MODS, (2, 1), (100.0, 1.0), 2, expand, True, DataConfig(),
        normalize=normalize, masks=masks, params=params, device="cpu")
    for jv, tv in zip(jvols, tvols):
        want = np.asarray(jv)
        assert tuple(tv.shape) == want.shape
        err = np.abs(tv.numpy() - want).max()
        assert err <= PREP_REL * np.abs(want).max(), err
    for jf, tf in zip(jflags, tflags):
        assert np.array_equal(tf.numpy(), np.asarray(jf))
    assert np.array_equal(tlab.numpy(), np.asarray(jlab))


def test_expand_copies_share_the_augmentation():
    """Augmentation runs before the expansion: every copy that keeps a
    modality holds the same augmented volume, and a dropped copy holds
    exactly the noise fill."""
    b, e = 4, 3
    raw = _raw(b, 0, False)
    raw["present_of"][:] = 1.0
    gen = torch.Generator().manual_seed(1)
    vols, flags, _ = TPipe.preprocess_batch(
        raw, MODS, (2, 1), (100.0, 1.0), 2, e, True, DataConfig(),
        generator=gen, device="cpu")
    noise = torch.tensor(DataConfig().noise)
    for v, f in zip(vols, flags):
        v = v.reshape(b, e, *v.shape[1:])
        f = f.reshape(b, e)
        for i in range(b):
            for c in range(1, e):
                if f[i, c] > 0:
                    assert torch.equal(v[i, c], v[i, 0])
                else:
                    assert bool((v[i, c] == noise).all())
    # the same generator seed gives the same batch
    again = TPipe.preprocess_batch(
        raw, MODS, (2, 1), (100.0, 1.0), 2, e, True, DataConfig(),
        generator=torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(a, c) for a, c in zip(vols, again[0]))


@pytest.mark.parametrize("nmods,expand", [(3, 2), (3, 3), (4, 3), (4, 4)])
def test_dropout_masks_three_plus_modalities(nmods, expand):
    batch = 400
    gen = torch.Generator().manual_seed(nmods * 10 + expand)
    got = TPipe._dropout_masks(gen, batch, nmods, expand,
                               torch.device("cpu")).numpy()
    want = np.asarray(JPipe._dropout_masks(jax.random.PRNGKey(0), batch,
                                           nmods, expand))
    assert got.shape == want.shape == (batch, expand, nmods)
    assert np.all(got[:, 0] == 1.0)
    assert set(np.unique(got)) <= {0.0, 1.0}
    # odd rows keep exactly modality (i + ex) % nmods: deterministic, so
    # equal to the JAX package's
    assert np.array_equal(got[1::2], want[1::2])
    rows = np.arange(1, batch, 2)
    for ex in range(expand - 1):
        assert np.all(got[rows, ex + 1, (rows + ex) % nmods] == 1.0)
        assert np.all(got[rows, ex + 1].sum(1) == 1.0)
        # even rows disable between 1 and min(ex + 1, nmods - 1) modalities
        # (draws with replacement may repeat), with the count drawn from
        # [1, nmods) when expand is 2
        ndis = nmods - got[0::2, ex + 1].sum(1)
        top = nmods - 1 if expand == 2 else min(ex + 1, nmods - 1)
        assert ndis.min() >= 1 and ndis.max() <= top
        assert ndis.max() == top
        # every modality is dropped by some even row
        assert np.all((got[0::2, ex + 1] == 0).any(0))


def test_preprocess_three_modalities_draws_masks():
    """The 3+-modality branch runs inside preprocess_batch (it raised
    before): odd rows' copies keep one modality each."""
    b, e = 4, 3
    rng = np.random.RandomState(0)
    raw = {"raw_gray": rng.randint(0, 255, (b, 25, 8, 8)).astype(np.uint8),
           "raw_depth": rng.randint(0, 255, (b, 25, 8, 8)).astype(np.uint8),
           "raw_silhouette": rng.randint(0, 2, (b, 25, 8, 8)
                                         ).astype(np.uint8),
           "labels": np.arange(b).astype(np.int32)}
    mods = ("gray", "depth", "silhouette")
    for m in mods:
        raw[f"present_{m}"] = np.ones(b, np.float32)
    _, flags, labels = TPipe.preprocess_batch(
        raw, mods, (1, 1, 1), (1.0, 1.0, 1.0), 2, e, True, DataConfig(),
        generator=torch.Generator().manual_seed(0), device="cpu")
    f = torch.stack(flags, -1).reshape(b, e, 3).numpy()
    assert np.all(f[:, 0] == 1.0)
    assert np.all(f[1::2, 1:].sum(-1) == 1.0)
    assert np.array_equal(labels.numpy(), np.repeat(np.arange(b), e))


def test_random_transform_params_distribution():
    """The port's draws against the JAX package's, by their distributions
    (n = 40,000 each; the frequency limits are > 5 sigma)."""
    n = 40000
    cfg = DataConfig()
    gen = torch.Generator().manual_seed(0)
    tp = TA.random_transform_params(gen, n, device="cpu")
    jp = JA.random_transform_params(jax.random.PRNGKey(0), n)
    t = {k: v.numpy().astype(np.float64) for k, v in tp._asdict().items()}
    j = {k: np.asarray(v).astype(np.float64) for k, v in jp._asdict().items()}
    assert tp.apply.dtype == tp.flip.dtype == tp.clip_of.dtype == torch.bool
    assert tp.tx.dtype == tp.zx.dtype == torch.float32
    assert not np.any(t["flip"] > t["apply"])            # flip => apply
    for name, p in (("apply", 0.75), ("clip_of", 0.5)):
        assert abs(t[name].mean() - p) < 0.012
        assert abs(t[name].mean() - j[name].mean()) < 0.015
    assert abs(t["flip"].sum() / t["apply"].sum() - 0.5) < 0.015
    for name in ("tx", "ty"):
        assert set(np.unique(t[name])) == set(cfg.shift_range)
        counts = np.array([np.mean(t[name] == s) for s in cfg.shift_range])
        assert np.all(np.abs(counts - 0.2) < 0.012)
    for name, (lo, hi) in (("zx", (0.96, 1.04)), ("zy", (0.96, 1.04)),
                           ("brightness", cfg.brightness_range),
                           ("channel_shift", (-0.025, 0.025))):
        assert t[name].min() >= lo - 1e-6 and t[name].max() <= hi + 1e-6
        # uniform: mean and std of U(lo, hi) within 1 % of the range
        width = hi - lo
        assert abs(t[name].mean() - (lo + hi) / 2) < 0.01 * width
        assert abs(t[name].std() - width / np.sqrt(12)) < 0.01 * width
        assert abs(t[name].mean() - j[name].mean()) < 0.01 * width
    of = TA.random_transform_params(gen, 100, photometric=False,
                                    device="cpu")
    assert torch.equal(of.brightness, torch.ones(100))
    assert torch.equal(of.channel_shift, torch.zeros(100))


def test_host_gather_and_norm_stats_match(tmp_path):
    """gather_host_batch, GaitPipeline.load (augment off) and the norm-stats
    helpers against the JAX package on the same synthetic dataset."""
    jds = j_synth(num_subjects=3, videos_per_subject=2, subseqs_per_video=2,
                  seed=4)
    tds = make_synthetic_dataset(num_subjects=3, videos_per_subject=2,
                                 subseqs_per_video=2, seed=4)
    idx = np.array([5, 0, 11, 3])
    want = JPipe.gather_host_batch(jds, idx, MODS, jds.label_map())
    got = TPipe.gather_host_batch(tds, idx, MODS, tds.label_map())
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    stats = {m: TPipe.compute_normalization_stats(tds, m) for m in MODS}
    for m in MODS:
        jm = JPipe.compute_normalization_stats(jds, m)
        assert all(np.array_equal(a, c) for a, c in zip(stats[m], jm))
    TPipe.save_norm_stats(str(tmp_path), stats)
    back = JPipe.load_norm_stats(str(tmp_path), MODS)   # one file format
    assert all(np.array_equal(back[m][i], stats[m][i])
               for m in MODS for i in (0, 1))
    assert TPipe.load_norm_stats(str(tmp_path / "none"), MODS) is None
    with pytest.raises(ValueError, match="lacks stats"):
        TPipe.load_norm_stats(str(tmp_path), MODS + ("depth",))

    cfg = DataConfig(expand_level=1, augment=False)
    jpipe = JPipe.GaitPipeline(jds, JDataConfig(expand_level=1,
                                                augment=False), MODS,
                               norm_stats=stats)
    tpipe = TPipe.GaitPipeline(tds, cfg, MODS, norm_stats=stats,
                               device="cpu")
    jv, jf, _ = jpipe.load(idx, jax.random.PRNGKey(0))
    tv, tf, _ = tpipe.load(idx)
    for a, c in zip(jv + jf, tv + tf):
        assert np.array_equal(c.numpy(), np.asarray(a))
