"""The port's serving path (data copies, eval/encode.py, ops/knn.py,
eval/protocol.py, eval/serving.py) held against the JAX package on the CPU,
at the tiny flagship (channels (8, 8, 16), part_dim 16) with the flax
params carried over by utils/weights.py.

Tolerances:
  * numpy copies (schema, synthetic, sampler, metrics, verification):
    bitwise, the same code on the same inputs.
  * codes: rtol 1e-4 / atol 1e-5, the forward tolerance of
    tests/test_torch_port.py (float32 convolutions summed in another order).
  * neighbor distances: rtol 1e-4 / atol 1e-4.  Served codes have
    |code|^2 = 62 (per-part L2), so float32 cancellation in
    |p|^2 + |g|^2 - 2 p.g alone moves d^2 by ~1.5e-5, i.e. d by ~1e-4 near
    0.1 (measured 6.4e-5 at d = 0.54); where distances reach 0 the squared
    ones are compared, atol 1e-4.
  * kNN labels, Rank-1 figures, confusions and service labels: equal.  On
    the same codes the two packages make the same decisions bit for bit
    (ties included); on their own codes the synthetic identities are far
    enough apart that 1e-6 code differences flip no neighbor here.
  * top-k order: the port's ``nearest`` returns exactly the indices of
    ``jax.lax.top_k(-d2)``, the lower index first among equal distances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import EvalConfig as JEvalConfig
from ugaitnet_tpu.data import sampler as JS
from ugaitnet_tpu.data.schema import GaitDataset as JGaitDataset
from ugaitnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from ugaitnet_tpu.eval import protocol as JP
from ugaitnet_tpu.eval import verification as JV
from ugaitnet_tpu.eval.encode import encode_dataset as j_encode
from ugaitnet_tpu.eval.serving import SignatureService as JService
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import knn as JK
from ugaitnet_tpu.ops import metrics as JM

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data import sampler as TS
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval import protocol as TP
from ugaitnet_tpu_torch.eval import verification as TV
from ugaitnet_tpu_torch.eval.encode import encode_dataset
from ugaitnet_tpu_torch.eval.serving import SignatureService
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import knn as TK
from ugaitnet_tpu_torch.ops import metrics as TM
from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
DIST_RTOL, DIST_ATOL = 1e-4, 1e-4
MODS = ("of", "gray")
N = 24           # clips per set
BS = 10          # 24 clips -> batches of 10, 10 and a padded tail of 4
CAMS = (0, 1)
DS_KW = dict(num_subjects=3, videos_per_subject=4, subseqs_per_video=2,
             num_cams=2, template_seed=0)


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg = graft._flagship_cfg(tiny=True)
    jmodel = JNet(jcfg)
    # one compiled init: flax's eager init runs op by op (~15 s on the CPU)
    params = jax.jit(lambda key: init_params(jmodel, key, batch=2))(
        jax.random.PRNGKey(0))
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def data():
    return {name: (j_synth(seed=seed, **DS_KW),
                   make_synthetic_dataset(seed=seed, **DS_KW))
            for name, seed in (("gallery", 1), ("probe", 2))}


@pytest.fixture(scope="module")
def encoded(tiny, data):
    """JAX and port EncodedSets: mirrored gallery, plain probe."""
    jmodel, params, tmodel = tiny
    cfg = JEvalConfig(batch_size=BS)
    tcfg = tconfig.EvalConfig(batch_size=BS)
    out = {}
    for name, mirror in (("gallery", True), ("probe", False)):
        jds, tds = data[name]
        out[name] = (JP.encode_set(jmodel, params, jds, MODS, cfg,
                                   mirror=mirror),
                     TP.encode_set(tmodel, tds, MODS, tcfg, mirror=mirror))
    return out


# --- numpy copies ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_subjects=2, num_cams=11, videos_per_subject=22,
         subseqs_per_video=1, seed=3, template_seed=0,
         modalities=("of", "gray", "depth"))])
def test_synthetic_datasets_bitwise(kw):
    want, got = j_synth(**kw), make_synthetic_dataset(**kw)
    for col in ("labels", "video_ids", "gaits", "cams", "set_ids"):
        a, b = getattr(want, col), getattr(got, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    assert (got.name, got.ntype) == (want.name, want.ntype)
    assert list(got.modalities) == list(want.modalities)
    for m, s in want.modalities.items():
        t = got.modalities[m]
        assert t.volumes.dtype == s.volumes.dtype
        assert np.array_equal(t.volumes, s.volumes), m
        assert np.array_equal(t.present, s.present)
        assert t.compress_factor == s.compress_factor


def test_schema_save_load_round_trip(tmp_path):
    ds = make_synthetic_dataset(num_subjects=2, videos_per_subject=2,
                                subseqs_per_video=1, seed=5)
    ds.dataset_source = np.array([0, 1, 1, 0], np.int32)
    ds.save(str(tmp_path))
    for back in (GaitDataset.load(str(tmp_path)),
                 JGaitDataset.load(str(tmp_path))):    # one file format
        assert np.array_equal(back.labels, ds.labels)
        assert np.array_equal(back.dataset_source, ds.dataset_source)
        for m in MODS:
            assert np.array_equal(back.modalities[m].volumes,
                                  ds.modalities[m].volumes)
    assert ds.label_map() == {1: 0, 2: 1}
    assert ds.modalities["of"].mean_volume().shape == (50, 60, 60)


@pytest.mark.parametrize("groups", [None, (0, 1, 0)])
def test_samplers_match(groups):
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 7, 120)
    gaits = rng.randint(0, 3, 120)
    kw = dict(batch_size=16, repetition=2, seed=3, gait_groups=groups)
    want = JS.BalancedGaitSampler(labels, gaits, **kw)
    got = TS.BalancedGaitSampler(labels, gaits, **kw)
    assert len(got) == len(want)
    for _ in range(2):
        for a, b in zip(list(want.epoch()), list(got.epoch())):
            assert np.array_equal(a, b)
    assert [list(b) for b in TS.SequentialSampler(10, 4).epoch()] == \
        [list(b) for b in JS.SequentialSampler(10, 4).epoch()]
    vids = rng.randint(0, 30, 200)
    for a, b in zip(JS.split_train_val_by_video(vids, 0.2, seed=1),
                    TS.split_train_val_by_video(vids, 0.2, seed=1)):
        assert np.array_equal(a, b)


def test_metrics_and_verification_match():
    rng = np.random.RandomState(1)
    gt = rng.randint(0, 2, 200)
    dist = rng.rand(200) + 0.3 * gt
    assert TM.eer_verif_dist(gt, dist) == JM.eer_verif_dist(gt, dist)
    pred, lab, vid = (rng.randint(0, 5, 90), rng.randint(0, 5, 90),
                      rng.randint(0, 12, 90))
    assert TM.rank1_accuracy(pred, lab) == JM.rank1_accuracy(pred, lab)
    for a, b in zip(TM.video_majority_vote(pred, lab, vid),
                    JM.video_majority_vote(pred, lab, vid)):
        assert np.array_equal(a, b)
    assert np.array_equal(TM.confusion_matrix(pred, lab, 5),
                          JM.confusion_matrix(pred, lab, 5))
    codes = rng.randn(40, 8).astype(np.float32)
    labels = rng.randint(0, 6, 40)
    assert TV.verification_eer(codes, labels) == \
        JV.verification_eer(codes, labels)


# --- encode ------------------------------------------------------------

@pytest.mark.parametrize("name", ["gallery", "probe"])
def test_encode_dataset_matches(encoded, name):
    """Mirrored gallery and plain probe, each with a padded tail batch."""
    jes, tes = encoded[name]
    n = 2 * N if name == "gallery" else N
    assert tes.codes.shape == jes.codes.shape == (n, 62 * 16)
    np.testing.assert_allclose(tes.codes, jes.codes, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for col in ("labels", "video_ids", "cams"):
        assert np.array_equal(getattr(tes, col), getattr(jes, col))


def test_encode_tail_batch_padding_is_exact(tiny, data):
    """The padded tail batch gives the codes of an unpadded forward of its
    rows (padded rows carry use_flags == 0, so under l2_mode="reference"
    they add nothing to the batch-axis norms); duplicate-row padding with
    the flags on would not."""
    _, _, tmodel = tiny
    _, tds = data["probe"]
    assert tmodel.config.l2_mode == "reference"
    codes, _, _, _ = encode_dataset(tmodel, tds, MODS, batch_size=BS)
    tail = np.arange(20, N)
    want, _, _, _ = encode_dataset(tmodel, tds, MODS, batch_size=len(tail),
                                   indices=tail)
    np.testing.assert_allclose(codes[20:], want, rtol=1e-6, atol=1e-7)
    dup = np.concatenate([tail, np.full(BS - len(tail), N - 1)])
    skewed, _, _, _ = encode_dataset(tmodel, tds, MODS, batch_size=BS,
                                     indices=dup)
    assert np.abs(skewed[:len(tail)] - want).max() > 1e-3


def test_encode_empty_selection_raises(tiny, data):
    _, _, tmodel = tiny
    with pytest.raises(ValueError, match="no samples"):
        encode_dataset(tmodel, data["probe"][1], MODS,
                       indices=np.array([], np.int64))


# --- kNN ---------------------------------------------------------------

def test_knn_tie_order_matches_jax_top_k():
    """Duplicate gallery rows under different labels: the k-th neighbor is
    picked among exact ties, lower gallery index first, in both packages."""
    rng = np.random.RandomState(0)
    base = rng.randn(10, 16).astype(np.float32)
    gallery = np.concatenate([base, base, base[:4]])        # 24 rows
    labels = np.arange(24) % 7 + 100
    probes = np.concatenate([base[[1, 3, 5]], rng.randn(7, 16)
                             .astype(np.float32)])
    for k in (1, 2, 3, 5):
        want = JK.knn_predict(probes, gallery, labels, k=k)
        got = TK.knn_predict(probes, gallery, labels, k=k, batch=4,
                             device="cpu")
        assert np.array_equal(got, want), k
        d2 = JK.pairwise_l2(jnp.asarray(probes), jnp.asarray(gallery))
        _, jidx = jax.lax.top_k(-d2, k)
        vals, tidx = TK.nearest(torch.from_numpy(np.array(d2)), k)
        assert np.array_equal(tidx.numpy(), np.asarray(jidx)), k
        assert np.array_equal(vals.numpy(), np.take_along_axis(
            np.asarray(d2), np.asarray(jidx), 1))
    # a probe equal to base[1] has rows 1, 11 and 21 at distance 0
    assert list(tidx[0, :3].numpy()) == [1, 11, 21]
    wp, wd = JK.knn_predict_with_distances(probes, gallery, labels, k=3)
    tp, td = TK.knn_predict_with_distances(probes, gallery, labels, k=3,
                                           device="cpu")
    assert np.array_equal(tp, wp)
    np.testing.assert_allclose(td ** 2, wd ** 2, rtol=1e-5, atol=DIST_ATOL)


def test_vote_ties_go_to_the_lowest_class():
    neighbors = torch.tensor([[2, 1, 0], [3, 3, 1], [1, 3, 3], [2, 0, 2],
                              [1, 2, 2]])
    assert TK.vote(neighbors, 4).tolist() == [0, 3, 3, 2, 2]
    # torch.argmax takes the first of equal maxima, as jnp.argmax does
    counts = torch.tensor([[1.0, 2.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    assert torch.argmax(counts, dim=1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(counts.numpy()), 1)).tolist()


# --- protocols ---------------------------------------------------------

@pytest.mark.parametrize("codes_from", ["jax", "port"])
def test_eval_camera_pairs_matches(encoded, codes_from):
    (jg, tg), (jp, tp) = encoded["gallery"], encoded["probe"]
    if codes_from == "jax":
        tg, tp = jg, jp
    for cam in CAMS:
        jconf, tconf = {}, {}
        want = JP.eval_camera_pairs(jg, jp, cam, knn=3, cameras=CAMS,
                                    confusions=jconf)
        got = TP.eval_camera_pairs(tg, tp, cam, knn=3, cameras=CAMS,
                                   confusions=tconf, device="cpu")
        assert got == want
        assert set(tconf) == set(jconf)
        for key in jconf:
            assert np.array_equal(tconf[key], jconf[key]), key


@pytest.mark.parametrize("use_avg", [True, False])
def test_eval_openset_matches(encoded, use_avg):
    (jg, tg), (jp, tp) = encoded["gallery"], encoded["probe"]
    jm = JP._merge_codes_per_video(jg, use_avg)
    tm = TP._merge_codes_per_video(tg, use_avg)
    np.testing.assert_allclose(tm[0], jm[0], rtol=FWD_RTOL, atol=FWD_ATOL)
    assert np.array_equal(tm[1], jm[1])
    jconf, tconf = {}, {}
    want = JP.eval_openset(jg, jp, knn=3, use_avg=use_avg, confusions=jconf)
    got = TP.eval_openset(tg, tp, knn=3, use_avg=use_avg, confusions=tconf,
                          device="cpu")
    assert got == want
    assert 0.0 < got["rank1_subseq"] <= 1.0
    for key in jconf:
        assert np.array_equal(tconf[key], jconf[key]), key
    # the same merged gallery passed in gives the same figures
    assert TP.eval_openset(tg, tp, knn=3, use_avg=use_avg, merged_gallery=tm,
                           device="cpu") == got


def test_eval_all_combos_matches(tiny):
    jmodel, params, tmodel = tiny
    kw = dict(DS_KW, videos_per_subject=2, subseqs_per_video=1)  # 6 clips
    jg, tg = j_synth(seed=1, **kw), make_synthetic_dataset(seed=1, **kw)
    jp, tp = j_synth(seed=2, **kw), make_synthetic_dataset(seed=2, **kw)
    want = JP.eval_all_combos(jmodel, params, jg, jp, MODS,
                              JEvalConfig(batch_size=6), combo_gallery=True,
                              use_avg=False)
    memo = {}
    got = TP.eval_all_combos(tmodel, tg, tp, MODS,
                             tconfig.EvalConfig(batch_size=6),
                             combo_gallery=True, use_avg=False,
                             gallery_memo=memo)
    assert got == want
    assert set(got) == {"of", "gray", "of+gray"}
    assert len(memo["gallery"].codes) == 3 * 6
    assert memo["key"] == (tg.name, True, False, 3, 6)
    assert TP.modality_combos(3) == JP.modality_combos(3)


def test_encoded_set_cache_is_the_jax_format(tiny, tmp_path):
    _, _, tmodel = tiny
    tds = make_synthetic_dataset(num_subjects=2, videos_per_subject=1,
                                 subseqs_per_video=2)
    path = str(tmp_path / "codes.npz")
    cfg = tconfig.EvalConfig(batch_size=4)
    es = TP.encode_set(tmodel, tds, MODS, cfg, cache_path=path)
    key = "typecode=3;mirror=0;bs=4;norm=0;use_mods=all"
    back = JP.EncodedSet.load(path, config_key=key)
    assert np.array_equal(back.codes, es.codes)
    again = TP.encode_set(tmodel, tds, MODS, cfg, cache_path=path)
    assert np.array_equal(again.codes, es.codes)
    with pytest.raises(ValueError, match="cached codes"):
        TP.encode_set(tmodel, tds, MODS, dataclasses.replace(cfg,
                                                             batch_size=2),
                      cache_path=path)


# --- serving -----------------------------------------------------------

@pytest.fixture(scope="module")
def services(tiny, data):
    jmodel, params, tmodel = tiny
    jds, tds = data["gallery"]
    jsvc = JService(jmodel, params, MODS, knn=3, buckets=(4, 8))
    jsvc.build_gallery(jds, batch_size=8)
    tsvc = SignatureService(tmodel, MODS, knn=3, buckets=(4, 8))
    tsvc.build_gallery(tds, batch_size=8)
    return jsvc, tsvc


def _raw(ds, idx):
    return {f"raw_{m}": ds.modalities[m].volumes[idx] for m in MODS}


def test_service_identify_raw_matches(services, data):
    jsvc, tsvc = services
    np.testing.assert_allclose(tsvc._host_codes, jsvc._host_codes,
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    _, probe = data["probe"]
    raw = _raw(probe, np.arange(11))            # 11 > 8: chunked
    raw["present_of"] = (np.arange(11) % 4 != 2).astype(np.float32)
    want, wd = jsvc.identify_raw(raw)
    got, gd = tsvc.identify_raw(raw)
    assert np.array_equal(got, want)
    assert gd.shape == (11, 3)
    np.testing.assert_allclose(gd, wd, rtol=DIST_RTOL, atol=DIST_ATOL)
    # gallery members find themselves at distance ~0
    _, gallery = data["gallery"]
    labels, dists = tsvc.identify_raw(_raw(gallery, np.arange(5)))
    assert np.array_equal(labels, gallery.labels[:5])
    assert np.all(dists[:, 0] ** 2 < DIST_ATOL)


def test_service_serves_per_sample_l2_with_shared_weights(services, tiny):
    _, tsvc = services
    _, _, tmodel = tiny
    assert tmodel.config.l2_mode == "reference"
    assert tsvc.model.config.l2_mode == "feature"
    assert tsvc.model.branches is tmodel.branches     # the same weights
    assert tsvc.device == torch.device("cpu")


@pytest.mark.parametrize("use_avg", [True, False])
def test_service_identify_video_matches(services, data, use_avg):
    jsvc, tsvc = services
    _, probe = data["probe"]
    for start in (0, 8, 18):
        clips = _raw(probe, np.arange(start, start + 3))
        wl, wd = jsvc.identify_video(clips, use_avg=use_avg)
        tl, td = tsvc.identify_video(clips, use_avg=use_avg)
        assert tl == wl
        np.testing.assert_allclose(td, wd, rtol=DIST_RTOL, atol=DIST_ATOL)


def test_service_enroll_remove_matches(services, data):
    """Enroll in place (the card's buffer keeps its storage), remove by
    tombstones, and grow past capacity; labels equal the JAX service's
    after every step."""
    jbase, tbase = services
    _, probe = data["probe"]
    jsvc = JService(jbase.model, jbase.params, MODS, knn=3, buckets=(4, 8))
    tsvc = SignatureService(tbase.model, MODS, knn=3, buckets=(4, 8))
    codes = tbase._host_codes
    labels = tbase._host_labels
    for svc in (jsvc, tsvc):
        svc.set_gallery(codes[:12], labels[:12])  # capacity 16, 8 classes
    ptr, cap = tsvc._gallery_codes.data_ptr(), tsvc._capacity
    new = tbase.encode_raw(_raw(probe, np.arange(2)))
    raw = _raw(probe, np.arange(0, N, 4))
    # each new code twice: (900, 900, 901, 901)
    steps = [("enroll", (np.concatenate([new, new]),
                         np.array([900, 901, 900, 901]))),
             ("remove", (901,)), ("enroll", (codes[12:], labels[12:]))]
    for i, (op, args) in enumerate(steps):
        for svc in (jsvc, tsvc):
            getattr(svc, op)(*args)
        if i == 0:     # written in place into the same device buffer
            assert tsvc._gallery_codes.data_ptr() == ptr
            assert tsvc._capacity == cap
            assert torch.equal(tsvc._gallery_codes[12:16],
                               torch.from_numpy(np.concatenate([new, new])))
            # each enrolled pair answers its own self-query (2 of 3 votes)
            assert np.array_equal(tsvc.identify_codes(new)[0], [900, 901])
        assert np.array_equal(tsvc.identify_raw(raw)[0],
                              jsvc.identify_raw(raw)[0])
        assert np.array_equal(tsvc.identify_codes(new)[0],
                              jsvc.identify_codes(new)[0])
    assert tsvc._gallery_size == jsvc._gallery_size == N + 4 - 2
    assert tsvc._capacity == 32           # grew, compacting tombstones
    assert tsvc.identify_codes(new)[0][0] == 900
    assert 901 not in tsvc.identify_codes(new)[0]
    with pytest.raises(ValueError, match="entire gallery"):
        tsvc.remove(np.unique(tsvc._host_labels))


def test_service_verify_matches(services, data):
    jsvc, tsvc = services
    _, probe = data["probe"]
    a, b = np.arange(0, 8), np.r_[np.arange(1, 5), np.arange(16, 20)]
    wd, _ = jsvc.verify_raw(_raw(probe, a), _raw(probe, b))
    same = (probe.labels[a] == probe.labels[b]).astype(np.int64)
    eer, thr = SignatureService.calibrate_verification(
        tsvc.encode_raw(_raw(probe, a)), tsvc.encode_raw(_raw(probe, b)),
        same)
    assert (eer, thr) == pytest.approx(JService.calibrate_verification(
        jsvc.encode_raw(_raw(probe, a)), jsvc.encode_raw(_raw(probe, b)),
        same), rel=1e-5)
    td, tdec = tsvc.verify_raw(_raw(probe, a), _raw(probe, b), threshold=thr)
    np.testing.assert_allclose(td, wd, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert np.array_equal(tdec, td <= thr)
    with pytest.raises(ValueError, match="paired"):
        tsvc.verify_codes(np.zeros((2, 4)), np.zeros((3, 4)))


def test_service_norm_stats_match(tiny, data):
    """Two dataset sources of standardization: encode and identify equal
    the JAX service's, and a feed without "source" is refused."""
    jmodel, params, tmodel = tiny
    _, probe = data["probe"]
    rng = np.random.RandomState(2)
    stats = {m: ((rng.randn(2, n) * 0.05).astype(np.float32),
                 (rng.rand(2, n) + 0.5).astype(np.float32))
             for m, n in (("of", 50), ("gray", 25))}
    jsvc = JService(jmodel, params, MODS, knn=1, buckets=(4,),
                    norm_stats=stats)
    tsvc = SignatureService(tmodel, MODS, knn=1, buckets=(4,),
                            norm_stats=stats)
    raw = _raw(probe, np.arange(4))
    raw["source"] = np.array([0, 1, 1, 0], np.int32)
    codes = tsvc.encode_raw(raw)
    np.testing.assert_allclose(codes, jsvc.encode_raw(raw), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for svc in (jsvc, tsvc):
        svc.set_gallery(codes, np.array([7, 8, 9, 10]))
    tsvc.warmup()
    assert np.array_equal(tsvc.identify_raw(raw)[0],
                          jsvc.identify_raw(raw)[0])
    with pytest.raises(ValueError, match="source"):
        tsvc.encode_raw({k: v for k, v in raw.items() if k != "source"})
