"""The port's data tools against the JAX package's, on the same inputs:
``data/partitions.py`` for every dataset and split, ``data/convert.py``
(``combine_datasets`` with its ``dataset_source`` column and every guard,
``import_reference_dir`` on reference-layout h5 files), the TFRecord reader
on files TensorFlow wrote, ``data/dataset_info.py``, the builders
(``extract_windows``, ``build_dataset``, ``merge_modalities``) with cv2 and
with its numpy routes, and ``cli.build_data`` in every source mode.  Packed
sets must be bitwise equal."""

import os
import pickle
import struct
import sys

import numpy as np
import pytest
import torch

from ugaitnet_tpu.cli import build_data as j_build_data
from ugaitnet_tpu.data import builders as j_builders
from ugaitnet_tpu.data import convert as j_convert
from ugaitnet_tpu.data import dataset_info as j_info
from ugaitnet_tpu.data import partitions as j_partitions
from ugaitnet_tpu.data import tfrecord as j_tfrecord
from ugaitnet_tpu.data.schema import GaitDataset as JGaitDataset
from ugaitnet_tpu.data.synthetic import \
    make_synthetic_dataset as j_make_synthetic

from ugaitnet_tpu_torch.cli import build_data
from ugaitnet_tpu_torch.data import (builders, convert, dataset_info,
                                     partitions, tfrecord)
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset

sys.path.insert(0, os.path.dirname(__file__))
from test_import_reference import _write_ref_sample  # noqa: E402

torch.set_num_threads(1)

COLUMNS = ("labels", "video_ids", "gaits", "cams", "set_ids")


def assert_same_dataset(got, want):
    """Two GaitDatasets (one per package) bitwise equal: metadata, columns,
    dataset_source, and every store's volumes, presence and scale."""
    assert (got.name, got.ntype) == (want.name, want.ntype)
    assert list(got.modality_names) == list(want.modality_names)
    for c in COLUMNS:
        a, b = getattr(got, c), getattr(want, c)
        assert a.dtype == b.dtype and np.array_equal(a, b), c
    src_a = getattr(got, "dataset_source", None)
    src_b = getattr(want, "dataset_source", None)
    assert (src_a is None) == (src_b is None)
    if src_a is not None:
        assert src_a.dtype == src_b.dtype and np.array_equal(src_a, src_b)
    for m in want.modality_names:
        a, b = got.modalities[m], want.modalities[m]
        assert a.compress_factor == b.compress_factor
        va, vb = np.asarray(a.volumes), np.asarray(b.volumes)
        assert va.dtype == vb.dtype and np.array_equal(va, vb), m
        assert np.array_equal(a.present, b.present), m


# ---------------------------------------------------------------- partitions
SPLITS = [("casiab", s) for s in ("train", "ft", "test", "test_nm",
                                  "test_bg", "test_cl")] + \
         [("tum_gaid", s) for s in ("train", "ft", "test", "elapsed")] + \
         [("oumvlp", "test")]


@pytest.mark.parametrize("dataset,split", SPLITS)
def test_partition_matches_jax(dataset, split):
    got = partitions.get_partition(dataset, split)
    want = j_partitions.get_partition(dataset, split)
    assert vars(got) == vars(want)
    assert got.gait_of == want.gait_of


def test_partition_subject_ids_offsets_and_errors():
    for split in ("train", "ft"):
        got = partitions.get_partition("oumvlp", split, subject_ids=[4, 9])
        want = j_partitions.get_partition("oumvlp", split,
                                          subject_ids=[4, 9])
        assert vars(got) == vars(want) and got.gait_of == want.gait_of
    assert (partitions.CASIA_LABEL_OFFSET, partitions.CASIA_GAIT_OFFSET) \
        == (j_partitions.CASIA_LABEL_OFFSET, j_partitions.CASIA_GAIT_OFFSET) \
        == (305, 3)
    for args in (("oumvlp", "train"), ("casiab", "test-cl"),
                 ("casiab", "nope"), ("tum", "nope"), ("nope", "train")):
        with pytest.raises(ValueError) as e1:
            partitions.get_partition(*args)
        with pytest.raises(ValueError) as e2:
            j_partitions.get_partition(*args)
        assert str(e1.value) == str(e2.value)


# ------------------------------------------------------------------ convert
def _pair(pkg_synth, **extra):
    kw = dict(num_subjects=3, videos_per_subject=2, subseqs_per_video=2)
    kw.update(extra)
    return (pkg_synth(seed=0, name="tum", **kw),
            pkg_synth(seed=1, name="casia", num_cams=3, **kw))


def test_combine_datasets_matches_jax():
    a, b = _pair(make_synthetic_dataset)
    ja, jb = _pair(j_make_synthetic)
    got = convert.combine_datasets(a, b)
    want = j_convert.combine_datasets(ja, jb)
    assert_same_dataset(got, want)
    assert np.array_equal(got.dataset_source,
                          np.repeat([0, 1], [len(a), len(b)]))
    assert got.labels[len(a):].min() >= 305 + 1


def test_combine_datasets_survives_save_and_load(tmp_path):
    a, b = _pair(make_synthetic_dataset)
    convert.combine_datasets(a, b).save(str(tmp_path / "j"))
    ja, jb = _pair(j_make_synthetic)
    assert_same_dataset(GaitDataset.load(str(tmp_path / "j")),
                        j_convert.combine_datasets(ja, jb))


def _ntype(ds):
    ds.ntype = 1
    return ds


def _drop_gray(ds):
    del ds.modalities["gray"]
    return ds


def _shrink(ds):
    st = ds.modalities["of"]
    st.volumes = np.ascontiguousarray(st.volumes[:, :40])
    return ds


def _rescale(ds):
    ds.modalities["of"].compress_factor = 50.0
    return ds


def _secondary_only(pkg_synth):
    kw = dict(num_subjects=2, videos_per_subject=1, subseqs_per_video=2)
    return (pkg_synth(modalities=("gray",), **kw),
            pkg_synth(modalities=("gray", "of"), **kw))


@pytest.mark.parametrize("fault,match", [
    (_ntype, "ntype"), (_drop_gray, "missing modality"),
    (_shrink, "volume shapes"), (_rescale, "quantization scales"),
    ("secondary_only", "absent")])
def test_combine_datasets_guards(fault, match):
    """Each guard raises the JAX package's error on the same inputs."""
    errors = []
    for synth, combine in ((make_synthetic_dataset,
                            convert.combine_datasets),
                           (j_make_synthetic, j_convert.combine_datasets)):
        if fault == "secondary_only":
            a, b = _secondary_only(synth)
        else:
            a, b = _pair(synth)
            b = fault(b)
        with pytest.raises(ValueError, match=match) as e:
            combine(a, b)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _ref_tree(root, n=6, cf=100, seed=0):
    rng = np.random.RandomState(seed)
    d = str(root)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        shape, dtype = ((60, 60, 50), np.int16) if cf > 1 else \
            ((60, 60, 25), np.uint8)
        lo, hi = (-3000, 3000) if cf > 1 else (0, 255)
        _write_ref_sample(os.path.join(d, f"{i:03d}-nm-{i:02d}.h5"),
                          rng.randint(lo, hi, shape).astype(dtype),
                          300 + i // 2, 10 + i, i % 3, 90, cf)
    return d


def test_import_reference_dir_matches_jax(tmp_path):
    import h5py
    d = _ref_tree(tmp_path / "of_ref")
    with h5py.File(os.path.join(d, "zzz-empty.h5"), "w") as f:
        f["data"] = np.zeros((0,), np.int16)
        f["compressFactor"] = np.uint8(100)
    with open(os.path.join(d, "zz-corrupt.h5"), "wb") as f:
        f.write(b"not an hdf5 file")
    got = convert.import_reference_dir(d, "of", name="mini")
    assert len(got) == 6
    assert_same_dataset(got, j_convert.import_reference_dir(d, "of",
                                                            name="mini"))
    g = _ref_tree(tmp_path / "gray_ref", cf=1, seed=1)
    assert_same_dataset(convert.import_reference_dir(g, "gray"),
                        j_convert.import_reference_dir(g, "gray"))


def test_import_reference_dir_errors(tmp_path):
    d = _ref_tree(tmp_path / "mixed", n=2)
    _write_ref_sample(os.path.join(d, "x-badcf.h5"),
                      np.zeros((60, 60, 25), np.uint8), 1, 1, 0, 90, cf=1)
    for fn in (convert.import_reference_dir, j_convert.import_reference_dir):
        with pytest.raises(ValueError, match="compressFactor"):
            fn(d, "of")
        with pytest.raises(FileNotFoundError, match="no readable"):
            fn(str(tmp_path), "of")


# ----------------------------------------------------------------- tfrecord
def test_tfrecord_reader_on_tensorflow_files(tmp_path):
    """A gait record and a negative Int64List written by TensorFlow: the
    port reads what the JAX package reads, with crc 'header' and 'full'."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.RandomState(0)
    vol = rng.randint(-3000, 3000, (1, 50, 60, 60)).astype(np.int16)

    def i64(*v):
        return tf.train.Feature(int64_list=tf.train.Int64List(value=list(v)))

    ex = tf.train.Example(features=tf.train.Features(feature={
        "height": i64(60), "width": i64(60), "depth": i64(50),
        "data": tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[vol.tobytes()])),
        "labels": i64(42), "set": i64(1), "videoId": i64(-1, 7),
        "compressFactor": i64(100), "gait": i64(2),
        "score": tf.train.Feature(float_list=tf.train.FloatList(
            value=[0.5, -2.25])),
    }))
    path = str(tmp_path / "sample.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        w.write(ex.SerializeToString())
        w.write(ex.SerializeToString())
    for crc in ("none", "header", "full"):
        got = list(tfrecord.iter_tfrecords(path, crc=crc))
        assert got == list(j_tfrecord.iter_tfrecords(path, crc=crc))
        assert len(got) == 2
    parsed = tfrecord.parse_example(got[0])
    want = j_tfrecord.parse_example(got[0])
    assert parsed.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(parsed[k], want[k]), k
        else:
            assert parsed[k] == want[k], k
    assert parsed["videoId"] == [-1, 7]
    full = tfrecord.load_gait_tfrecord(path, all_info=True)
    jfull = j_tfrecord.load_gait_tfrecord(path, all_info=True)
    assert full.keys() == jfull.keys()
    for k in jfull:
        a, b = full[k], jfull[k]
        assert (np.array_equal(a, b) if isinstance(b, np.ndarray)
                else a == b), k
    data, label, vid = tfrecord.load_gait_tfrecord(path)
    jdata, jlabel, jvid = j_tfrecord.load_gait_tfrecord(path)
    assert label == 42 and (label, vid) == (jlabel, jvid)
    assert data.dtype == jdata.dtype and np.array_equal(data, jdata)
    np.testing.assert_array_equal(data, vol.astype(np.float32) / 100.0)

    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    for mod in (tfrecord, j_tfrecord):
        with pytest.raises(ValueError, match="corrupt"):
            list(mod.iter_tfrecords(bad, crc="full"))


def test_tfrecord_truncation_and_crc():
    payload = b"hello-record"
    head = struct.pack("<Q", len(payload))
    assert tfrecord._crc32c(payload) == j_tfrecord._crc32c(payload)
    assert tfrecord._masked_crc(head) == j_tfrecord._masked_crc(head)
    rec = (head + struct.pack("<I", tfrecord._masked_crc(head)) + payload
           + struct.pack("<I", tfrecord._masked_crc(payload)))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ok = os.path.join(d, "ok.tfrecord")
        open(ok, "wb").write(rec)
        assert list(tfrecord.iter_tfrecords(ok, crc="full")) == [payload]
        for cut, match in ((7, "length header cut"),
                           (len(rec) - 3, "truncated")):
            trunc = os.path.join(d, f"t{cut}.tfrecord")
            open(trunc, "wb").write(rec + rec[:cut])
            errors = []
            for mod in (tfrecord, j_tfrecord):
                with pytest.raises(ValueError) as e:
                    list(mod.iter_tfrecords(trunc, crc="none"))
                errors.append(str(e.value))
            assert errors[0] == errors[1]


# ------------------------------------------------------------- dataset_info
def test_dataset_info_matches_jax(tmp_path):
    (tmp_path / "tumgaidtrainids.lst").write_text("1 2 3\n")
    (tmp_path / "tumgaidvalids.lst").write_text("4\n")
    (tmp_path / "tumgaidtestids.lst").write_text("5 6\n")
    (tmp_path / "allgender.txt").write_text("m f m f m f m\n")
    (tmp_path / "allage.txt").write_text("20 30 40 50 60 70 80\n")
    (tmp_path / "allshoetype.txt").write_text("a b c d e f g\n")
    db = dataset_info.TumGaidMetadata(str(tmp_path))
    jdb = j_info.TumGaidMetadata(str(tmp_path))
    assert (db.train, db.val, db.test) == (jdb.train, jdb.val, jdb.test)
    for lab in range(7):
        assert (db.gender(lab), db.age(lab), db.shoe(lab)) == \
            (jdb.gender(lab), jdb.age(lab), jdb.shoe(lab))
    labels = np.array([1, 4, 5, 2, 6, 3, 9])
    for a, b in zip(db.split_indices(labels), jdb.split_indices(labels)):
        assert np.array_equal(a, b)
    rng = np.random.RandomState(3)
    labels = rng.randint(0, 7, 90)
    for perc in (0.1, 0.25):
        for a, b in zip(
                dataset_info.split_train_val_by_subject(labels, perc),
                j_info.split_train_val_by_subject(labels, perc)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    p = tmp_path / "groups.txt"
    p.write_text("1 10 11 12\n2 20 21\n\n3\n")
    assert dataset_info.load_groups_file(str(p)) == \
        j_info.load_groups_file(str(p))


# ----------------------------------------------------------------- builders
def _video(mod, t=60, h=120, w=160, seed=0, frame_ids=None, vid=7):
    rng = np.random.RandomState(seed)
    if mod == "of":
        frames = (rng.randn(t, h, w, 2) * 500).astype(np.int16)
    else:
        frames = rng.randint(0, 255, (t, h, w)).astype(np.uint8)
    nbox = t if frame_ids is None else len(frame_ids)
    boxes = np.zeros((nbox, 4))
    for i in range(nbox):
        x = 20 + i * 1.7
        boxes[i] = [30, x, 100, x + 33]
    return dict(frames=frames, boxes=boxes, label=5 + seed, gait=seed % 3,
                cam=18 * seed, video_id=vid, frame_ids=frame_ids)


@pytest.fixture(params=["cv2", "numpy"])
def cv2_route(request, monkeypatch):
    """Both packages take the same resize route: cv2's, or (with
    ``_HAS_CV2 = False``) the numpy one."""
    has = request.param == "cv2"
    if has:
        pytest.importorskip("cv2")
    monkeypatch.setattr(builders, "_HAS_CV2", has)
    monkeypatch.setattr(j_builders, "_HAS_CV2", has)
    return has


def test_resize_bilinear_matches_jax(cv2_route):
    rng = np.random.RandomState(0)
    for img in (rng.rand(24, 32).astype(np.float32),
                rng.randint(0, 255, (30, 40, 2)).astype(np.int16)):
        got = builders.resize_bilinear(img, 16, 12)
        want = j_builders.resize_bilinear(img, 16, 12)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        got = builders.hshift_crop(got, -3.25, 10)
        want = j_builders.hshift_crop(want, -3.25, 10)
        assert np.array_equal(got, want)


def test_numpy_resize_is_its_own_route(monkeypatch):
    """The two routes differ (cv2 rounds its weights to fixed point), so
    pinning both is not pinning one twice."""
    pytest.importorskip("cv2")
    img = np.random.RandomState(0).rand(24, 32).astype(np.float32)
    a = builders.resize_bilinear(img, 16, 12)
    monkeypatch.setattr(builders, "_HAS_CV2", False)
    b = builders.resize_bilinear(img, 16, 12)
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("mod", ["gray", "of"])
def test_extract_windows_and_build_dataset_match_jax(cv2_route, mod):
    ids = np.arange(9, 9 + 40)
    kws = [_video(mod, seed=s, vid=None) for s in range(2)] + \
        [_video(mod, seed=2, frame_ids=ids)]
    wins = builders.extract_windows(builders.TrackedVideo(**kws[2]), mod)
    jwins = j_builders.extract_windows(j_builders.TrackedVideo(**kws[2]),
                                       mod)
    assert len(wins) == len(jwins) == 3
    for a, b in zip(wins, jwins):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = builders.build_dataset(
        [builders.TrackedVideo(**k) for k in kws], mod, name="b",
        val_perc=0.3, seed=4)
    want = j_builders.build_dataset(
        [j_builders.TrackedVideo(**k) for k in kws], mod, name="b",
        val_perc=0.3, seed=4)
    assert len(got) > 0 and (got.set_ids == 2).any()
    assert_same_dataset(got, want)


def test_merge_modalities_matches_jax(cv2_route):
    outs = []
    for pkg in (builders, j_builders):
        parts = [pkg.build_dataset([pkg.TrackedVideo(**_video(m, seed=s))
                                    for s in range(2)], m, name=m)
                 for m in ("of", "gray")]
        parts[0].dataset_source = np.arange(len(parts[0])) % 2
        outs.append(pkg.merge_modalities(parts, name="m"))
        with pytest.raises(ValueError, match="duplicate"):
            pkg.merge_modalities([parts[0], parts[0]], name="x")
        bad = pkg.build_dataset([pkg.TrackedVideo(**_video("gray", seed=s))
                                 for s in (1, 0)], "gray", name="g")
        with pytest.raises(ValueError, match="not aligned"):
            pkg.merge_modalities([parts[0], bad], name="x")
        parts[1].ntype = 1
        with pytest.raises(ValueError, match="ntype"):
            pkg.merge_modalities(parts, name="x")
    assert_same_dataset(*outs)


def test_frame_loaders_match_jax(tmp_path, cv2_route):
    from PIL import Image
    rng = np.random.RandomState(5)
    d = tmp_path / "sil"
    d.mkdir()
    for i in range(4):
        Image.fromarray(rng.randint(0, 2, (24, 32)).astype(np.uint8) * 255
                        ).save(d / f"{i:03d}.png")
    got = builders.load_silhouette_frames(str(d))
    want = j_builders.load_silhouette_frames(str(d))
    assert got.shape == (4, 24, 32) and np.array_equal(got, want)
    if not cv2_route:
        for mod in (builders, j_builders):
            with pytest.raises(RuntimeError, match="cv2"):
                mod.load_video_frames(str(tmp_path / "x.avi"))


# --------------------------------------------------------------- build_data
def _build_both(tmp_path, name, argv):
    """cli.build_data of both packages with the same flags; returns the
    two packed sets, loaded."""
    out, jout = str(tmp_path / name), str(tmp_path / f"j_{name}")
    build_data.main(argv + ["--outdir", out])
    j_build_data.main(argv + ["--outdir", jout])
    got, want = GaitDataset.load(out), JGaitDataset.load(jout)
    # the name is the --outdir's basename in --merge mode
    if got.name == name:
        want.name = name
    return got, want


def test_build_data_synthetic_and_import_ref(tmp_path):
    got, want = _build_both(tmp_path, "syn", ["--synthetic"])
    assert_same_dataset(got, want)
    refs = {"of": _ref_tree(tmp_path / "ref_of", n=4),
            "gray": _ref_tree(tmp_path / "ref_gray", n=4, cf=1, seed=1)}
    packed = {}
    for m, d in refs.items():
        got, want = _build_both(tmp_path, f"imp_{m}",
                                ["--import-ref", d, "--modality", m])
        assert len(got) == 4
        assert_same_dataset(got, want)
        packed[m] = str(tmp_path / f"imp_{m}")
    got, want = _build_both(tmp_path, "merged",
                            ["--merge", packed["of"], packed["gray"]])
    assert list(got.modality_names) == ["of", "gray"]
    assert_same_dataset(got, want)
    with pytest.raises(SystemExit, match="outdir"):
        build_data.main(["--merge", packed["of"], "--outdir", packed["of"]])


def _raw_tree(tmp_path, dataset, mode, modality, subject_ids=None,
              cams=None):
    """Track .pkl files plus OF .npz or .avi videos named as the reference
    names them, for every (subject, condition, camera) of the split."""
    spec = partitions.get_partition(dataset, mode, subject_ids=subject_ids)
    ofdir, viddir, trackdir = (tmp_path / n for n in ("of", "vid", "tr"))
    for d in (ofdir, viddir, trackdir):
        d.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    t, h, w = 40, 48, 64
    for sid in spec.subject_ids[:2]:
        for ci, cond in enumerate(spec.conditions[:2]):
            for cam in (cams or spec.cameras or (0,))[:2]:
                if dataset == "casiab":
                    stem = f"{sid:03d}-{cond}-{cam:03d}"
                elif dataset == "oumvlp":
                    stem = f"{sid:05d}-{cond}-{cam:03d}"
                else:
                    stem = f"p{sid:03d}-{cond}"
                start = 3 * ci
                boxes = np.tile(np.array([8.0, 20 + sid % 5, 40, 44]),
                                (t - start, 1))
                with open(trackdir / (stem + ".pkl"), "wb") as f:
                    pickle.dump(([boxes], [np.arange(start, t)]), f)
                if modality == "of":
                    of = rng.randn(t, 2, h, w).astype(np.float32) * 300
                    np.savez(ofdir / (stem + ".npz"), of=of)
                else:
                    import cv2
                    vw = cv2.VideoWriter(str(viddir / (stem + ".avi")),
                                         cv2.VideoWriter_fourcc(*"MJPG"),
                                         25, (w, h), False)
                    for _ in range(t):
                        vw.write(rng.randint(0, 255, (h, w), np.uint8))
                    vw.release()
    return ["--dataset", dataset, "--mode", mode, "--modality", modality,
            "--ofdir", str(ofdir), "--videodir", str(viddir),
            "--trackdir", str(trackdir)]


@pytest.mark.parametrize("dataset,mode,modality", [
    ("casiab", "train", "of"), ("tum_gaid", "ft", "of"),
    ("oumvlp", "train", "of"), ("casiab", "test_bg", "gray")])
def test_build_data_raw_matches_jax(tmp_path, dataset, mode, modality):
    if modality != "of":
        pytest.importorskip("cv2")
    ids = None
    argv = []
    if dataset == "oumvlp":
        ids = [3, 12]
        (tmp_path / "ids.txt").write_text("3\n12\n")
        argv = ["--subject-ids", str(tmp_path / "ids.txt")]
    argv = _raw_tree(tmp_path, dataset, mode, modality, ids) + argv
    got, want = _build_both(tmp_path, "raw", argv)
    assert len(got) > 0
    assert_same_dataset(got, want)


def test_build_data_refusals(tmp_path):
    for argv, match in ((["--modality", "gray"], "need --import-ref"),
                        (["--trackdir", "t"], "needs --ofdir"),
                        (["--trackdir", "t", "--modality", "gray"],
                         "needs --videodir")):
        for main in (build_data.main, j_build_data.main):
            with pytest.raises(SystemExit, match=match):
                main(argv + ["--outdir", str(tmp_path / "x")])
    assert build_data._parse_subject_ids("1, 2,3") == [1, 2, 3]
