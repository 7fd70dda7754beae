"""The port's native batch gather (``data/native.py`` over its own copy of
``csrc/gaitloader.cpp``) against numpy, on the CPU: memory-mapped and
in-memory stores, uint8 and int16 rows, repeated and empty index lists;
out-of-range and negative indices refused on the native path and on the
``np.take`` path alike; ``out=`` validated; the library built into the
gitignored ``build/native/``, never beside its source."""

import os

import numpy as np
import pytest

from ugaitnet_tpu_torch.data import native
from ugaitnet_tpu_torch.data.pipeline import gather_host_batch
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Each test runs on the native library and on the np.take path."""
    if request.param == "native":
        assert native.get_lib() is not None, "the C++ compiler is missing"
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


def _stores(tmp_path):
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 255, (9, 25, 6, 6)).astype(np.uint8)
    i16 = rng.randint(-3000, 3000, (9, 50, 6, 6)).astype(np.int16)
    np.save(tmp_path / "u8.npy", u8)
    np.save(tmp_path / "i16.npy", i16)
    return [u8, i16, np.load(tmp_path / "u8.npy", mmap_mode="r"),
            np.load(tmp_path / "i16.npy", mmap_mode="r")]


@pytest.mark.parametrize("idx", [[3, 0, 8], [2, 2, 2, 5, 2], []])
def test_gather_equals_numpy(tmp_path, path, idx):
    for src in _stores(tmp_path):
        got = native.gather_rows(src, np.asarray(idx, np.int64))
        want = np.asarray(src)[np.asarray(idx, np.int64)]
        assert got.dtype == src.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
        out = np.empty_like(want)
        assert native.gather_rows(src, idx, out=out) is out
        assert np.array_equal(out, want)


@pytest.mark.parametrize("bad", [[0, 9], [-1, 2]])
def test_bounds_and_negative_indices_refused(tmp_path, path, bad):
    for src in _stores(tmp_path):
        with pytest.raises(IndexError):
            native.gather_rows(src, np.asarray(bad))


def test_out_is_validated(tmp_path, path):
    src = _stores(tmp_path)[1]
    for out in (np.empty((2, 50, 6, 6), np.int16),      # too few rows
                np.empty((3, 50, 6, 6), np.uint8),      # wrong dtype
                np.empty((3, 50, 6, 5), np.int16)):     # wrong row shape
        with pytest.raises(ValueError):
            native.gather_rows(src, [0, 1, 2], out=out)


def test_library_builds_into_build_dir():
    lib = native.get_lib()
    assert lib is not None and lib.ug_version() == native.ABI_VERSION
    assert os.path.exists(native.LIB_PATH)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(native.LIB_PATH) == os.path.join(repo, "build",
                                                             "native")
    assert os.path.dirname(native.SRC) == os.path.join(
        repo, "ugaitnet_tpu_torch", "csrc")
    assert not [f for f in os.listdir(os.path.dirname(native.SRC))
                if f.endswith(".so")]


def test_native_available_matches_jax(monkeypatch):
    """native_available against the JAX package's: True with the library
    built, False where get_lib finds none."""
    from ugaitnet_tpu.data import native as j_native
    assert native.native_available() is True
    assert native.native_available() == j_native.native_available()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    assert native.native_available() is False
    assert native.native_available() == j_native.native_available()


def test_host_batch_gathers_every_modality(tmp_path, path):
    ds = make_synthetic_dataset(num_subjects=2, videos_per_subject=2,
                                subseqs_per_video=2, seed=3)
    ds.save(str(tmp_path / "ds"))
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    mm = GaitDataset.load(str(tmp_path / "ds"))
    idx = np.array([5, 1, 1, 7])
    raw = gather_host_batch(mm, idx, ("of", "gray"), mm.label_map())
    for m in ("of", "gray"):
        assert np.array_equal(raw[f"raw_{m}"], ds.modalities[m].volumes[idx])
    assert raw["labels"].tolist() == [1, 0, 0, 1]
