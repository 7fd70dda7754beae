"""The port's serving artifacts (``eval/export.py``, ``cli/export_model.py``)
on the CPU, at the tiny flagship (channels (8, 8, 16), part_dim 16).

Tolerances:
  * an artifact's codes against its service's ``encode_raw``: bitwise (the
    program runs the same aten ops on the same weights; the service pads
    with zero rows, the artifact repeats the last row, and neither padding
    reaches another sample's code).
  * the port's artifact against the JAX package's ``ExportedEncoder`` on
    the bridged weights: rtol 1e-4 / atol 1e-5, the forward tolerance of
    tests/test_torch_port.py.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import load_json as j_load_json
from ugaitnet_tpu.eval.export import ExportedEncoder as JExportedEncoder
from ugaitnet_tpu.eval.export import export_encoder as j_export_encoder
from ugaitnet_tpu.eval.serving import SignatureService as JService
from ugaitnet_tpu.models.network import UGaitNet as JNet

from ugaitnet_tpu_torch.cli import export_model, train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.export import ExportedEncoder, export_encoder
from ugaitnet_tpu_torch.eval.serving import SignatureService
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
MODS = ("of", "gray")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_dataset(num_subjects=3, videos_per_subject=4,
                                  subseqs_per_video=2, num_cams=2,
                                  template_seed=0, seed=1)


@pytest.fixture(scope="module")
def model():
    return UGaitNet(_tcfg(graft._flagship_cfg(tiny=True)), device="cpu")


def _raw(ds, idx):
    return {f"raw_{m}": ds.modalities[m].volumes[idx] for m in MODS}


@pytest.fixture(scope="module", params=["float32", "int8"])
def artifact(request, tmp_path_factory, model, data):
    """A float32 or a quantized service and its exported artifact, bucket
    4."""
    kw = {}
    if request.param == "int8":
        raw = _raw(data, np.arange(8))
        raw.update({f"present_{m}": np.ones(8, np.float32) for m in MODS})
        raw["labels"] = np.zeros(8, np.int32)
        vols, _, _ = preprocess_batch(raw, MODS, (2, 1), (100.0, 1.0), 2, 1,
                                      False, tconfig.DataConfig(),
                                      device="cpu")
        kw = dict(quantized=True, calib_volumes=vols)
    svc = SignatureService(model, MODS, buckets=(4,), **kw)
    path = str(tmp_path_factory.mktemp(f"art_{request.param}"))
    sizes = export_encoder(svc, path)
    return svc, path, sizes


def test_round_trip_bitwise(artifact, data):
    """Bucket padding (3 -> 4, repeating the last row), oversize chunking
    (11 = 4 + 4 + 3) and the empty query, against the service's encode."""
    svc, path, sizes = artifact
    assert sorted(sizes) == [4]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["platform"] == "cpu" and meta["buckets"] == [4]
    assert meta["quantized"] == svc.quantized
    enc = ExportedEncoder(path, device="cpu")
    for n in (3, 11):
        raw = _raw(data, np.arange(n))
        raw["present_gray"] = (np.arange(n) % 3 != 1).astype(np.float32)
        got = enc.encode(raw)
        assert got.dtype == np.float32 and got.shape == (n, 62 * 16)
        assert np.array_equal(got, svc.encode_raw(raw)), n
    empty = enc.encode({k: v[:0] for k, v in _raw(data, [0]).items()})
    assert empty.shape == (0, 62 * 16) and empty.dtype == np.float32


@pytest.mark.parametrize("artifact", ["int8"], indirect=True)
def test_artifact_loads_without_model_code(artifact, data, tmp_path):
    """A fresh process loads the int8 artifact and encodes with none of the
    port's model or op modules imported."""
    svc, path, _ = artifact
    raw = _raw(data, np.arange(5))
    np.savez(tmp_path / "raw.npz", **raw)
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from ugaitnet_tpu_torch.eval.export import ExportedEncoder\n"
        f"enc = ExportedEncoder({path!r}, device='cpu')\n"
        f"raw = dict(np.load({str(tmp_path / 'raw.npz')!r}))\n"
        f"np.save({str(tmp_path / 'codes.npy')!r}, enc.encode(raw))\n"
        "print(sorted(m for m in sys.modules if m.startswith('ugaitnet')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = eval(res.stdout.strip().splitlines()[-1])
    assert "ugaitnet_tpu_torch.eval.export" in mods
    assert not [m for m in mods if m.startswith(("ugaitnet_tpu_torch.models",
                                                 "ugaitnet_tpu_torch.ops"))]
    assert np.array_equal(np.load(tmp_path / "codes.npy"),
                          svc.encode_raw(raw))


def test_platform_guard(artifact, tmp_path):
    _, path, _ = artifact
    other = str(tmp_path / "cuda_art")
    shutil.copytree(path, other)
    meta = json.load(open(os.path.join(other, "meta.json")))
    meta["platform"] = "cuda"
    json.dump(meta, open(os.path.join(other, "meta.json"), "w"))
    with pytest.raises(RuntimeError, match="cli/export_model.py"):
        ExportedEncoder(other, device="cpu")


def test_multi_source_norm_stats(model, data, tmp_path):
    """Standardization with two dataset sources is baked in and selected
    per sample by ``source``; a feed without it is refused."""
    rng = np.random.RandomState(2)
    stats = {m: ((rng.randn(2, n) * 0.05).astype(np.float32),
                 (rng.rand(2, n) + 0.5).astype(np.float32))
             for m, n in (("of", 50), ("gray", 25))}
    svc = SignatureService(model, MODS, buckets=(4,), norm_stats=stats)
    export_encoder(svc, str(tmp_path))
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["has_source"] and meta["norm_sources"] == 2
    enc = ExportedEncoder(str(tmp_path), device="cpu")
    raw = _raw(data, np.arange(3))
    raw["source"] = np.array([1, 0, 1], np.int32)
    got = enc.encode(raw)
    assert np.array_equal(got, svc.encode_raw(raw))
    flipped = dict(raw, source=1 - raw["source"])
    assert not np.allclose(enc.encode(flipped), got)
    with pytest.raises(ValueError, match="source"):
        enc.encode({k: v for k, v in raw.items() if k != "source"})


def test_export_cli_matches_jax_exported_encoder(tmp_path, data):
    """cli.export_model on a port checkpoint (--device cpu) against the
    JAX package's ExportedEncoder of the same weights (bridged), same
    buckets."""
    exp = train.main(["--synthetic", "--nclasses", "4", "--bs", "8",
                      "--repetitions", "2", "--epochs", "1",
                      "--savemodelfreq", "1", "--gschannels", "4,4,8",
                      "--gspartdim", "8", "--expandlevel", "1",
                      "--mergefun", "sign_max", "--device", "cpu",
                      "--experdir", str(tmp_path / "exp")])
    out = str(tmp_path / "art")
    export_model.main(["--experdir", exp, "--epoch", "1", "--out", out,
                       "--buckets", "4", "--device", "cpu", "--warmup"])
    jcfg = j_load_json(os.path.join(exp, "config.json"))["model"]
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        ckpt.restore_raw(exp, 1)["model"]))
    jout = str(tmp_path / "jax_art")
    j_export_encoder(JService(JNet(jcfg), params, MODS, buckets=(4,)), jout)
    raw = _raw(data, np.arange(6))                     # 4 + a padded 2
    want = JExportedEncoder(jout).encode(raw)
    got = ExportedEncoder(out, device="cpu").encode(raw)
    assert got.shape == want.shape == (6, 62 * 8)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    # --keras-h5 writes the checkpoint into a Keras template's layout; the
    # JAX package's importer reads the same weights back
    sys.path.insert(0, os.path.dirname(__file__))
    from test_warm_start import _write_fake_gaitset_h5
    from ugaitnet_tpu.utils.keras_import import load_keras_weights
    template, h5 = str(tmp_path / "template.h5"), str(tmp_path / "ours.h5")
    _write_fake_gaitset_h5(template, 2, [2, 1], nclasses=4)
    export_model.main(["--experdir", exp, "--epoch", "1", "--out", out,
                       "--buckets", "4", "--device", "cpu", "--keras-h5", h5,
                       "--keras-template", template])
    want = state_dict_to_flax(ckpt.restore_raw(exp, 1)["model"])
    back = load_keras_weights(h5, jax.tree_util.tree_map(np.zeros_like,
                                                         want))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)
