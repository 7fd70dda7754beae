"""Keras h5 import and export of the port (``utils/keras_import.py``,
``utils/keras_export.py``, ``cli.export_model --keras-h5``) against the JAX
package's modules, on h5 files in the Keras weights layout written here
(gaitset nets by ``tests/test_warm_start.py``'s writer, the 2D / 3D CNN
branch Sequentials by ``_write_keras_h5``).

Both packages fill the same flax-layout tree from the same file, so every
leaf must be bitwise equal; the port's tree goes into a ``UGaitNet``
through the weight bridge and comes back bitwise.  Export is the inverse:
the port's h5 equals the JAX package's h5 of the same tree, and the JAX
importer reads back the port's weights exactly."""

import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import BranchConfig as JBranchConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.utils import keras_export as j_export
from ugaitnet_tpu.utils import keras_import as j_import

from ugaitnet_tpu_torch.cli import export_model, train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.utils import keras_export, keras_import
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

sys.path.insert(0, os.path.dirname(__file__))
from test_warm_start import _write_fake_gaitset_h5  # noqa: E402

torch.set_num_threads(1)

SMALL_2D = dict(filters_numbers=(8, 8, 16, 16), ndense_units=16)


def _jcfg(kind, nmods=2, nclasses=7):
    if kind == "gaitset":
        cfg = graft._flagship_cfg(tiny=True)
        return JModelConfig(branches=cfg.branches[:nmods], merge=cfg.merge,
                            nclasses=nclasses)
    extra = SMALL_2D if kind == "conv2d" else dict(ndense_units=16)
    return JModelConfig(
        branches=tuple(JBranchConfig(kind=kind, modality=m, **extra)
                       for m in ("of", "gray")[:nmods]),
        merge="sign_max", nclasses=nclasses)


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def _port_tree(jcfg, seed=0):
    """A port model's weights in the flax layout (numpy leaves)."""
    return state_dict_to_flax(UGaitNet(_tcfg(jcfg), device="cpu",
                                       seed=seed).state_dict())


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_tree(got, want):
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _write_keras_h5(path, layers):
    """layers: [(group name, [arrays in Keras weight order])] -> an h5 in
    the Keras save_weights layout (layer_names, weight_names)."""
    with h5py.File(path, "w") as f:
        for name, arrays in layers:
            g = f.create_group(name)
            wnames = []
            for i, a in enumerate(arrays):
                wn = f"{name}/w_{i}:0"
                g.create_dataset(wn, data=np.asarray(a, np.float32))
                wnames.append(wn.encode())
            g.attrs["weight_names"] = wnames
        f.attrs["layer_names"] = [n for n, _ in layers]


def _write_sequential_h5(path, jcfg, seed):
    """A reference conv2d / conv3d net's h5: one '<slot>Branch' Sequential
    per branch (of, gray slots), then classprob; random weights of the
    config's shapes."""
    rng = np.random.RandomState(seed)
    tree = _port_tree(jcfg)["params"]
    layers = []
    for slot, b in zip(("ofBranch", "grayBranch"), jcfg.branches):
        sub = tree[f"branch_{b.modality}"]
        names = sorted((k for k in sub if k.startswith("conv")),
                       key=lambda k: int(k[4:]))
        names += ["dense", "code"] if "dense" in sub else ["code"]
        arrays = []
        for n in names:
            arrays += [rng.randn(*sub[n]["kernel"].shape),
                       rng.randn(*sub[n]["bias"].shape)]
        layers.append((slot, arrays))
    k = tree["classprob"]["kernel"]
    layers.append(("classprob", [rng.randn(*k.shape), rng.randn(k.shape[1])]))
    _write_keras_h5(path, layers)


def _h5_for(tmp_path, kind, nmods, seed=3, name="src.h5"):
    path = str(tmp_path / name)
    jcfg = _jcfg(kind, nmods)
    if kind == "gaitset":
        c = jcfg.branches[0].gaitset_channels
        _write_fake_gaitset_h5(path, nmods, [2, 1][:nmods], channels=c,
                               part_dim=jcfg.branches[0].part_dim,
                               nclasses=jcfg.nclasses, seed=seed)
    else:
        _write_sequential_h5(path, jcfg, seed)
    return path, jcfg


CASES = [("gaitset", 1), ("gaitset", 2), ("conv2d", 2), ("conv3d", 1)]


@pytest.mark.parametrize("kind,nmods", CASES)
def test_load_keras_weights_matches_jax(tmp_path, kind, nmods):
    h5, jcfg = _h5_for(tmp_path, kind, nmods)
    target = _port_tree(jcfg)
    before = {k: v.copy() for k, v in _leaves(target).items()}
    got = keras_import.load_keras_weights(h5, target)
    want = j_import.load_keras_weights(
        h5, jax.tree_util.tree_map(jax.numpy.asarray, target))
    assert_same_tree(got, want)
    for k, v in _leaves(target).items():        # the input is not mutated
        assert np.array_equal(v, before[k]), k
    changed = [k for k, v in _leaves(got).items()
               if not np.array_equal(v, before[k])]
    assert any("classprob" in k for k in changed)
    assert any("branch_of" in k for k in changed)
    model = UGaitNet(_tcfg(jcfg), device="cpu", seed=1)
    model.load_state_dict(flax_to_state_dict(got))
    assert_same_tree(state_dict_to_flax(model.state_dict()), got)


def test_load_gaitset_2mod_weights_alias_matches_jax(tmp_path):
    """The flagship alias fills the tree as the JAX package's alias does,
    and as load_gaitset_weights does."""
    h5, jcfg = _h5_for(tmp_path, "gaitset", 2)
    target = _port_tree(jcfg)
    got = keras_import.load_gaitset_2mod_weights(h5, target)
    want = j_import.load_gaitset_2mod_weights(
        h5, jax.tree_util.tree_map(jax.numpy.asarray, target))
    assert_same_tree(got, want)
    assert_same_tree(got, keras_import.load_gaitset_weights(h5, target))


def test_conv2d_dense_rows_follow_the_reference_flatten(tmp_path):
    """The first Dense's rows come in the reference's channels-first
    (c, h, w) order and land in the port's (h, w, c) order."""
    h5, jcfg = _h5_for(tmp_path, "conv2d", 1)
    got = keras_import.load_keras_weights(h5, _port_tree(jcfg))
    src = keras_import._collect_weights(h5)["ofBranch"]
    nconv = len(jcfg.branches[0].filters_numbers)
    kd = src[2 * nconv]
    c = jcfg.branches[0].filters_numbers[-1]
    h = int(round((kd.shape[0] // c) ** 0.5))
    ref = kd.reshape(c, h, h, -1)
    ours = got["params"]["branch_of"]["dense"]["kernel"].reshape(h, h, c, -1)
    assert np.array_equal(ours, ref.transpose(1, 2, 0, 3))


@pytest.mark.parametrize("kind,nmods", CASES)
def test_export_then_jax_import_is_identity(tmp_path, kind, nmods):
    template, jcfg = _h5_for(tmp_path, kind, nmods, name="template.h5")
    tree = _port_tree(jcfg, seed=5)
    out, jout = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    keras_export.export_keras_weights(tree, out, template)
    j_export.export_keras_weights(tree, jout, template)
    a, b = (keras_import._collect_weights(p) for p in (out, jout))
    assert a.keys() == b.keys()
    for k in b:
        assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
    fresh = _port_tree(jcfg, seed=9)
    assert_same_tree(j_import.load_keras_weights(out, fresh), tree)
    assert_same_tree(keras_import.load_keras_weights(out, fresh), tree)
    with h5py.File(out, "r") as f, h5py.File(template, "r") as t:
        assert list(f.attrs["layer_names"]) == list(t.attrs["layer_names"])


def test_keras_shape_and_layout_errors(tmp_path):
    """An h5 of another architecture fails with the JAX package's message:
    a shape mismatch on export, a layer-count mismatch on import."""
    template, _ = _h5_for(tmp_path, "gaitset", 2, name="template.h5")
    wide = JModelConfig(branches=tuple(
        JBranchConfig(kind="gaitset", modality=m, gaitset_channels=(8, 8, 32),
                      part_dim=16) for m in ("of", "gray")),
        merge="sign_max", nclasses=7)
    tree = _port_tree(wide)
    errors = []
    for mod in (keras_export, j_export):
        with pytest.raises(ValueError, match="architecture mismatch") as e:
            mod.export_keras_weights(tree, str(tmp_path / "x.h5"), template)
        errors.append(str(e.value))
    one = _port_tree(_jcfg("gaitset", 1))
    for mod in (keras_import, j_import):
        with pytest.raises(ValueError, match="not an 1-mod gaitset") as e:
            mod.load_keras_weights(template, one)
        errors.append(str(e.value))
    seq, _ = _h5_for(tmp_path, "conv2d", 2, name="seq.h5")
    for mod in (keras_import, j_import):
        with pytest.raises(ValueError, match="branch groups") as e:
            mod.load_keras_weights(seq, _port_tree(_jcfg("conv2d", 1)))
        errors.append(str(e.value))
    _write_keras_h5(str(tmp_path / "other.h5"), [("dense_1", [np.ones(3)])])
    for mod in (keras_import, j_import):
        with pytest.raises(ValueError, match="unrecognized") as e:
            mod.load_keras_weights(str(tmp_path / "other.h5"), one)
        errors.append(str(e.value))
    assert errors[0::2] == errors[1::2]


def test_export_model_writes_keras_h5(tmp_path):
    """cli.export_model --keras-h5 --keras-template: the h5 holds the
    checkpoint's weights (read back by the JAX importer, bitwise)."""
    exp = train.main(["--synthetic", "--nclasses", "7", "--bs", "8",
                      "--repetitions", "2", "--epochs", "1",
                      "--savemodelfreq", "1", "--gschannels", "8,8,16",
                      "--gspartdim", "16", "--expandlevel", "1",
                      "--mergefun", "sign_max", "--device", "cpu",
                      "--experdir", str(tmp_path / "exp")])
    template, jcfg = _h5_for(tmp_path, "gaitset", 2, name="template.h5")
    out = str(tmp_path / "ours.h5")
    with pytest.raises(SystemExit, match="keras-template"):
        export_model.main(["--experdir", exp, "--out", str(tmp_path / "a"),
                           "--device", "cpu", "--keras-h5", out])
    export_model.main(["--experdir", exp, "--epoch", "1", "--out",
                       str(tmp_path / "art"), "--buckets", "2", "--device",
                       "cpu", "--keras-h5", out, "--keras-template",
                       template])
    want = state_dict_to_flax(ckpt.restore_raw(exp, 1)["model"])
    assert_same_tree(j_import.load_keras_weights(out, _port_tree(jcfg, 9)),
                     want)
    assert os.path.exists(str(tmp_path / "art" / "meta.json"))
