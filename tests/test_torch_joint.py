"""Joint two-dataset (BothDatasets) training through the port's CLIs,
against the JAX package's, on the CPU.

A TUM-GAID-like and a CASIA-B-like synthetic set are packed once; both
train CLIs run ``--datadir A --datadir2 B --normstats`` with the same flags
(tiny two-branch config, ``--noaugment``, ``--expandlevel 1``, so no batch
draws anything random; SGD, whose update is linear in the gradient, so
float32 rounding does not flip Adam's first-step signs) from the same
initial weights: ``--initnet`` of a
port experiment and of a JAX experiment holding those weights through the
weight bridge.  The JAX run has its ``pairwise_dist`` diagonal zeroed, as
``tests/test_torch_trainer.py`` explains.

Tolerances: per-epoch losses, accuracy and EER at rtol 1e-4 (that file's;
validation's triplet 1e-3, as VAL_TRIPLET_RTOL explains);
``norm_stats.npz`` bitwise (the same float64 numpy reduction): one row per
dataset source.  The port's evaluate CLI on the joint run's checkpoint gives
the JAX evaluate CLI's results on the same weights, each sample standardized
by its own source's row; the export CLI bakes both rows in."""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.cli import evaluate as j_evaluate
from ugaitnet_tpu.cli import train as j_train
from ugaitnet_tpu.core import checkpoint as jckpt
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.core.config import load_json as j_load_json
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import train_step as J

from ugaitnet_tpu_torch.cli import evaluate, export_model, train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.convert import combine_datasets
from ugaitnet_tpu_torch.data.pipeline import compute_normalization_stats
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.export import ExportedEncoder
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv.logger import read_metrics
from ugaitnet_tpu_torch.train.train_step import init_state
from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import _exact_diagonal_dist  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-4
# validation's triplet (and the val loss that holds it): a triplet whose
# hinge lies within float32 rounding of 0 may count on one side only
# (ROADMAP.md section 3, "Validation's triplet"), which moves a part's mean
# by about its value / its active count; at these 9-clip validation batches
# that read 1.6e-4 relative with the weights equal to ~1e-7
VAL_TRIPLET_RTOL = 1e-3
FLAGS = ["--nclasses", "5", "--bs", "8", "--repetitions", "2",
         "--epochs", "2", "--savemodelfreq", "1", "--gschannels", "8,8,16",
         "--gspartdim", "16", "--expandlevel", "1", "--noaugment",
         "--mergefun", "sign_max", "--optimizer", "sgd", "--lr", "1e-2",
         "--valperc", "0.3",
         "--normstats", "--initepoch", "1"]


def _sets(root):
    """TUM-like (3 subjects, gaits n/b/s) and CASIA-like (2 subjects, 3
    cameras) packed sets; their joint set has 5 labels."""
    kw = dict(videos_per_subject=3, subseqs_per_video=2, template_seed=0)
    dirs = {}
    for name, n, seed, cams in (("tum", 3, 1, 1), ("casia", 2, 2, 3)):
        dirs[name] = str(root / name)
        make_synthetic_dataset(num_subjects=n, seed=seed, name=name,
                               num_cams=cams, **kw).save(dirs[name])
    return dirs


def _init_experiments(root):
    """The same initial weights as a port and as a JAX experiment."""
    port, jexp = str(root / "init_port"), str(root / "init_jax")
    flags = FLAGS + ["--datadir", "x"]
    mcfg, _, _ = train.configs_from_args(train.build_parser().parse_args(
        flags))
    model = UGaitNet(mcfg, device="cpu", seed=11)
    ckpt.save_checkpoint(port, 1, init_state(model, tconfig.TrainConfig()))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    state_dict_to_flax(model.state_dict()))
    tx = J.make_optimizer(JTrainConfig())
    jckpt.save_checkpoint(jexp, 1, J.TrainState(
        step=jnp.int32(0), params=params, opt_state=tx.init(params)))
    return port, jexp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("joint")
    dirs = _sets(root)
    port_init, jax_init = _init_experiments(root)
    data = ["--datadir", dirs["tum"], "--datadir2", dirs["casia"]]
    exp = train.main(FLAGS + data + [
        "--initnet", port_init, "--device", "cpu",
        "--experdir", str(root / "port")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UGAITNET_CACHE_DIR", str(root / "jax_cache"))
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        jexp = j_train.main(FLAGS + data + [
            "--initnet", jax_init, "--experdir", str(root / "jax")])
    return dict(root=root, dirs=dirs, exp=exp, jexp=jexp)


def _by_epoch(experdir):
    out = {}
    for r in read_metrics(experdir):
        for k, v in r.items():
            if k not in ("step", "time"):
                out.setdefault(k, {})[int(r["step"])] = v
    return out


def test_joint_losses_match_jax(runs):
    got, want = _by_epoch(runs["exp"]), _by_epoch(runs["jexp"])
    keys = [k for k in want if k.startswith(("train/", "val/"))]
    assert {"train/loss", "train/triplet", "val/loss", "val/eer"} <= \
        set(keys)
    for k in keys:
        assert sorted(got[k]) == sorted(want[k]) == [1, 2], k
        for e, v in want[k].items():
            if v is None:
                assert got[k][e] is None, (k, e)
                continue
            rtol = VAL_TRIPLET_RTOL if k in ("val/triplet", "val/loss") \
                else RTOL
            np.testing.assert_allclose(got[k][e], v, rtol=rtol, atol=1e-7,
                                       err_msg=f"{k} epoch {e}")
    assert got["train/loss"][1] > 0


def test_norm_stats_one_row_per_source(runs):
    got = np.load(os.path.join(runs["exp"], "norm_stats.npz"))
    want = np.load(os.path.join(runs["jexp"], "norm_stats.npz"))
    assert sorted(got.files) == sorted(want.files) == [
        "mean_gray", "mean_of", "std_gray", "std_of"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    joint = combine_datasets(GaitDataset.load(runs["dirs"]["tum"]),
                             GaitDataset.load(runs["dirs"]["casia"]))
    for m, t in (("of", 50), ("gray", 25)):
        assert got[f"mean_{m}"].shape == (2, t)
        for s in (0, 1):
            mean, std = compute_normalization_stats(
                joint, m, joint.dataset_source == s)
            assert np.array_equal(got[f"mean_{m}"][s], mean)
            assert np.array_equal(got[f"std_{m}"][s], std)
        pooled, _ = compute_normalization_stats(joint, m)
        assert not np.allclose(got[f"mean_{m}"], pooled[None])


def test_joint_evaluate_matches_jax(runs, capsys, monkeypatch):
    """Both evaluate CLIs on the port's epoch-2 weights over the joint set:
    the same results JSON and confusions, i.e. the same labels."""
    monkeypatch.setenv("UGAITNET_CACHE_DIR",
                       str(runs["root"] / "jax_cache"))
    root = runs["root"]
    joint = str(root / "joint_set")
    if not os.path.isdir(joint):
        combine_datasets(GaitDataset.load(runs["dirs"]["tum"]),
                         GaitDataset.load(runs["dirs"]["casia"])
                         ).save(joint)
    jexp = str(root / "jax_of_port")
    os.makedirs(jexp, exist_ok=True)
    for name in ("config.json", "norm_stats.npz"):
        shutil.copy(os.path.join(runs["exp"], name), jexp)
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        ckpt.restore_raw(runs["exp"], 2)["model"]))
    tx = J.make_optimizer(j_load_json(os.path.join(jexp, "config.json"))
                          ["train"])
    jckpt.save_checkpoint(jexp, 2, J.TrainState(
        step=jnp.int32(0), params=params, opt_state=tx.init(params)))
    args = ["--gallery", joint, "--probes", joint, "--protocol", "openset",
            "--knn", "1", "--bs", "8", "--epoch", "2"]
    results = []
    for main, extra in ((evaluate.main, ["--experdir", runs["exp"],
                                         "--device", "cpu"]),
                        (j_evaluate.main, ["--experdir", jexp])):
        main(args + extra)
        out = capsys.readouterr().out
        assert "using persisted norm_stats.npz" in out
        results.append(json.loads(out[out.index("{"):out.rindex("}") + 1]))
    got, want = results
    gconf, wconf = (np.load(r["joint_set"].pop("confusions_file"))
                    for r in (got, want))
    assert got == want
    for k in wconf.files:
        assert np.array_equal(gconf[k], wconf[k]), k


def test_joint_export_bakes_both_rows(runs):
    out = str(runs["root"] / "art")
    export_model.main(["--experdir", runs["exp"], "--epoch", "2", "--out",
                       out, "--buckets", "4", "--device", "cpu"])
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["normalized"] and meta["norm_sources"] == 2
    ds = GaitDataset.load(runs["dirs"]["casia"])
    raw = {f"raw_{m}": np.asarray(ds.modalities[m].volumes[:3])
           for m in ("of", "gray")}
    raw.update({f"present_{m}": np.ones(3, np.float32)
                for m in ("of", "gray")})
    enc = ExportedEncoder(out, device="cpu")
    a = enc.encode(dict(raw, source=np.ones(3, np.int32)))
    b = enc.encode(dict(raw, source=np.zeros(3, np.int32)))
    assert not np.allclose(a, b)
    with pytest.raises(ValueError, match="source"):
        enc.encode(raw)
