"""The port's sweep CLI (``cli/sweep.py``) on the CPU: grid parsing and
expansion as the JAX package's, experiment dirs named as the JAX train CLI
names them for the same flags, final metrics from this run's records only
(a stale record of an earlier run in the same dir is ignored), and the
optional TensorBoard HParams records, which a machine without tensorboard
skips with a message."""

import builtins
import glob
import itertools
import json
import os

import pytest
import torch

from ugaitnet_tpu.cli import sweep as j_sweep
from ugaitnet_tpu.cli import train as j_train
from ugaitnet_tpu.train.trainer import experiment_name as j_experiment_name

from ugaitnet_tpu_torch.cli import sweep
from ugaitnet_tpu_torch.obsv.logger import read_metrics

torch.set_num_threads(1)

BASE = ["--synthetic", "--nclasses", "4", "--bs", "8", "--repetitions",
        "2", "--epochs", "1", "--savemodelfreq", "1", "--gschannels",
        "4,4,8", "--gspartdim", "8", "--expandlevel", "1", "--noaugment"]


@pytest.mark.parametrize("specs", [["lr=1e-4,3e-4", "optimizer=adam,sgd"],
                                   ["margin=0.2"], ["bs=8,16", "lr=1e-3"]])
def test_parse_grid_matches_jax(specs):
    assert sweep.parse_grid(specs) == j_sweep.parse_grid(specs)
    for bad in (["lr"], ["lr="]):
        with pytest.raises(SystemExit, match="bad grid spec"):
            sweep.parse_grid(bad)


def test_sweep_points_dirs_and_own_records(tmp_path, capsys):
    root = str(tmp_path / "exp")
    grid = ["lr=1e-3,5e-4", "margin=0.2"]
    points = list(itertools.product(*sweep.parse_grid(grid).values()))
    # a stale record from an earlier run of the first point's config
    first = ["--lr", "1e-3", "--margin", "0.2"]
    jargs = j_train.build_parser().parse_args(
        BASE + first + ["--experdir", root])
    stale_dir = os.path.join(root, j_experiment_name(
        *j_train.configs_from_args(jargs), "sweep_lr1e-3-margin0.2"))
    os.makedirs(stale_dir)
    with open(os.path.join(stale_dir, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"step": 1, "time": 1.0, "stale/x": 9.0,
                            "train/loss": -1.0}) + "\n")

    results = sweep.main(["--grid"] + grid + ["--hparams-dir",
                                              str(tmp_path / "hp"), "--"]
                         + BASE + ["--device", "cpu", "--experdir", root])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("[\n"):]) == results
    assert [r["point"] for r in results] == [
        {"lr": lr, "margin": m} for lr, m in points]
    for r, (lr, m) in zip(results, points):
        flags = ["--lr", lr, "--margin", m]
        jargs = j_train.build_parser().parse_args(
            BASE + flags + ["--experdir", root])
        name = j_experiment_name(*j_train.configs_from_args(jargs),
                                 f"sweep_lr{lr}-margin{m}")
        assert r["experdir"] == os.path.join(root, name)
        assert os.path.isdir(os.path.join(r["experdir"], "ckpt", "1"))
        own = {}
        recs = read_metrics(r["experdir"])
        for rec in recs:
            if rec["time"] > 1.0:
                own.update({k: v for k, v in rec.items()
                            if k not in ("step", "time")})
        assert r["final_metrics"] == own
        assert "stale/x" not in r["final_metrics"]
        assert r["final_metrics"]["train/loss"] > 0
    assert read_metrics(stale_dir)[0]["stale/x"] == 9.0    # kept on disk
    for i in range(len(points)):
        evs = glob.glob(str(tmp_path / "hp" / f"run-{i}" / "**" /
                            "events.out.tfevents.*"), recursive=True)
        assert any(b"_hparams_" in open(e, "rb").read() for e in evs)


def test_hparams_without_tensorboard_goes_on(tmp_path, capsys,
                                             monkeypatch):
    real = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    sweep._log_hparams(str(tmp_path / "hp"), 0, {"lr": "1e-4"},
                       {"loss": 0.5})
    assert "hparams logging unavailable" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "hp")
