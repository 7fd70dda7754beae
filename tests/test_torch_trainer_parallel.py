"""The port's train CLI and Trainer on several gloo CPU ranks: ``--ndevices
2`` and ``--sp 2`` (``--ep 2 --moe 4``, with this file's helpers:
``tests/test_torch_trainer_expert_parallel.py``) against the JAX train CLI
with the same flags on its 8-device virtual CPU mesh, and the mode flags'
errors (resume across world sizes: ``tests/test_torch_resume_parallel.py``).

Both CLIs train the tiny two-branch config on the same synthetic set with
``--noaugment --expandlevel 1`` (no random draws), SGD (linear in the
gradient, so rounding cannot flip Adam's first-step signs) and the same
initial weights (``--initnet`` of a port and a JAX experiment holding them
through the weight bridge), the JAX ``pairwise_dist`` diagonal zeroed as
``tests/test_torch_trainer.py`` explains.

Tolerances: per-epoch train and validation losses within 1e-3 relative
(the joint-CLI rule of ``tests/test_torch_joint.py``: validation's
triplet may count a hinge within rounding of 0 on one side only), at lr
1e-3.  At lr 1e-2 the one-process port and JAX CLIs themselves part by
0.9 % at epoch 2 on this config, with and without ranks:
``tests/test_torch_cli_drift.py`` shows that the two steps compute one
function and that the parting follows a ``sign_max`` pick which the two
runs' rounding-level parameter differences switch (ROADMAP.md section 3).

Each mode's CLI run is repeated with the gradients summed over the ranks
instead of averaged ("no world factor", planted in every rank), and must
part from the correct run by over 10 x CLI_RTOL (measured on one CPU:
epoch 2's train loss by 2.8e-2 to 9.7e-2).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.cli import train as j_train
from ugaitnet_tpu.core import checkpoint as jckpt
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import train_step as J

import torch_ranks as R
from test_torch_parallel import _exact_diagonal_dist
from ugaitnet_tpu_torch.cli import train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv.logger import read_metrics
from ugaitnet_tpu_torch.parallel import sharding as S
from ugaitnet_tpu_torch.train.train_step import init_state
from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax

torch.set_num_threads(1)

CLI_RTOL = 1e-3
FLAGS = ["--synthetic", "--nclasses", "4", "--bs", "8", "--repetitions", "2",
         "--epochs", "2", "--savemodelfreq", "1", "--gschannels", "8,8,16",
         "--gspartdim", "16", "--expandlevel", "1", "--noaugment",
         "--mergefun", "sign_max", "--optimizer", "sgd", "--lr", "1e-3",
         "--valperc", "0.3", "--initepoch", "1"]
MODES = {"dp2": ["--ndevices", "2"], "sp2": ["--sp", "2"],
         "ep2": ["--ep", "2", "--moe", "4"]}


def _init_experiments(root, extra):
    """The same initial weights as a port and as a JAX experiment."""
    port, jexp = str(root / "init_port"), str(root / "init_jax")
    mcfg, _, _ = train.configs_from_args(train.build_parser().parse_args(
        FLAGS + extra))
    model = UGaitNet(mcfg, device="cpu", seed=11)
    ckpt.save_checkpoint(port, 1, init_state(model, tconfig.TrainConfig()))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    state_dict_to_flax(model.state_dict()))
    tx = J.make_optimizer(JTrainConfig())
    jckpt.save_checkpoint(jexp, 1, J.TrainState(
        step=jnp.int32(0), params=params, opt_state=tx.init(params)))
    return port, jexp


def _by_epoch(experdir):
    out = {}
    for r in read_metrics(experdir):
        for k, v in r.items():
            if k not in ("step", "time"):
                out.setdefault(k, {})[int(r["step"])] = v
    return out


def run_clis(mode, tmp_path_factory):
    """(mode, port experiment, JAX experiment, the port's initial
    experiment) of both CLIs in ``mode``."""
    flags = MODES[mode]
    root = tmp_path_factory.mktemp(mode)
    port_init, jax_init = _init_experiments(root, flags)
    exp = train.main(FLAGS + flags + ["--initnet", port_init, "--device",
                                      "cpu", "--experdir", str(root / "port")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UGAITNET_CACHE_DIR", str(root / "jax_cache"))
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        jexp = j_train.main(FLAGS + flags + [
            "--initnet", jax_init, "--experdir", str(root / "jax")])
    return mode, exp, jexp, port_init


def check_epoch_losses(mode, exp, jexp, port_init):
    got, want = _by_epoch(exp), _by_epoch(jexp)
    # the JAX per-shard (SP) step reports no triplet term
    keys = [k for k in ("train/loss", "train/triplet", "train/id_ce",
                        "train/moe_aux", "val/loss") if k in want]
    assert ("train/moe_aux" in keys) == (mode == "ep2")
    for k in keys:
        assert sorted(got[k]) == sorted(want[k]) == [1, 2], k
        for e in (1, 2):
            np.testing.assert_allclose(got[k][e], want[k][e], rtol=CLI_RTOL,
                                       err_msg=f"{mode} {k} epoch {e}")
    # rank 0 alone writes: one record per epoch and prefix
    assert len(read_metrics(exp)) == 4
    assert ckpt.latest_checkpoint_step(exp) == 2
    assert ckpt.has_best_checkpoint(exp)
    if mode == "ep2":
        # the checkpoint holds the whole expert_proj and its moments
        raw = ckpt.restore_raw(exp, 2)
        assert tuple(raw["model"]["branches.branch_of.expert_proj"].shape) \
            == (4, 16, 16)


def check_world_factor_fault(mode, exp, jexp, port_init, tmp_path):
    argv = FLAGS + MODES[mode] + ["--initnet", port_init, "--device", "cpu",
                                  "--experdir", str(tmp_path / "fault")]
    S.spawn(R.cli_with_fault, 2, args=(argv, "no world factor"),
            devices=["cpu", "cpu"], init_file=str(tmp_path / "rdzv"),
            threads=1)
    (fault,) = glob.glob(str(tmp_path / "fault" / "*"))
    got, want = _by_epoch(fault)["train/loss"], _by_epoch(exp)["train/loss"]
    parted = max(abs(got[e] / want[e] - 1) for e in (1, 2))
    assert parted > 10 * CLI_RTOL, f"{mode}: the fault parts by {parted:.2e}"


# ep2 runs in tests/test_torch_trainer_expert_parallel.py
@pytest.fixture(scope="module", params=["dp2", "sp2"])
def cli_runs(request, tmp_path_factory):
    return run_clis(request.param, tmp_path_factory)


def test_cli_epoch_losses_match_jax(cli_runs):
    check_epoch_losses(*cli_runs)


def test_cli_world_factor_fault_fails(cli_runs, tmp_path):
    check_world_factor_fault(*cli_runs, tmp_path)


@pytest.mark.parametrize("flags,match", [
    (["--sp", "2", "--ep", "2", "--moe", "4"], "exclusive"),
    (["--tp", "2", "--sp", "2"], "exclusive"),
    (["--pp", "2", "--ndevices", "2"], "--pp is exclusive"),
    (["--ep", "2"], "--ep requires --moe")])
def test_exclusive_modes_exit(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        train.main(FLAGS + flags + ["--device", "cpu",
                                    "--experdir", str(tmp_path)])


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_unported_modes_name_the_roadmap(tmp_path, flag):
    """--tp and --pp (ported: test_torch_tensor_parallel.py,
    test_torch_pipeline.py) take a card per rank or device unless the CPU
    is asked for, and refuse more than the host has."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(ValueError, match="2-device mesh"):
        train.main(FLAGS + [flag, "2", "--experdir", str(tmp_path)])


def test_more_ranks_than_cards_raise(tmp_path):
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(ValueError, match="2-device mesh"):
        train.main(FLAGS + ["--ndevices", "2", "--experdir",
                            str(tmp_path)])
    assert not os.listdir(tmp_path)       # nothing started
