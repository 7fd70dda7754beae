"""The port's tensor parallelism (``parallel/tensor.py``) on gloo CPU ranks,
held against its own one-process step and against the JAX package's
``make_tp_train_step`` on the 8-device virtual CPU mesh of
``tests/conftest.py``.

Cases, each from the port's seed-0 init carried to flax by
``utils/weights.py`` (bitwise: ``test_torch_port.py``,
``test_torch_head.py``, ``test_torch_branches.py``, ``test_torch_moe.py``),
one SGD step at lr 3e-4 (``tests/test_tensor_parallel.py``'s optimizer)
on the global batch of 8 of ``test_torch_parallel.py``:
  * the tiny flagship at (dp, mp) = (2, 2), (1, 4) (62 parts indivisible:
    the part projection whole, the classifier's rows split) and (1, 2);
  * casenet C (extra dense 32, postriplet 2, aux heads; dropcode off, since
    the two packages draw their masks differently), the 2D CNN net and the
    MoE flagship (4 experts), each at (1, 2).
The ranks (``tests/torch_ranks.py``: ``tp_steps``) run two worlds, of 4 and
of 2, several cases each; the world of 4 then runs the checkpoint resume,
the world of 2 ``cli.train --tp 2`` (a world costs a spawn).

Tolerances:
  * against the one-process step: losses rtol 1e-5, parameters after the
    step atol 1e-6, and the whole gradient within ONE_PROCESS_REL = 1e-3 of
    its largest entry.  The model group's sums run in another order than
    the one process's, and the batch-all hinge turns rounding into a
    triplet that counts on one side only (measured on one CPU: 1.1e-5 for
    the flagship, 3.0e-4 for the MoE flagship, whose expert choices agree).
    Three planted faults must exceed that limit: no all-reduce after the
    row-parallel convs, an identity backward in place of ``copy_in``, and
    the strip's triplet term summed without its share of the parts.
  * against JAX: JAX's own limits (losses rtol 1e-4, parameters atol
    2e-4), and each gradient leaf within 2e-4 of its largest entry
    (``test_torch_parallel.py``'s rule) where the hinge allows it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import BranchConfig as JBranchConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.parallel import tensor as JTP

import torch_ranks as R
from test_torch_parallel import (batch_arrays, jax_sharded, leaves,
                                 run_ranks, tcfg_of)
from ugaitnet_tpu_torch.cli import train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv.logger import read_metrics
from ugaitnet_tpu_torch.parallel import tensor as TP
from ugaitnet_tpu_torch.parallel.faults import TP_FAULTS
from ugaitnet_tpu_torch.train.train_step import init_state, make_train_step
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

LR = 3e-4
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-6
ONE_PROCESS_REL = 1e-3
JAX_LOSS_RTOL = 1e-4
JAX_PARAM_ATOL = 2e-4
GRAD_REL_ATOL = 2e-4


def _jcfgs():
    flag = graft._flagship_cfg(tiny=True)
    small_2d = dict(filters_numbers=(8, 8, 16, 16), ndense_units=16,
                    dropout=0.0)
    return {
        "flagship": flag,
        "casenet_c": dataclasses.replace(flag, extra_dense=(32,),
                                         postriplet=2, aux_losses=True,
                                         dropout_code=0.0),
        "conv2d": JModelConfig(
            branches=(JBranchConfig(kind="conv2d", modality="of",
                                    **small_2d),
                      JBranchConfig(kind="conv2d", modality="gray",
                                    **small_2d)),
            merge="sign_max", nclasses=74),
        "moe": dataclasses.replace(flag, branches=tuple(
            dataclasses.replace(b, moe_experts=4) for b in flag.branches)),
    }


WORLD4 = (("flagship_2x2", 2, 2, "flagship"),
          ("flagship_1x4", 1, 4, "flagship"))
WORLD2 = (("flagship_1x2", 1, 2, "flagship"),
          ("casenet_c_1x2", 1, 2, "casenet_c"),
          ("conv2d_1x2", 1, 2, "conv2d"),
          ("moe_1x2", 1, 2, "moe"))
CASES = WORLD4 + WORLD2


def _sgd():
    return dict(vars(JTrainConfig(optimizer="sgd", lr=LR)))


def _one_process(mcfg, params, arrays):
    """(metrics, gradient, params after the step) of the port's one-process
    SGD step from the flax params."""
    model = UGaitNet(mcfg, device="cpu", seed=0)
    model.load_state_dict(flax_to_state_dict(params))
    st = init_state(model, tconfig.TrainConfig(**_sgd()))
    _, m = make_train_step(mcfg, tconfig.TrainConfig(**_sgd()))(
        st, R.batch_of(arrays))
    return (R.metrics_of(m), R.grads_flax(st),
            state_dict_to_flax(dict(st.model.named_parameters())))


def _cli_flags(epochs, *extra):
    return ["--synthetic", "--nclasses", "4", "--bs", "8",
            "--repetitions", "2", "--epochs", str(epochs),
            "--savemodelfreq", "1", "--gschannels", "4,4,8",
            "--gspartdim", "8", "--expandlevel", "1", "--noaugment",
            "--mergefun", "sign_max", "--optimizer", "sgd", "--lr",
            "1e-3", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the ranks' (metrics, gradient, params, shard shapes,
    moment shapes), the one-process step's and JAX's (metrics, gradient),
    the initial params; the planted faults' gradients; and each world's
    work dir.  The world of 4 then runs the resume of
    ``test_checkpoint_resumes_whole``, the world of 2 the CLI runs of
    ``test_train_cli_tp_end_to_end``: a world costs a spawn."""
    jcfgs = _jcfgs()
    params = {k: state_dict_to_flax(UGaitNet(tcfg_of(c), device="cpu",
                                             seed=0).state_dict())
              for k, c in jcfgs.items()}
    arrays = batch_arrays()
    ranks, works = {}, {}
    for world, cases, faults in ((4, WORLD4, ()), (2, WORLD2, TP_FAULTS)):
        work = works[world] = tmp_path_factory.mktemp(f"tp{world}")
        R.save(str(work / "in.pt"), {
            "params": {name: params[c] for name, _, _, c in cases},
            "batch": arrays, "tcfg": _sgd()})
        then = (R.tp_resume, (tcfg_of(jcfgs["flagship"]), 2, 2)) \
            if world == 4 else \
            (R.train_cli, tuple(_cli_flags(e, "--tp", "2", "--experdir",
                                           str(work / "cli"))
                                for e in (1, 2)))
        ranks.update(run_ranks(
            work, R.in_turn, world,
            (R.tp_steps, ([(name, dp, mp, tcfg_of(jcfgs[c]))
                           for name, dp, mp, c in cases], faults)),
            then))
    one = {c: _one_process(tcfg_of(jcfgs[c]), params[c], arrays)
           for c in jcfgs}
    jax_out = {}
    for name, dp, mp, c in CASES:
        jax_out[name] = jax_sharded(
            JTP.make_tp_train_step, jcfgs[c], params[c], arrays, None,
            mesh=JTP.make_mesh2d(dp, mp), place=JTP.place_tp_state,
            tcfg=JTrainConfig(**_sgd()))
    return ranks, one, jax_out, params, works


def _whole_grad_err(got, want):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    return (max(np.abs(got[k] - want[k]).max() for k in want)
            / max(np.abs(w).max() for w in want.values()))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_tp_step_equals_one_process(runs, case):
    ranks, one, _, _, _ = runs
    config = dict((n, c) for n, _, _, c in CASES)[case]
    (m1, g1, p1), (mt, gt, pt, _, _) = one[config], ranks[case]
    for k in ("loss", "triplet", "id_ce"):
        np.testing.assert_allclose(mt[k], m1[k], rtol=METRIC_RTOL, err_msg=k)
    got, want = leaves(pt), leaves(p1)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))
    assert _whole_grad_err(gt, g1) <= ONE_PROCESS_REL


@pytest.mark.parametrize("fault", TP_FAULTS)
def test_planted_faults_fail_the_limit(runs, fault):
    ranks, one, _, _, _ = runs
    assert _whole_grad_err(ranks[fault][1], one["flagship"][1]) > \
        ONE_PROCESS_REL


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_tp_step_matches_jax(runs, case):
    ranks, _, jax_out, params, _ = runs
    _, _, mp, config = next(c for c in CASES if c[0] == case)
    (mt, gt, pt, _, _), (jm, jg) = ranks[case], jax_out[case]
    np.testing.assert_allclose(mt["loss"], jm["loss"], rtol=JAX_LOSS_RTOL)
    got, p0 = leaves(pt), leaves(params[config])
    for path, g in jg.items():
        # JAX's SGD step from the same params: p - lr * g (trace of one step)
        np.testing.assert_allclose(got[path], p0[path] - LR * g, rtol=0,
                                   atol=JAX_PARAM_ATOL, err_msg=str(path))
    if mp == 2 and config != "moe":
        mine = leaves(gt)
        for path, g in jg.items():
            np.testing.assert_allclose(mine[path], g, rtol=0,
                                       atol=GRAD_REL_ATOL * np.abs(g).max(),
                                       err_msg=str(path))


def test_shards_follow_leaf_spec(runs):
    """Shard shapes per the JAX ``_leaf_spec``, moments mirroring them."""
    ranks = runs[0]
    _, _, _, s22, mom22 = ranks["flagship_2x2"]
    _, _, _, s14, _ = ranks["flagship_1x4"]
    _, _, _, s2d, _ = ranks["conv2d_1x2"]
    br = "branches.branch_of."
    assert s22[br + "a_conv1.weight"] == (4, 2, 5, 5)     # co split
    assert s22[br + "a_conv2.weight"] == (8, 4, 3, 3)     # ci split
    assert s22[br + "b_conv4.weight"] == (16, 8, 3, 3)
    assert s22[br + "part_proj"] == (31, 16, 16)          # parts split
    assert s22["classprob.weight"] == (74, 31 * 16)       # rows split
    assert s22["classprob.bias"] == (74,)
    assert s14[br + "part_proj"] == (62, 16, 16)          # 62 % 4: whole
    assert s14["classprob.weight"] == (74, 62 * 16 // 4)
    assert s14[br + "a_conv5.weight"] == (4, 8, 3, 3)
    assert s2d["classprob.weight"] == (74, 8)             # 16 rows / 2
    assert s2d["branches.branch_of.conv0.weight"][0] == 8  # conv2d: whole
    for name, shape in s22.items():
        assert mom22[name] == [shape], name                 # SGD's trace


def test_checkpoint_resumes_whole(runs):
    """A whole checkpoint from a TP run: a TP state that loads it takes the
    uninterrupted run's next step bitwise, and a one-process state loads
    it (parameters and Adam moments whole).  Run in the fixture's world of
    4 at (dp, mp) = (2, 2)."""
    work = runs[4][4]
    mcfg = tcfg_of(graft._flagship_cfg(tiny=True))
    straight, resumed, snap = R.load(str(work / "resume.pt"))
    for k, v in straight.items():
        assert torch.equal(v, resumed[k]), k
    one = init_state(UGaitNet(mcfg, device="cpu", seed=3),
                     tconfig.TrainConfig())
    ckpt.restore_checkpoint(str(work / "exp"), 1, one)
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, snap["model"][k]), k
    p = one.model.branches["branch_of"].a_conv1.weight
    assert one.optimizer.state[p]["exp_avg"].shape == (8, 2, 5, 5)
    assert one.step == 1


def test_train_cli_tp_end_to_end(runs, tmp_path):
    """``cli.train --tp 2 --device cpu`` on the fixture's world of 2 CPU
    ranks (the CLI trains on the process group it finds) for one epoch,
    then the same command with two epochs resumes from the TP run's whole
    checkpoint; both epochs' losses against the one-process CLI's
    uninterrupted run, within 1e-3 (``test_torch_trainer_parallel.py``'s
    rule)."""
    (tp, first), (again, second) = R.load(str(runs[4][2] / "cli.pt"))
    assert again == tp and (first, second) == (1, 2)
    one = train.main(_cli_flags(2, "--experdir", str(tmp_path / "one")))
    want = {r["step"]: r["train/loss"] for r in read_metrics(one)
            if "train/loss" in r}
    got = {r["step"]: r["train/loss"] for r in read_metrics(tp)
           if "train/loss" in r}
    assert sorted(got) == [1, 2]
    for e in got:
        np.testing.assert_allclose(got[e], want[e], rtol=1e-3)


def test_leaf_dim_and_mesh_errors():
    assert TP.leaf_dim("branches.branch_of.a_conv3.weight",
                       (16, 8, 3, 3), 2) == 0
    assert TP.leaf_dim("branches.branch_of.a_conv3.weight",
                       (6, 8, 3, 3), 4) is None
    assert TP.leaf_dim("classprob_of.weight", (74, 992), 2) is None
    assert TP.leaf_dim("extra_dense.weight", (32, 16), 2) is None
    with pytest.raises(ValueError, match="'model' axis"):
        TP.make_tp_train_step(None, None, R.S.Mesh(
            shape={"data": 2}, coords={"data": 0}, groups={}, rank=0,
            world=2, device=torch.device("cpu"), backend="gloo"))
