"""The port's pipeline (branch-placement) parallelism
(``parallel/pipeline.py``) and ``models/network.py:UGaitHead``, on the CPU,
mirroring ``tests/test_pipeline.py``: the head alone against the net's
head and the JAX ``UGaitHead``, ``split_params``, the step against the
port's one-process step and the JAX ``make_pipeline_train_step`` (on two
devices of the virtual CPU mesh), the refusals and ``cli.train --pp``.

The config is the JAX test's (the tiny two-branch GaitSet net, 6 classes,
extra dense 32 with its dropcode), weights from the JAX init through
``utils/weights.py``, the batch of ``test_torch_parallel.py``.  The JAX
step runs with its ``pairwise_dist`` diagonal zeroed and a grads-capturing
optimizer, as ``test_torch_parallel.py`` does; dropcode is off for it,
since the two packages draw their masks differently, and on against the
port's one-process step.

Tolerances: the head against the net's, bitwise (the same layers on the
same embeddings); against JAX the forward tolerance of
``tests/test_torch_head.py`` (rtol 1e-4, atol 1e-5).  The step against the
port's one-process step: bitwise on one CPU (the same ops on the same
device; the branch on the second device slot trains a copy whose
gradient is added to the masters), and a planted fault (that gradient
dropped) must not be.  Against JAX: losses rtol 1e-5, each gradient leaf
within 2e-4 of its largest entry (``test_torch_parallel.py``'s rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.core.config import BranchConfig as JBranchConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.models import network as JN
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.parallel import pipeline as JP
from ugaitnet_tpu.train import train_step as J

import torch_ranks as R
from test_torch_parallel import (_exact_diagonal_dist, batch_arrays,
                                 check_grads, grad_capture, jax_batch,
                                 leaves, np_tree, tcfg_of)
from ugaitnet_tpu_torch.cli import train
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitHead, UGaitNet
from ugaitnet_tpu_torch.obsv.logger import read_metrics
from ugaitnet_tpu_torch.parallel import pipeline as P
from ugaitnet_tpu_torch.train.train_step import make_train_step
from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
METRIC_RTOL = 1e-5


def _jcfg(dropout_code=0.4):
    b = JBranchConfig(kind="gaitset", modality="gray",
                      gaitset_channels=(8, 8, 16), part_dim=16)
    b2 = JBranchConfig(kind="gaitset", modality="of",
                       gaitset_channels=(8, 8, 16), part_dim=16)
    return JModelConfig(branches=(b2, b), merge="sign_max", nclasses=6,
                        extra_dense=(32,), dropout_code=dropout_code)


@pytest.fixture(scope="module")
def setup():
    arrays = batch_arrays(nclasses=6)
    params = {d: np_tree(JN.init_params(JN.UGaitNet(_jcfg(d)),
                                        jax.random.PRNGKey(0), batch=2))
              for d in (0.0, 0.4)}
    return arrays, params


def _net(mcfg, params):
    model = UGaitNet(mcfg, device="cpu", seed=0)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def test_head_matches_net_head_and_jax(setup):
    arrays, params = setup
    jcfg = _jcfg(0.0)
    mcfg = tcfg_of(jcfg)
    net = _net(mcfg, params[0.0])
    batch = R.batch_of(arrays)
    with torch.no_grad():
        full = net(list(batch.volumes), list(batch.use_flags), train=False)
        embs = [net.branches[f"branch_{b.modality}"](v, False)
                for b, v in zip(mcfg.branches, batch.volumes)]
        head = UGaitHead(net)
        out = head(embs, list(batch.use_flags), train=False)
    for k in ("signature", "code", "flatten", "classprob_logits"):
        assert torch.equal(out[k], full[k]), k
    # the head's parameters are the net's, under the same names
    hsd = head.state_dict()
    nsd = net.state_dict()
    assert hsd and all(v is nsd[k] or torch.equal(v, nsd[k])
                       for k, v in hsd.items())
    # the JAX UGaitHead on the same embeddings
    _, hsub = JP.split_params(params[0.0], jcfg)
    jout = JN.UGaitHead(jcfg).apply(
        {"params": hsub}, [jnp.asarray(e.numpy()) for e in embs],
        [jnp.asarray(f) for f in arrays["flags"]], train=False)
    for k in ("signature", "code", "classprob_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=k)


def test_split_params_disjoint_and_complete(setup):
    arrays, params = setup
    net = _net(tcfg_of(_jcfg()), params[0.4])
    sd = net.state_dict()
    bsub, hsub = P.split_params(sd, net.config)
    assert len(hsub) + sum(len(b) for b in bsub) == len(sd)
    assert "classprob.weight" in hsub and "extra_dense.weight" in hsub
    for b in bsub:
        assert "part_proj" in b and not set(b) & set(hsub)
    joined = dict(hsub)
    for b, key in zip(bsub, ("branch_of", "branch_gray")):
        joined.update({f"branches.{key}.{k}": v for k, v in b.items()})
    assert joined.keys() == sd.keys()


def _steps(mcfg, params, arrays, fault=False):
    """(one-process, pipeline) SGD-at-lr-0 steps from the same weights:
    each (metrics, gradient as a flax tree)."""
    out = []
    for pipeline in (False, True):
        st = R.probe_state(mcfg, params)
        if pipeline:
            step = P.make_pipeline_train_step(
                st.model, st.optimizer, mcfg, tconfig.TrainConfig(),
                ["cpu", "cpu"])
        else:
            step = make_train_step(mcfg, tconfig.TrainConfig())
        if pipeline and fault:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(P, "add_branch_grads", lambda *a: None)
                _, m = step(st, R.batch_of(arrays))
        else:
            _, m = step(st, R.batch_of(arrays))
        for p in st.model.parameters():        # a dropped gradient: 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        out.append((R.metrics_of(m), R.grads_flax(st)))
    return out


def test_pipeline_step_equals_one_process(setup):
    arrays, params = setup
    mcfg = tcfg_of(_jcfg(0.4))
    (m1, g1), (mp, gp) = _steps(mcfg, params[0.4], arrays)
    assert m1 == mp
    flat1, flatp = (jax.tree_util.tree_leaves(g) for g in (g1, gp))
    assert all(np.array_equal(a, b) for a, b in zip(flat1, flatp))
    # the planted fault: the second slot's branch gradient dropped
    (_, g1), (_, gf) = _steps(mcfg, params[0.4], arrays, fault=True)
    got, want = (g["params"]["branch_gray"]["part_proj"] for g in (gf, g1))
    assert np.abs(got).max() == 0.0 and np.abs(want).max() > 0.0


def test_pipeline_step_matches_jax(setup):
    arrays, params = setup
    jcfg = _jcfg(0.0)
    (_, _), (mp, gp) = _steps(tcfg_of(jcfg), params[0.0], arrays)
    tx = grad_capture()
    p = jax.tree_util.tree_map(jnp.asarray, params[0.0])
    state = J.TrainState(step=jnp.int32(0), params=p, opt_state=tx.init(p))
    step = JP.make_pipeline_train_step(JN.UGaitNet(jcfg), tx, jcfg,
                                       JTrainConfig(),
                                       devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        state, jm = step(state, jax_batch(arrays), jax.random.PRNGKey(1))
    for k in ("loss", "triplet", "id_ce"):
        np.testing.assert_allclose(mp[k], float(jm[k]), rtol=METRIC_RTOL,
                                   err_msg=k)
    check_grads(gp, leaves(jax.device_get(state.opt_state)))


def test_pipeline_refusals(setup):
    arrays, params = setup
    mcfg = tcfg_of(_jcfg())
    st = R.probe_state(mcfg, params[0.4])
    with pytest.raises(ValueError, match=">= 2 devices"):
        P.make_pipeline_train_step(st.model, st.optimizer, mcfg,
                                   tconfig.TrainConfig(), ["cpu"])
    b2d = tconfig.BranchConfig(kind="conv2d", modality="gray", dropout=0.4)
    mcfg2 = dataclasses.replace(mcfg, branches=(mcfg.branches[0], b2d))
    with pytest.raises(ValueError, match="dropout"):
        P.make_pipeline_train_step(st.model, st.optimizer, mcfg2,
                                   tconfig.TrainConfig(), ["cpu", "cpu"])
    moe = dataclasses.replace(mcfg, branches=tuple(
        dataclasses.replace(b, moe_experts=4) for b in mcfg.branches))
    with pytest.raises(ValueError, match="MoE"):
        P.make_pipeline_train_step(st.model, st.optimizer, moe,
                                   tconfig.TrainConfig(), ["cpu", "cpu"])
    step = P.make_pipeline_train_step(st.model, st.optimizer, mcfg,
                                      tconfig.TrainConfig(), ["cpu", "cpu"])
    other = R.probe_state(mcfg, params[0.4])
    with pytest.raises(ValueError, match="not the ones"):
        step(other, R.batch_of(arrays))


def test_train_cli_pp(tmp_path):
    """``cli.train --pp 2 --device cpu`` equals the one-process CLI, epoch
    by epoch; --pp is exclusive with the mesh flags, and on cards needs
    as many as it names."""
    def flags(*extra):
        return ["--synthetic", "--nclasses", "4", "--bs", "8",
                "--repetitions", "2", "--epochs", "2", "--savemodelfreq",
                "1", "--gschannels", "4,4,8", "--gspartdim", "8",
                "--expandlevel", "1", "--noaugment", "--mergefun",
                "sign_max", "--optimizer", "sgd", "--lr", "1e-3",
                "--valperc", "0", *extra]
    one = train.main(flags("--device", "cpu", "--experdir",
                           str(tmp_path / "one")))
    pp = train.main(flags("--device", "cpu", "--pp", "2", "--experdir",
                          str(tmp_path / "pp")))
    want = [r["train/loss"] for r in read_metrics(one) if "train/loss" in r]
    got = [r["train/loss"] for r in read_metrics(pp) if "train/loss" in r]
    assert len(got) == 2 and got == want
    with pytest.raises(SystemExit, match="exclusive"):
        train.main(flags("--pp", "2", "--tp", "2", "--experdir",
                         str(tmp_path / "x")))
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="2-device mesh"):
            train.main(flags("--pp", "2", "--experdir", str(tmp_path / "y")))
