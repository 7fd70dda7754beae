"""The port's flagship train step against ``make_train_step_fn`` of the JAX
package, on the CPU, at the tiny flagship (channels (8, 8, 16), part_dim 16)
with B = 12 (labels 3 x 4), batch-all triplet + softmax CE and Adam.

The port sets the distance diagonal to its exact value 0; the JAX formula
leaves a float32 rounding residue there (~1e-3 after the sqrt on these
batch-normalized signatures), which flips a == p triplets whose negative
sits within 1e-3 of the margin.  Each flip moves single gradient entries by
1/count (the JAX step's triplet gradient is 3.8e-2 of its largest entry
away from a float64 reference on the first batch, the port's 6e-5).  So
the trajectory tests run the JAX step with its ``pairwise_dist`` diagonal
zeroed.  ``test_unpatched_reference_losses`` and
``test_unpatched_reference_gradients`` hold the port to the JAX step as it
is, and pin that divergence (ROADMAP.md section 3).

Tolerances:
  * losses and metrics: rtol 1e-5 (float32 forwards in two frameworks,
    measured agreement ~2e-7).
  * gradients, taken at the same params: atol 2e-4 x the leaf's largest
    |grad| (float32 conv backward sums in another order; measured <= 7e-5).
  * parameters where |grad| is clearly nonzero: 2e-7 after one step; 0.1 x
    lr after three, whose later gradients are taken at params that drifted
    apart on near-zero gradients (measured 1.9e-6).  Elsewhere 2 x lr per
    step + 1e-7: Adam's first step moves a weight by about lr * sign(g), so
    a gradient that rounds across 0 moves it by 2 x lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import train_step as J

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.train import train_step as T
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
GRAD_REL_ATOL = 2e-4
LR = JTrainConfig().lr
PARAM_ATOL = {0: 2e-7, 2: 0.1 * LR}


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def _batch(step):
    rng = np.random.RandomState(100 + step)
    b = 12
    of = rng.randn(b, 25, 60, 60, 2).astype(np.float32)
    gray = rng.randn(b, 25, 60, 60, 1).astype(np.float32)
    flags = [np.ones(b, np.float32), np.ones(b, np.float32)]
    flags[0][[1, 6]] = 0.0         # exercise the gate on both branches
    flags[1][[4]] = 0.0
    gray[4] = 1e-9
    of[[1, 6]] = 1e-9
    labels = np.repeat(np.arange(3), 4).astype(np.int32)
    jb = J.Batch(volumes=(jnp.asarray(of), jnp.asarray(gray)),
                 use_flags=tuple(jnp.asarray(f) for f in flags),
                 labels=jnp.asarray(labels))
    tb = T.Batch(volumes=(torch.from_numpy(of), torch.from_numpy(gray)),
                 use_flags=tuple(torch.from_numpy(f) for f in flags),
                 labels=torch.from_numpy(labels))
    return jb, tb


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


_JAX_PAIRWISE = JT.pairwise_dist


def _exact_diagonal_dist(x, squared=False):
    d = _JAX_PAIRWISE(x, squared)
    return jnp.where(jnp.eye(d.shape[-1], dtype=bool), 0.0, d)


@pytest.fixture(scope="module")
def runs():
    """Three steps of both packages from the same initial params."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        return _three_steps()


def _three_steps():
    mcfg = graft._flagship_cfg(tiny=True)
    jtcfg = JTrainConfig()
    jmodel = JNet(mcfg)
    tx = J.make_optimizer(jtcfg)
    jstate = J.init_state(jmodel, tx, jax.random.PRNGKey(0))
    jstep = jax.jit(J.make_train_step_fn(jmodel, tx, mcfg, jtcfg))

    def jgrad(params, batch):
        return jax.grad(lambda p: J.compute_losses(
            jmodel, p, batch, jax.random.PRNGKey(0), mcfg, jtcfg,
            train=True)[0])(params)

    tmcfg = _tcfg(mcfg)
    ttcfg = tconfig.TrainConfig(**vars(jtcfg))
    tmodel = UGaitNet(tmcfg, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    tstate = T.init_state(tmodel, ttcfg)
    tstep = T.make_train_step(tmcfg, ttcfg)

    # the port's gradient at the JAX step's own params, so a trajectory
    # that drifted apart by 2 x lr on a near-zero gradient does not move it
    probe = UGaitNet(tmcfg, device="cpu")

    def tgrad(params, batch):
        probe.load_state_dict(flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params)))
        probe.zero_grad(set_to_none=True)
        T.compute_losses(probe, batch, tmcfg, ttcfg)[0].backward()
        return _leaves(state_dict_to_flax(
            {k: p.grad for k, p in probe.named_parameters()}))

    out = []
    for s in range(3):
        jb, tb = _batch(s)
        grads = _leaves(jgrad(jstate.params, jb))
        tgrads = tgrad(jstate.params, tb)
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, tb)
        out.append(dict(
            jm={k: float(v) for k, v in jm.items()},
            tm={k: float(v) for k, v in tm.items()},
            grads=grads, tgrads=tgrads,
            jparams=_leaves(jstate.params),
            tparams=_leaves(state_dict_to_flax(tmodel.state_dict()))))
    return out


@pytest.mark.parametrize("step", [0, 2])
def test_metrics_match(runs, step):
    jm, tm = runs[step]["jm"], runs[step]["tm"]
    assert set(tm) == set(jm) == {"triplet", "id_ce", "acc", "reg", "loss"}
    assert tm["triplet"] > 0
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("step", [0, 2])
def test_gradients_match(runs, step):
    grads, tgrads = runs[step]["grads"], runs[step]["tgrads"]
    assert set(grads) == set(tgrads)
    for path, g in grads.items():
        scale = np.abs(g).max()
        assert scale > 0, path
        np.testing.assert_allclose(tgrads[path], g, rtol=0,
                                   atol=GRAD_REL_ATOL * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("step", [0, 2])
def test_params_after_steps_match(runs, step):
    jp, tp = runs[step]["jparams"], runs[step]["tparams"]
    n_clear = n_all = 0
    for path, want in jp.items():
        # clearly nonzero in every step so far: no sign flip across 0
        clear = np.ones(want.shape, bool)
        for r in runs[: step + 1]:
            g = r["grads"][path]
            clear &= np.abs(g) > 100 * GRAD_REL_ATOL * np.abs(g).max()
        diff = np.abs(tp[path] - want)
        assert diff[clear].max(initial=0) <= PARAM_ATOL[step], path
        assert diff.max() <= 2 * LR * (step + 1) + 1e-7, path
        n_clear += clear.sum()
        n_all += clear.size
    assert n_clear > 0.25 * n_all, (n_clear, n_all)


def test_eval_step_and_plain_triplet_agree(runs):
    """make_eval_step with the plain triplet gives the train step's loss
    for unchanged params."""
    mcfg = _tcfg(graft._flagship_cfg(tiny=True))
    tcfg = tconfig.TrainConfig(triplet_kind="batch_all_xla")
    model = UGaitNet(mcfg, device="cpu", seed=3)
    _, tb = _batch(0)
    m1 = T.make_eval_step(mcfg, tcfg)(model, tb)
    m2 = T.make_eval_step(mcfg, dataclasses.replace(
        tcfg, triplet_kind="batch_all"))(model, tb)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    with pytest.raises(ValueError, match="unknown optimizer"):
        T.make_optimizer(dataclasses.replace(tcfg, optimizer="rmsprop"),
                         model.parameters())


def test_unpatched_reference_losses():
    """The JAX eval step as it is (XLA triplet, diagonal residue and all)
    against the port at the same params: the residue moves the triplet value
    by ~t/count per flipped a == p triplet and by the residue itself on the
    active ones (measured 7.6e-5 relative), hence rtol 2e-4 there."""
    mcfg = graft._flagship_cfg(tiny=True)
    jtcfg = JTrainConfig()
    jmodel = JNet(mcfg)
    params = init_params(jmodel, jax.random.PRNGKey(0), batch=2)
    jb, tb = _batch(0)
    jm = J.make_eval_step(jmodel, mcfg, jtcfg)(params, jb)
    tmcfg = _tcfg(mcfg)
    tmodel = UGaitNet(tmcfg, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    tm = T.make_eval_step(tmcfg, tconfig.TrainConfig(**vars(jtcfg)))(
        tmodel, tb)
    for k in ("triplet", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4)
    for k in ("id_ce", "acc", "reg"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7)


# the unpatched JAX gradient at the initial params: the diagonal residue's
# flips move a leaf's gradient by up to 8.3e-3 of its largest entry on
# batch 0 (branch_of part_proj) and 5.5e-3 on batch 2; the patched JAX
# step agrees to GRAD_REL_ATOL (test_gradients_match)
UNPATCHED_GRAD_REL = 2e-2


@pytest.mark.parametrize("step", [0, 2])
def test_unpatched_reference_gradients(step):
    mcfg = graft._flagship_cfg(tiny=True)
    jtcfg = JTrainConfig()
    jmodel = JNet(mcfg)
    params = init_params(jmodel, jax.random.PRNGKey(0), batch=2)
    jb, tb = _batch(step)
    grads = _leaves(jax.jit(jax.grad(lambda p: J.compute_losses(
        jmodel, p, jb, jax.random.PRNGKey(0), mcfg, jtcfg,
        train=True)[0]))(params))
    tmcfg = _tcfg(mcfg)
    tmodel = UGaitNet(tmcfg, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    T.compute_losses(tmodel, tb, tmcfg,
                     tconfig.TrainConfig(**vars(jtcfg)))[0].backward()
    tgrads = _leaves(state_dict_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}))
    assert set(grads) == set(tgrads)
    for path, g in grads.items():
        np.testing.assert_allclose(
            tgrads[path], g, rtol=0,
            atol=UNPATCHED_GRAD_REL * np.abs(g).max(), err_msg=str(path))
