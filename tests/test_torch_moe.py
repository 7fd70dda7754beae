"""The MoE part projection (``ops/moe.py``, the GaitSet branch's ``router``
and ``expert_proj``) and expert parallelism (``parallel/expert.py``) of the
port, held against the JAX package on the CPU.

Routing and capacity against ``ugaitnet_tpu/ops/moe.py`` and against a
naive per-token loop; the weight bridge bitwise; the tiny flagship with 4
experts per branch through one train step against the JAX
``compute_losses`` (aux term included, gradient reaching the router); the
expert-parallel step on gloo CPU ranks against ``make_ep_train_step`` on
the 8-device virtual mesh at (dp, ep) = (1, 2) and (2, 2), where the data
ranks route their tokens as one global set; the per-shard form's locally
routed, mean-reduced aux against ``make_shardmap_train_step``.

Tolerances: routing outputs rtol 1e-5 / atol 1e-6 (float32 router math in
two frameworks), the ``kept`` mask exact; losses rtol 1e-5 and gradients
per leaf 2e-4 x the leaf's largest |grad| (``tests/test_torch_train.py``'s
rules; the JAX ``pairwise_dist`` diagonal zeroed as there).
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
from ugaitnet_tpu.ops import moe as JM
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.parallel import expert as JE
from ugaitnet_tpu.parallel import sharding as JS
from ugaitnet_tpu.train import train_step as J

import torch_ranks as R
from test_torch_parallel import (_exact_diagonal_dist, batch_arrays,
                                 check_grads, check_metrics, jax_batch,
                                 jax_sharded, leaves, np_tree, run_ranks,
                                 tcfg_of)
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.ops import moe as TM
from ugaitnet_tpu_torch.parallel import expert as TE
from ugaitnet_tpu_torch.train import train_step as T

torch.set_num_threads(1)

ROUTE_RTOL, ROUTE_ATOL = 1e-5, 1e-6


def moe_cfg(experts=4):
    cfg = graft._flagship_cfg(tiny=True)
    return dataclasses.replace(cfg, branches=tuple(
        dataclasses.replace(b, moe_experts=experts) for b in cfg.branches))


@pytest.fixture(scope="module")
def moe_params():
    return np_tree(init_params(JNet(moe_cfg()), jax.random.PRNGKey(0),
                               batch=2))


@pytest.mark.parametrize("n,e,cf", [(100, 4, 1.25), (4, 8, 1.0),
                                    (496, 4, 1.25), (7440, 4, 1.25),
                                    (12, 2, 0.5)])
def test_moe_capacity_matches_jax(n, e, cf):
    assert TM.moe_capacity(n, e, cf) == JM.moe_capacity(n, e, cf)


def _naive(x, rw, ew, cap):
    """Per-token top-1 routing, first come first served."""
    logits = x.astype(np.float64) @ rw
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    used = np.zeros(rw.shape[1], int)
    out = np.zeros((x.shape[0], ew.shape[2]))
    for i in range(x.shape[0]):
        e = int(np.argmax(probs[i]))
        used[e] += 1
        if used[e] <= cap:
            out[i] = probs[i, e] * (x[i] @ ew[e])
    return out


@pytest.mark.parametrize("cap", [24, 5], ids=["all kept", "overflow"])
def test_moe_project_matches_jax_and_a_loop(cap):
    rng = np.random.RandomState(0)
    n, c, d, e = 24, 8, 5, 4
    x = rng.randn(n, c).astype(np.float32)
    rw = rng.randn(c, e).astype(np.float32)
    ew = rng.randn(e, c, d).astype(np.float32)
    want = [np.asarray(v) for v in JM.moe_project(
        jnp.asarray(x), jnp.asarray(rw), jnp.asarray(ew), cap)]
    got = [v.numpy() for v in TM.moe_project(
        torch.from_numpy(x), torch.from_numpy(rw), torch.from_numpy(ew),
        cap)]
    np.testing.assert_allclose(got[0], want[0], rtol=ROUTE_RTOL,
                               atol=ROUTE_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=ROUTE_RTOL)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], _naive(x, rw, ew, cap),
                               rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    assert (got[2].sum() < n) == (cap < n)


def test_moe_capacity_drops_overflow_in_token_order():
    n, c, d, e = 12, 4, 3, 2
    x = torch.ones((n, c))
    rw = torch.zeros((c, e))
    rw[:, 1] = 10.0                # every token to expert 1
    out, aux, kept = TM.moe_project(x, rw, torch.ones((e, c, d)), 5)
    assert kept.sum() == 5 and kept[:5].all()
    assert (out[5:] == 0).all() and out[:5].abs().sum() > 0
    assert float(aux) == pytest.approx(e * 1.0, abs=1e-3)


def test_bridge_carries_router_and_experts_bitwise(moe_params):
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                                  state_dict_to_flax)
    model = UGaitNet(tcfg_of(moe_cfg()), device="cpu")
    model.load_state_dict(flax_to_state_dict(moe_params))
    sd = model.state_dict()
    assert tuple(sd["branches.branch_of.router"].shape) == (16, 4)
    assert tuple(sd["branches.branch_gray.expert_proj"].shape) == (4, 16, 16)
    assert "branches.branch_of.part_proj" not in sd
    want, got = leaves(moe_params), leaves(state_dict_to_flax(sd))
    assert set(want) == set(got)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and np.array_equal(got[path], w)


def test_moe_train_step_matches_jax(moe_params):
    """One step's losses (aux term included) and gradients of the tiny
    flagship with 4 experts, one process each."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict
    jcfg, jtcfg = moe_cfg(), JTrainConfig()
    arrays = batch_arrays()
    jmodel = JNet(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        (_, jm), jg = jax.value_and_grad(
            lambda p: J.compute_losses(jmodel, p, jax_batch(arrays),
                                       jax.random.PRNGKey(0), jcfg, jtcfg,
                                       train=True), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, moe_params))
    model = UGaitNet(tcfg_of(jcfg), device="cpu")
    model.load_state_dict(flax_to_state_dict(moe_params))
    total, tm = T.compute_losses(model, R.batch_of(arrays), tcfg_of(jcfg),
                                 tconfig.TrainConfig(**vars(jtcfg)))
    total.backward()
    check_metrics(R.metrics_of(tm), {k: float(v) for k, v in jm.items()},
                  keys=("loss", "triplet", "id_ce", "moe_aux"))
    assert float(tm["moe_aux"]) >= 2.0 - 1e-6      # two branches, each >= 1
    grads = R.grads_flax(T.TrainState(model, None))
    check_grads(grads, leaves(np_tree(jg)))
    for b in ("branch_of", "branch_gray"):
        assert np.abs(grads["params"][b]["router"]).max() > 0


@pytest.fixture(scope="module")
def ep_runs(moe_params, tmp_path_factory):
    out = {}
    arrays = batch_arrays()
    for dp, ep in ((1, 2), (2, 2)):
        work = tmp_path_factory.mktemp(f"ep{dp}{ep}")
        R.save(str(work / "in.pt"), {
            "params": moe_params, "batch": arrays,
            "mcfg": tcfg_of(moe_cfg()),
            "tcfg": dict(vars(JTrainConfig()))})
        port = run_ranks(work, R.ep_steps, dp * ep, dp, ep)
        mesh = JE.make_mesh_dpep(dp, ep)
        want = jax_sharded(JE.make_ep_train_step, moe_cfg(), moe_params,
                           arrays, dp * ep, mesh=mesh,
                           place=JE.place_ep_state)
        out[(dp, ep)] = port, want
    return out


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["dp1ep2", "dp2ep2"])
def test_ep_step_matches_jax(ep_runs, mesh):
    """At dp = 2 the data ranks route one global token set (capacity of
    the global count, queue positions across ranks, global f and p)."""
    (pm, pg, shard), (jm, jg) = ep_runs[mesh]
    assert shard == 2                       # each rank holds 2 of 4 experts
    check_metrics(pm, jm, keys=("loss", "triplet", "id_ce", "moe_aux"))
    check_grads(pg, jg)


def test_per_shard_moe_aux_matches_jax(moe_params, tmp_path):
    """The per-shard form routes locally and mean-reduces the aux term, as
    ``make_shardmap_train_step`` does."""
    arrays = batch_arrays()
    R.save(str(tmp_path / "in.pt"), {"params": moe_params, "batch": arrays,
                                     "tcfg": dict(vars(JTrainConfig()))})
    port = run_ranks(tmp_path, R.form_steps, 2, 2,
                     [("shard", tcfg_of(moe_cfg()), "shard")])
    pm, pg = port["shard"]
    jm, jg = jax_sharded(JS.make_shardmap_train_step, moe_cfg(), moe_params,
                         arrays, 2)
    check_metrics(pm, jm, keys=("loss", "id_ce", "moe_aux"))
    check_grads(pg, jg)


def test_ep_requires_moe():
    cfg = tcfg_of(graft._flagship_cfg(tiny=True))
    with pytest.raises(ValueError, match="moe_experts > 0"):
        TE.make_ep_train_step(cfg, tconfig.TrainConfig(), None)


def test_int8_encode_refuses_moe():
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.quantize import quantize_model_params
    cfg = tcfg_of(moe_cfg())
    with pytest.raises(ValueError, match="MoE"):
        quantize_model_params(UGaitNet(cfg, device="cpu"), cfg, [None, None])
