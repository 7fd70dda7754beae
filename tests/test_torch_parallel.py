"""The port's data-parallel training (``parallel/sharding.py``) on gloo CPU
ranks, held against the JAX package's sharded steps on the 8-device
virtual CPU mesh of ``tests/conftest.py``, and against its own
one-process step.

The tiny flagship (channels (8, 8, 16), part_dim 16) with weights from
the JAX init carried by ``utils/weights.py``; a global batch of 8 made
from a numpy seed.  The port's ranks (2 or 4 spawned processes, one torch
thread each, no JAX: ``tests/torch_ranks.py``) rendezvous through a file
under ``tmp_path``.  Gradients are read off a grads-capturing optimizer on
both sides (JAX: the transformation stores the averaged gradient as its
state; port: SGD at lr 0 leaves it in ``.grad``), never off Adam's first
update.  The JAX steps run with their ``pairwise_dist`` diagonal zeroed,
as ``tests/test_torch_train.py`` does (ROADMAP.md section 3).

Tolerances:
  * losses: rtol 1e-5 (``test_torch_train.py``'s METRIC_RTOL).
  * gradients per leaf: atol 2e-4 x the leaf's largest |grad|, the rule of
    ``test_torch_train.py::test_gradients_match``.
  * N ranks against the port's own one-process step on the same global
    batch (augmentation, expand-level modality dropout and dropcode on):
    dropcode masks bitwise, losses rtol 1e-5, the whole gradient within
    ONE_PROCESS_REL = 1e-5 of its largest entry (float32 convolution
    weight gradients summed over other batch splits; measured 2.9e-6 on
    one CPU).  Each planted fault must exceed that limit (measured 0.62
    to 1.9).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.parallel import sharding as JS
from ugaitnet_tpu.train import train_step as J

import torch_ranks as R
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.parallel import sharding as S

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
GRAD_REL_ATOL = 2e-4
ONE_PROCESS_REL = 1e-5
B = 8


def tcfg_of(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    tree = tree["params"] if "params" in tree else tree
    return dict(jax.tree_util.tree_leaves_with_path(np_tree(tree)))


def batch_arrays(b=B, seed=0, nclasses=74):
    rng = np.random.RandomState(seed)
    of = rng.randn(b, 25, 60, 60, 2).astype(np.float32)
    gray = rng.randn(b, 25, 60, 60, 1).astype(np.float32)
    flags = [np.ones(b, np.float32), np.ones(b, np.float32)]
    flags[0][1] = 0.0              # exercise the gate on both branches
    flags[1][6] = 0.0
    labels = np.repeat(np.arange(b // 2), 2).astype(np.int32) % nclasses
    return {"volumes": [of, gray], "flags": flags, "labels": labels}


def jax_batch(arrays):
    return J.Batch(volumes=tuple(jnp.asarray(v) for v in arrays["volumes"]),
                   use_flags=tuple(jnp.asarray(f) for f in arrays["flags"]),
                   labels=jnp.asarray(arrays["labels"]))


def grad_capture():
    """An optax transformation whose state after a step is that step's
    gradient, and whose update leaves the parameters as they are."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        init=zeros, update=lambda g, s, p=None: (zeros(g), g))


def _exact_diagonal_dist(x, squared=False, _orig=JT.pairwise_dist):
    d = _orig(x, squared)
    return jnp.where(jnp.eye(d.shape[-1], dtype=bool), 0.0, d)


def jax_sharded(make, jcfg, params, arrays, n, mesh=None, shard=None,
                place=None, tcfg=None):
    """(metrics, grads) of one JAX sharded step, the pairwise diagonal
    zeroed; ``make`` makes a JAX step over ``mesh`` (default an
    n-device data mesh)."""
    tcfg = tcfg or JTrainConfig()
    tx = grad_capture()
    model = JNet(jcfg)
    mesh = mesh if mesh is not None else JS.make_mesh(n)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = J.TrainState(step=jnp.int32(0), params=p, opt_state=tx.init(p))
    state = place(state, mesh) if place else JS.replicate(state, mesh)
    batch = (shard or JS.shard_batch)(jax_batch(arrays), mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        state, m = make(model, tx, jcfg, tcfg, mesh)(
            state, batch, jax.random.PRNGKey(1))
    return ({k: float(v) for k, v in m.items()},
            leaves(jax.device_get(state.opt_state)))


def check_grads(got, want):
    got, want = leaves(got), want
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=GRAD_REL_ATOL * np.abs(w).max(),
                                   err_msg=str(path))


def check_metrics(got, want, keys=("loss", "triplet", "id_ce", "acc")):
    """The keys both report (the JAX per-shard step has no "triplet")."""
    assert "loss" in want
    for k in (k for k in keys if k in want):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)


def run_ranks(tmp_path, fn, world, *args):
    work = str(tmp_path)
    S.spawn(fn, world, args=(work,) + args, devices=["cpu"] * world,
            init_file=os.path.join(work, "rdzv"), threads=1)
    return R.load(os.path.join(work, "out.pt"))


@pytest.fixture(scope="module")
def params():
    jcfg = graft._flagship_cfg(tiny=True)
    return np_tree(init_params(JNet(jcfg), jax.random.PRNGKey(0), batch=2))


def _cfg(l2):
    import dataclasses
    return dataclasses.replace(graft._flagship_cfg(tiny=True), l2_mode=l2)


VARIANTS = (("global-reference", "reference", "global"),
            ("global-feature", "feature", "global"),
            ("shard-reference", "reference", "shard"))


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def forms(request, params, tmp_path_factory):
    """Both packages' steps for every variant at n ranks."""
    n = request.param
    arrays = batch_arrays()
    work = tmp_path_factory.mktemp(f"forms{n}")
    R.save(str(work / "in.pt"), {"params": params, "batch": arrays,
                                 "tcfg": dict(vars(JTrainConfig()))})
    port = run_ranks(work, R.form_steps, n, n,
                     [(name, tcfg_of(_cfg(l2)), form)
                      for name, l2, form in VARIANTS])
    jax_out = {}
    for name, l2, form in VARIANTS:
        make = (JS.make_sharded_train_step if form == "global"
                else JS.make_shardmap_train_step)
        jax_out[name] = jax_sharded(make, _cfg(l2), params, arrays, n)
    return port, jax_out


@pytest.mark.parametrize("l2", ["reference", "feature"])
def test_global_form_matches_jax(forms, l2):
    """The global form against ``make_sharded_train_step``."""
    port, jax_out = forms
    (pm, pg), (jm, jg) = port[f"global-{l2}"], jax_out[f"global-{l2}"]
    check_metrics(pm, jm)
    check_grads(pg, jg)


def test_per_shard_form_matches_jax(forms):
    """The per-shard form against ``make_shardmap_train_step``: local-batch
    L2, mean-reduced id terms."""
    port, jax_out = forms
    (pm, pg), (jm, jg) = port["shard-reference"], jax_out["shard-reference"]
    check_metrics(pm, jm)
    check_grads(pg, jg)
    # the two forms differ under the reference L2 (the local batch axis)
    assert abs(pm["loss"] - port["global-reference"][0]["loss"]) > \
        METRIC_RTOL * abs(pm["loss"])


# ---------------------------------------------- N ranks vs one process

def _dropcode_cfg():
    """The tiny flagship with casenet C's dropcode (0.4) in train mode."""
    import dataclasses
    return tcfg_of(dataclasses.replace(graft._flagship_cfg(tiny=True),
                                       extra_dense=(32,), dropout_code=0.4))


@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory):
    """The global form on 2 ranks with dropcode, augmentation and
    expand-level modality dropout, correct and with each planted fault,
    and the port's one-process step on the same global batch."""
    from ugaitnet_tpu_torch.train.train_step import make_train_step
    mcfg = _dropcode_cfg()
    work = tmp_path_factory.mktemp("one_process")
    ranks = run_ranks(work, R.own_batch_steps, 2, 2, mcfg, R.FAULTS)
    st = R.probe_state(mcfg)
    taps = []
    st.model.register_forward_hook(
        lambda mod, args, out: taps.append(out["flatten"].detach()))
    batch = R.augmented_batch(3, 3, tconfig.DataConfig())
    _, m = make_train_step(mcfg, tconfig.TrainConfig())(st, batch)
    return ranks, (R.metrics_of(m), R.grads_flax(st), taps[0].numpy(),
                   batch)


def _whole_grad_err(got, want):
    got, want = leaves(got), leaves(want)
    return (max(np.abs(got[k] - want[k]).max() for k in want)
            / max(np.abs(w).max() for w in want.values()))


def test_global_form_equals_one_process(one_process_runs):
    ranks, (m1, g1, flat1, batch) = one_process_runs
    assert batch.labels.shape[0] == 12 and len(set(batch.labels.tolist())) > 1
    mr, gr, flatr = ranks["correct"]
    # the dropcode masks: the same zeros, bitwise, and the same values
    assert np.array_equal(flatr == 0, flat1 == 0) and (flat1 == 0).any()
    check_metrics(mr, m1)
    assert _whole_grad_err(gr, g1) <= ONE_PROCESS_REL


@pytest.mark.parametrize("fault", R.FAULTS)
def test_planted_faults_fail_the_limit(one_process_runs, fault):
    ranks, (_, g1, _, _) = one_process_runs
    assert _whole_grad_err(ranks[fault][1], g1) > ONE_PROCESS_REL


# -------------------------------------------------------------- pieces

def test_collectives_sum_in_backward(tmp_path):
    work = str(tmp_path)
    S.spawn(R.collectives, 2, args=(work,), devices=["cpu"] * 2,
            init_file=os.path.join(work, "rdzv"), threads=1)
    res = [R.load(os.path.join(work, f"coll{r}.pt")) for r in range(2)]
    base = np.array([[1.0, 2.0], [3.0, 4.0]])
    w = np.arange(8.0).reshape(4, 2)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["gather"],
                                      np.concatenate([base, 2 * base]))
        # every rank's loss used the same weights: the cotangent sums to 2 w,
        # of which this rank keeps its own rows
        np.testing.assert_array_equal(out["gather_grad"],
                                      2 * w[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["sum"], [6.0])
        np.testing.assert_array_equal(out["sum_grad"], [6.0])
        np.testing.assert_array_equal(out["mean"], [3.0])
        np.testing.assert_array_equal(out["mean_grad"], [5.0])
        # the multi-host form trains on the rows each process passes, and
        # refuses shards of unequal size
        assert out["multihost_same"]
        assert "differ in rows across the data ranks" in \
            out["multihost_uneven"]


def test_shard_batch_rows_and_divisibility():
    mesh = S.Mesh(shape={"data": 2}, coords={"data": 1}, groups={},
                  rank=1, world=2, device=torch.device("cpu"),
                  backend="gloo")
    b = R.batch_of(batch_arrays())
    local = S.shard_batch(b, mesh)
    assert torch.equal(local.labels, b.labels[4:])
    assert torch.equal(local.volumes[1], b.volumes[1][4:])
    odd = R.batch_of(batch_arrays(b=10))
    with pytest.raises(ValueError, match="not divisible by the 4-device"):
        S.shard_batch(odd, S.Mesh(shape={"data": 4}, coords={"data": 0},
                                  groups={}, rank=0, world=4,
                                  device=torch.device("cpu"), backend="gloo"))


def test_more_ranks_than_cards_raise():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(ValueError, match="2-device mesh"):
        S.device_list(2, "cuda")
    assert S.device_list(3, "cpu") == [torch.device("cpu")] * 3
    assert S.backend_for(["cpu", "cpu"]) == "gloo"
    assert S.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert S.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(RuntimeError, match="no process group"):
        S.make_mesh(2)


def test_dryrun_multichip_4(capsys):
    from ugaitnet_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4)
