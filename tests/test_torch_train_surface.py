"""The rest of the port's training surface against the JAX package, on the
CPU: the train step with casenet C (postriplet 2), aux heads and the focal
id loss; the semi-hard and hard triplet kinds; the Siamese pair step; and,
in the port alone, remat and a resume with dropcode on, and the train CLI
with the new flags.

The JAX steps run with their ``pairwise_dist`` diagonal zeroed, as
tests/test_torch_train.py does (ROADMAP.md section 3); dropout is 0 where
the two packages are compared, since JAX's key stream cannot be drawn in
torch.  The semi-hard and hard kinds select by comparing distances, and
the Gram formula of ``pairwise_dist`` cancels in float32: on these
signatures the two packages' distances differ by up to 8.4e-6 at d ~ 0.04,
and at step 2 a negative 2.8e-6 beyond its positive in one package lies
inside it in the other, which moves the gradient by 9 % of its largest
entry.  So for those two kinds both packages take the difference form,
sqrt(sum((x_i - x_j)^2)), whose rounding is relative to d; what is held
is the selection, the masks and the reductions on the same distances
(``pairwise_dist`` itself is held in tests/test_torch_triplet.py).

Tolerances, as tests/test_torch_train.py states them, with what was
measured here (torch on one thread):
  * losses and metrics, per step: rtol 1e-5 (measured <= 5.1e-7).
  * gradients at the same params: atol 2e-4 x the leaf's largest |grad|
    (measured <= 1.2e-4, casenet C at step 2; <= 5.7e-5 for semi-hard and
    hard).
  * remat against no remat: loss and gradients within 1e-6 relative, the
    JAX remat test's limit (measured 0: the same ops re-executed).
  * resume against an uninterrupted run: abs 1e-6 (measured 0).
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import BranchConfig as JBranch
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.ops import losses as JL
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import train_step as J

from ugaitnet_tpu_torch.cli import train as cli_train
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.models import network
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv.logger import read_metrics
from ugaitnet_tpu_torch.ops import triplet as TT
from ugaitnet_tpu_torch.train import train_step as T
from ugaitnet_tpu_torch.train import trainer as TR
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
GRAD_REL_ATOL = 2e-4
REMAT_RTOL = 1e-6
RESUME_ATOL = 1e-6

_JAX_PAIRWISE = JT.pairwise_dist


def _exact_diagonal_dist(x, squared=False):
    d = _JAX_PAIRWISE(x, squared)
    return jnp.where(jnp.eye(d.shape[-1], dtype=bool), 0.0, d)


def _direct_dist_jax(x, squared=False):
    x = x.astype(jnp.float32)
    diff = x[..., :, None, :] - x[..., None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    if squared:
        return d2
    zero = d2 <= 0.0
    d = jnp.sqrt(d2 + jnp.where(zero, 1e-16, 0.0))
    return jnp.where(zero, 0.0, d)


def _direct_dist_torch(x):
    x = x.to(torch.float32)
    diff = x[..., :, None, :] - x[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    zero = d2 <= 0.0
    d = torch.sqrt(d2 + zero.to(d2.dtype) * 1e-16)
    return torch.where(zero, torch.zeros_like(d), d)


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(_np(tree)))


def _arrays(step, b=12, conv=False):
    rng = np.random.RandomState(200 + step)
    of = rng.randn(b, 25, 60, 60, 2).astype(np.float32)
    gray = rng.randn(b, 25, 60, 60, 1).astype(np.float32)
    flags = [np.ones(b, np.float32), np.ones(b, np.float32)]
    flags[0][[1]] = 0.0
    flags[1][[4]] = 0.0
    of[1], gray[4] = 1e-9, 1e-9
    labels = np.repeat(np.arange(b // 4), 4).astype(np.int32)
    return (of, gray), flags, labels


def _batches(arrays):
    (of, gray), flags, labels = arrays
    jb = J.Batch(volumes=(jnp.asarray(of), jnp.asarray(gray)),
                 use_flags=tuple(jnp.asarray(f) for f in flags),
                 labels=jnp.asarray(labels))
    tb = T.Batch(volumes=(torch.from_numpy(of), torch.from_numpy(gray)),
                 use_flags=tuple(torch.from_numpy(f) for f in flags),
                 labels=torch.from_numpy(labels))
    return jb, tb


SURFACES = {
    "casenet_c_pt2_aux_focal": (
        dict(extra_dense=(24,), postriplet=2, dropout_code=0.0,
             aux_losses=True),
        dict(use_focal=True, loss_weights=(1.0, 0.1, 0.05))),
    "semi_hard": ({}, dict(triplet_kind="semi_hard")),
    "hard": ({}, dict(triplet_kind="hard")),
}


@pytest.fixture(scope="module", params=sorted(SURFACES))
def runs(request):
    """Three Adam steps of both packages from the same initial params; per
    step the metrics of each and both gradients at the JAX step's params."""
    mkw, tkw = SURFACES[request.param]
    mcfg = dataclasses.replace(graft._flagship_cfg(tiny=True), **mkw)
    jtcfg = JTrainConfig(**tkw)
    with pytest.MonkeyPatch.context() as mp:
        if jtcfg.triplet_kind in ("semi_hard", "hard"):
            mp.setattr(JT, "pairwise_dist", _direct_dist_jax)
            mp.setattr(TT, "pairwise_dist", _direct_dist_torch)
        else:
            mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        jmodel = JNet(mcfg)
        tx = J.make_optimizer(jtcfg)
        jstate = J.init_state(jmodel, tx, jax.random.PRNGKey(0))

        @jax.jit
        def jvg(params, batch):
            return jax.value_and_grad(lambda p: J.compute_losses(
                jmodel, p, batch, jax.random.PRNGKey(0), mcfg, jtcfg,
                train=True), has_aux=True)(params)

        @jax.jit
        def jupdate(params, opt_state, grads):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        tmcfg, ttcfg = _tcfg(mcfg), tconfig.TrainConfig(**vars(jtcfg))
        tmodel = UGaitNet(tmcfg, device="cpu")
        tmodel.load_state_dict(flax_to_state_dict(_np(jstate.params)))
        tstate = T.init_state(tmodel, ttcfg)
        tstep = T.make_train_step(tmcfg, ttcfg)
        probe = UGaitNet(tmcfg, device="cpu")
        params, opt_state = jstate.params, jstate.opt_state
        out = []
        for s in range(3):
            jb, tb = _batches(_arrays(s))
            (_, jm), grads = jvg(params, jb)
            probe.load_state_dict(flax_to_state_dict(_np(params)))
            probe.zero_grad(set_to_none=True)
            T.compute_losses(probe, tb, tmcfg, ttcfg, key=s)[0].backward()
            tgrads = _leaves(state_dict_to_flax(
                {k: p.grad for k, p in probe.named_parameters()}))
            params, opt_state = jupdate(params, opt_state, grads)
            tstate, tm = tstep(tstate, tb)
            out.append(dict(jm={k: float(v) for k, v in jm.items()},
                            tm={k: float(v) for k, v in tm.items()},
                            grads=_leaves(grads), tgrads=tgrads))
    return request.param, out


@pytest.mark.parametrize("step", [0, 2])
def test_surface_metrics_match(runs, step):
    name, out = runs
    jm, tm = out[step]["jm"], out[step]["tm"]
    assert set(tm) == set(jm)
    if name.startswith("casenet"):
        assert {"aux_ce_0", "aux_ce_1"} <= set(tm)
    assert tm["triplet"] > 0
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("step", [0, 2])
def test_surface_gradients_match(runs, step):
    name, out = runs
    grads, tgrads = out[step]["grads"], out[step]["tgrads"]
    assert set(grads) == set(tgrads)
    if name.startswith("casenet"):
        keys = {str(p[1].key) for p in grads}
        assert {"extra_dense", "classprob_of", "classprob_gray"} <= keys
    for path, g in grads.items():
        scale = np.abs(g).max()
        assert scale > 0, path
        np.testing.assert_allclose(tgrads[path], g, rtol=0,
                                   atol=GRAD_REL_ATOL * scale,
                                   err_msg=str(path))


# --- the pair step ------------------------------------------------------

def _conv2d_cfg(dropout=0.0):
    b = dict(kind="conv2d", filters_numbers=(4, 4, 8, 8), ndense_units=16,
             dropout=dropout)
    return JModelConfig(branches=(JBranch(modality="of", **b),
                                  JBranch(modality="gray", **b)),
                        merge="max", nclasses=0)


def _pair(step):
    a, b = _arrays(step, b=8), _arrays(step + 10, b=8)
    labels = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    (ja, ta), (jb, tb) = _batches(a), _batches(b)
    return (J.PairBatch(ja, jb, jnp.asarray(labels)),
            T.PairBatch(ta, tb, torch.from_numpy(labels)))


def test_pair_step_matches_jax():
    """Three steps of make_pair_train_step in both packages on a tiny 2D
    CNN pair (the conv2d config of tests/test_bothdatasets.py), margin 0.5;
    the first step's gradients at the same params."""
    mcfg = _conv2d_cfg()
    jtcfg = JTrainConfig(margin=0.5)
    jmodel = JNet(mcfg)
    tx = J.make_optimizer(jtcfg)
    jstate = J.init_state(jmodel, tx, jax.random.PRNGKey(0))
    tmcfg, ttcfg = _tcfg(mcfg), tconfig.TrainConfig(**vars(jtcfg))
    tmodel = UGaitNet(tmcfg, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_np(jstate.params)))

    jp, tp = _pair(0)

    def jloss(p):
        e = [jmodel.apply(p, list(b.volumes), list(b.use_flags),
                          train=False)["signature"] for b in
             (jp.batch1, jp.batch2)]
        return JL.verif_pair_loss(e[0], e[1], jp.pair_labels, 0.5)
    grads = _leaves(jax.jit(jax.grad(jloss))(jstate.params))
    tstate = T.init_state(tmodel, ttcfg)
    tstep = T.make_pair_train_step(ttcfg)
    tstate, _ = tstep(tstate, tp)
    tgrads = _leaves(state_dict_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}))
    assert set(grads) == set(tgrads)
    for path, g in grads.items():
        np.testing.assert_allclose(tgrads[path], g, rtol=0,
                                   atol=GRAD_REL_ATOL * np.abs(g).max(),
                                   err_msg=str(path))

    tmodel.load_state_dict(flax_to_state_dict(_np(jstate.params)))
    tstate = T.init_state(tmodel, ttcfg)
    jstep = J.make_pair_train_step(jmodel, tx, mcfg, jtcfg)
    for s in range(3):
        jp, tp = _pair(s)
        jstate, jm = jstep(jstate, jp, jax.random.PRNGKey(s))
        tstate, tm = tstep(tstate, tp)
        assert set(tm) == set(jm) == {"pair_loss"}
        assert float(tm["pair_loss"]) > 0
        np.testing.assert_allclose(float(tm["pair_loss"]),
                                   float(jm["pair_loss"]), rtol=METRIC_RTOL,
                                   err_msg=f"step {s}")
    assert tstate.step == 3


def test_pair_step_sides_draw_distinct_masks():
    """Both sides hold the same clips: with dropout on, only their masks
    differ, so a positive pair's residual is nonzero; the keys change with
    the step count."""
    tmcfg = _tcfg(_conv2d_cfg(dropout=0.4))
    model = UGaitNet(tmcfg, device="cpu")
    _, tp = _pair(0)
    same = T.PairBatch(tp.batch1, tp.batch1, torch.ones(8, dtype=torch.int32))
    state = T.init_state(model, tconfig.TrainConfig(margin=0.5))
    step = T.make_pair_train_step(tconfig.TrainConfig(margin=0.5))
    assert T.pair_keys(0) != T.pair_keys(1)
    assert len(set(T.pair_keys(0) + T.pair_keys(1))) == 4
    _, m = step(state, same)
    assert float(m["pair_loss"]) > 0


# --- remat --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gaitset", "conv2d"])
def test_remat_equals_no_remat(kind):
    """Remat keeps the parameter names (checkpoints interchange) and gives
    the loss and gradients of the same step without it, with dropout on
    (dropcode 0.4 on the GaitSet net, the branch dropout 0.4 on the 2D
    CNN), whose recompute must draw the same masks."""
    if kind == "gaitset":
        jcfg = dataclasses.replace(
            graft._flagship_cfg(tiny=True), extra_dense=(24,), postriplet=2,
            dropout_code=0.4, aux_losses=True)
        tcfg = tconfig.TrainConfig(use_focal=True)
    else:
        jcfg = dataclasses.replace(_conv2d_cfg(dropout=0.4), nclasses=3)
        tcfg = tconfig.TrainConfig()
    mcfg = _tcfg(jcfg)
    _, tb = _batches(_arrays(0))
    res = {}
    for remat in (False, True):
        model = UGaitNet(dataclasses.replace(mcfg, remat=remat),
                         device="cpu", seed=3)
        model.train()
        loss, metrics = T.compute_losses(model, tb, model.config, tcfg,
                                         key=11)
        loss.backward()
        res[remat] = (float(loss.detach()), dict(model.named_parameters()),
                      model.state_dict())
    assert res[True][2].keys() == res[False][2].keys()
    for k, v in res[False][2].items():
        assert torch.equal(res[True][2][k], v), k
    assert abs(res[True][0] - res[False][0]) <= REMAT_RTOL * abs(res[False][0])
    for name, p in res[False][1].items():
        g, gr = p.grad, res[True][1][name].grad
        assert g is not None and gr is not None, name
        assert float((gr - g).abs().max()) <= \
            REMAT_RTOL * float(g.abs().max()), name


def test_remat_actually_recomputes(monkeypatch):
    """The branches run once per forward without remat and twice (forward,
    recompute) with it."""
    mcfg = _tcfg(graft._flagship_cfg(tiny=True))
    _, tb = _batches(_arrays(0, b=8))
    calls = []
    for remat in (False, True):
        model = UGaitNet(dataclasses.replace(mcfg, remat=remat),
                         device="cpu")
        branch = model.branches["branch_of"]
        real = branch.forward
        n = []
        monkeypatch.setattr(branch, "forward",
                            lambda *a, **k: (n.append(1), real(*a, **k))[1])
        loss, _ = T.compute_losses(model, tb, model.config,
                                   tconfig.TrainConfig(
                                       triplet_kind="batch_all_xla"), key=0)
        loss.backward()
        calls.append(len(n))
    assert calls == [1, 2]


# --- resume with dropcode -----------------------------------------------

def _trainer_cfgs(epochs):
    b = dict(kind="gaitset", gaitset_channels=(4, 4, 8), part_dim=8)
    mcfg = tconfig.ModelConfig(
        branches=(tconfig.BranchConfig(modality="of", **b),
                  tconfig.BranchConfig(modality="gray", **b)),
        merge="sign_max", nclasses=4, extra_dense=(16,), postriplet=1,
        dropout_code=0.4)
    dcfg = tconfig.DataConfig(batch_size=8, expand_level=1, repetitions=2,
                              augment=False)
    tcfg = tconfig.TrainConfig(lr=1e-3, epochs=epochs, extra_epochs=0,
                               save_every_epochs=1, loss_weights=(1.0, 0.1))
    return mcfg, dcfg, tcfg


_STREAMS = {}


def _process_stream_dropout(x, rate, seed, key):
    """Planted fault: masks from one generator per process (here, per
    Trainer), whatever the step."""
    gen = _STREAMS.setdefault(seed, torch.Generator().manual_seed(seed))
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@pytest.mark.parametrize("fault", [None, "process_stream"])
def test_resume_with_dropcode(tmp_path, monkeypatch, fault):
    """A casenet C run with dropcode 0.4, restarted from its epoch-1
    checkpoint, repeats the uninterrupted run's epoch-2 loss within
    RESUME_ATOL: the masks are keyed by the step count.  With masks from a
    per-process stream (the planted fault) it misses the limit."""
    if fault:
        monkeypatch.setattr(network, "keyed_dropout",
                            _process_stream_dropout)
    ds = make_synthetic_dataset(num_subjects=4, videos_per_subject=2,
                                subseqs_per_video=2, seed=1)

    def fit(name, epochs):
        _STREAMS.clear()
        t = TR.Trainer(*_trainer_cfgs(epochs), str(tmp_path / name),
                       device="cpu")
        return t.fit(ds, val_perc=0.0)

    full = fit("full", 2)
    fit("resumed", 1)
    state = fit("resumed", 2)

    def losses(name):
        return {int(r["step"]): r["train/loss"]
                for r in read_metrics(str(tmp_path / name))
                if "train/loss" in r}
    want, got = losses("full"), losses("resumed")
    assert set(got) == set(want) == {1, 2} and got[1] == want[1]
    if fault:
        assert abs(got[2] - want[2]) > RESUME_ATOL, (got[2], want[2])
        return
    assert abs(got[2] - want[2]) <= RESUME_ATOL, (got[2], want[2])
    for k, v in full.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


# --- the train CLI ------------------------------------------------------

CLI = ["--synthetic", "--nclasses", "4", "--bs", "8", "--repetitions", "2",
       "--epochs", "1", "--savemodelfreq", "1", "--gschannels", "4,4,8",
       "--gspartdim", "8", "--expandlevel", "1", "--noaugment",
       "--valperc", "0.3", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--casenet", "C", "--postriplet", "2", "--auxlosses", "--focal",
     "--remat"],
    ["--tripletkind", "semi_hard"]])
def test_train_cli_new_flags_finish_an_epoch(tmp_path, flags):
    exp = cli_train.main(CLI + flags + ["--experdir", str(tmp_path)])
    cfg = json.load(open(os.path.join(exp, "config.json")))
    rec = [r for r in read_metrics(exp) if "train/loss" in r]
    assert len(rec) == 1 and rec[0]["step"] == 1
    rec = {k: v for r in read_metrics(exp) for k, v in r.items()}
    assert all(math.isfinite(v) for k, v in rec.items()
               if k.startswith(("train/", "val/")))
    assert rec["train/triplet"] > 0 and "val/loss" in rec
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["1", "best"]
    if "--casenet" in flags:
        assert cfg["model"]["extra_dense"] == [256]
        assert cfg["model"]["remat"] and cfg["train"]["use_focal"]
        assert {"train/aux_ce_0", "train/aux_ce_1", "val/aux_ce_0",
                "val/aux_ce_1"} <= set(rec)
    else:
        assert cfg["train"]["triplet_kind"] == "semi_hard"
        assert exp.endswith("_semi_hard")
