"""The port's 2D and 3D CNN branches (``models/branches.py``), their
network wiring, weight bridge and Keras L2 terms, held against the JAX
package on the CPU.

Tolerances:
  * weight bridge: bitwise round trip (transposes only).
  * forward: rtol 1e-4 / atol 1e-5, the forward tolerance of
    tests/test_torch_port.py (float32 convolutions summed in another order;
    measured <= 2e-6 here).
  * l2_regularization: value rtol 1e-6 (float32 sums of squares in another
    order), gradient (exactly 2 c w in both) rtol 1e-6.
  * one train step (dropout 0; the JAX step with its distance diagonal set
    to 0, as tests/test_torch_train.py explains): losses rtol 1e-5,
    gradients atol 2e-4 x the leaf's largest |grad|.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.core.config import BranchConfig as JBranchConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import branch_input as j_branch_input
from ugaitnet_tpu.models.network import make_branch as j_make_branch
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import train_step as J

from ugaitnet_tpu_torch.cli import train as cli_train
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet, branch_input
from ugaitnet_tpu_torch.obsv.logger import read_metrics
from ugaitnet_tpu_torch.train import train_step as T
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
REG_RTOL = 1e-6
METRIC_RTOL = 1e-5
GRAD_REL_ATOL = 2e-4
# narrow 2D widths for the CPU; the 3D branch's widths are fixed
SMALL_2D = dict(filters_numbers=(8, 8, 16, 16), ndense_units=16)


def _jcfg(kinds, **kw):
    branches = []
    for kind, mod in zip(kinds, ("of", "gray")):
        extra = dict(SMALL_2D) if kind == "conv2d" else dict(ndense_units=16)
        extra.update(kw)
        branches.append(JBranchConfig(kind=kind, modality=mod, **extra))
    return JModelConfig(branches=tuple(branches), merge="sign_max",
                        nclasses=5)


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nets(jcfg, seed=0):
    jmodel = JNet(jcfg)
    params = jax.jit(lambda key: init_params(jmodel, key, batch=2))(
        jax.random.PRNGKey(seed))
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_np(params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module", params=["conv2d", "conv3d"])
def nets(request):
    jcfg = _jcfg((request.param,) * 2)
    return (request.param, jcfg) + _nets(jcfg)


def _volumes(b, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, 25, 60, 60, 2).astype(np.float32),
            rng.randn(b, 25, 60, 60, 1).astype(np.float32)]


def test_bridge_round_trip_bit_exact(nets):
    _, _, _, params, tmodel = nets
    want = jax.tree_util.tree_leaves_with_path(_np(params))
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_flax(tmodel.state_dict())))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype, path
        assert np.array_equal(got[path], leaf), path


def test_forward_matches(nets):
    _, jcfg, jmodel, params, tmodel = nets
    vols = _volumes(2, seed=1)
    flags = [np.array([1, 0], np.float32), np.ones(2, np.float32)]
    jout = jmodel.apply(params, [jnp.asarray(v) for v in vols],
                        [jnp.asarray(f) for f in flags], train=False)
    with torch.no_grad():
        tout = tmodel([torch.from_numpy(v) for v in vols],
                      [torch.from_numpy(f) for f in flags], train=False)
    assert set(tout) == set(jout)
    for key in ("signature", "flatten", "classprob_logits", "fused"):
        want = np.asarray(jout[key])
        assert tuple(tout[key].shape) == want.shape, key
        np.testing.assert_allclose(tout[key].numpy(), want, rtol=FWD_RTOL,
                                   atol=FWD_ATOL, err_msg=key)


def test_flatten_order_is_channels_last(nets):
    """The last conv map is flattened in JAX's (h, w, c) order.  The 2D
    branch's last map is 3 x 3 here, so an NCHW (c, h, w) flatten under
    the same weights must miss the JAX branch; the 3D branch's is 1 x 1 x
    1 at the clip geometry, where the two orders agree."""
    kind, jcfg, jmodel, params, tmodel = nets
    bcfg = jcfg.branches[1]
    branch = tmodel.branches["branch_gray"]
    vol = _volumes(2, seed=2)[1]
    # the branch alone, through the JAX package's own wiring
    want = np.asarray(j_make_branch(bcfg, jnp.float32, "branch_gray").apply(
        {"params": params["params"]["branch_gray"]},
        j_branch_input(bcfg, jnp.asarray(vol))))
    last = {}
    layer = branch.conv3 if kind == "conv2d" else branch.code
    hook = layer.register_forward_hook(
        lambda _m, _i, o: last.__setitem__("map", o.detach()))
    with torch.no_grad():
        got = branch(branch_input(tmodel.config.branches[1],
                                  torch.from_numpy(vol))).numpy()
    hook.remove()
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    m = last["map"]
    if kind == "conv3d":
        assert tuple(m.shape[2:]) == (1, 1, 1)
        return
    assert tuple(m.shape[2:]) == (3, 3)
    with torch.no_grad():
        wrong = branch.code(branch.dense(torch.maximum(m, 0.3 * m).reshape(
            m.shape[0], -1))).numpy()
    assert np.abs(wrong - want).max() > 100 * FWD_ATOL


def test_l2_regularization_matches(nets):
    """The Keras terms: value and gradient against the JAX function."""
    _, jcfg, _, params, tmodel = nets
    want, jgrad = jax.value_and_grad(
        lambda p: J.l2_regularization(p, jcfg))(params)
    tmodel.zero_grad(set_to_none=True)
    got = T.l2_regularization(tmodel, _tcfg(jcfg))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=REG_RTOL)
    assert float(want) > 0
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    jg = flax_to_state_dict(_np(jgrad))
    for name, g in jg.items():
        tg = grads[name]
        if not g.abs().max():
            assert tg is None or not tg.abs().max(), name
            continue
        np.testing.assert_allclose(tg.numpy(), g.numpy(), rtol=REG_RTOL,
                                   atol=0, err_msg=name)


_JAX_PAIRWISE = JT.pairwise_dist


def _exact_diagonal_dist(x, squared=False):
    d = _JAX_PAIRWISE(x, squared)
    return jnp.where(jnp.eye(d.shape[-1], dtype=bool), 0.0, d)


def test_train_step_matches(nets, monkeypatch):
    """One Adam step with dropout 0, B = 8 (labels 2 x 4; the 3D CNN B = 4,
    2 x 2): losses, the Keras L2 term and the gradients against the JAX
    step."""
    kind, jcfg, _, params, _ = nets
    b = 8 if kind == "conv2d" else 4
    monkeypatch.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
    jcfg = dataclasses.replace(jcfg, branches=tuple(
        dataclasses.replace(b, dropout=0.0) for b in jcfg.branches))
    jmodel = JNet(jcfg)
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_np(params)))
    jtcfg = JTrainConfig()
    vols = _volumes(b, seed=6)
    flags = [np.ones(b, np.float32), np.ones(b, np.float32)]
    flags[1][3] = 0.0
    vols[1][3] = 1e-9
    labels = np.repeat(np.arange(2), b // 2).astype(np.int32)
    jb = J.Batch(volumes=tuple(jnp.asarray(v) for v in vols),
                 use_flags=tuple(jnp.asarray(f) for f in flags),
                 labels=jnp.asarray(labels))
    (_, jm), jgrad = jax.jit(jax.value_and_grad(
        lambda p: J.compute_losses(jmodel, p, jb, jax.random.PRNGKey(0),
                                   jcfg, jtcfg, train=True),
        has_aux=True))(params)
    tb = T.Batch(volumes=tuple(torch.from_numpy(v) for v in vols),
                 use_flags=tuple(torch.from_numpy(f) for f in flags),
                 labels=torch.from_numpy(labels))
    state = T.init_state(tmodel, tconfig.TrainConfig(**vars(jtcfg)))
    _, metrics = T.make_train_step(_tcfg(jcfg), tconfig.TrainConfig(
        **vars(jtcfg)))(state, tb)
    for k in ("loss", "triplet", "id_ce", "reg"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]),
                                                  rel=METRIC_RTOL), k
    assert float(metrics["reg"]) > 0
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    for name, g in flax_to_state_dict(_np(jgrad)).items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_REL_ATOL * scale, err_msg=name)


def test_dropout_draws_its_own_stream():
    """Train-mode dropout keeps ~(1 - rate) of the units, scales them by
    1 / (1 - rate), draws from a generator of (branch seed, key) alone (the
    global RNG's state is untouched; the same key gives the same mask
    however many draws came before), needs a key, and is off in eval
    mode."""
    cfg = _tcfg(_jcfg(("conv2d", "conv2d"), dropout=0.4))
    model = UGaitNet(cfg, device="cpu", seed=1)
    branch = model.branches["branch_of"]
    x = torch.ones(64, 32)
    before = torch.get_rng_state()
    y = branch._dropout(x, key=0)
    assert torch.equal(torch.get_rng_state(), before)
    kept = y != 0
    assert 0.5 < float(kept.float().mean()) < 0.7
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.6))
    assert not torch.equal(branch._dropout(x, key=1), y)
    assert torch.equal(branch._dropout(x, key=0), y)
    with pytest.raises(ValueError, match="key"):
        branch._dropout(x, key=None)
    vol = [torch.from_numpy(v) for v in _volumes(2, seed=7)]
    with torch.no_grad():
        a = model(vol, train=False)["signature"]
        b = model(vol, train=False)["signature"]
        c = model(vol, train=True, key=3)["signature"]
        d = model(vol, train=True, key=3)["signature"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, d)


@pytest.mark.parametrize("flags", [["--no-gaitset"],
                                   ["--no-gaitset", "--use3d"]])
def test_train_cli_conv_branches(tmp_path, flags):
    """The train CLI trains the 2D and the 3D CNN nets through Trainer."""
    exp = cli_train.main(
        ["--synthetic", "--nclasses", "2", "--bs", "4", "--repetitions", "2",
         "--epochs", "1", "--savemodelfreq", "1", "--expandlevel", "1",
         "--singlemod", "--mod0", "gray", "--device", "cpu",
         "--experdir", str(tmp_path)] + flags)
    kind = "conv3d" if "--use3d" in flags else "conv2d"
    assert f"_{kind}_" in os.path.basename(exp)
    recs = [r for r in read_metrics(exp) if "train/loss" in r]
    assert recs and all(np.isfinite(r["train/loss"]) for r in recs)
    assert os.path.isdir(os.path.join(exp, "ckpt", "1"))
