"""The freezing and soft-label half of the port's ``utils/net_utils.py``
against the JAX package's, at the tiny flagship (B = 12, labels 3 x 4).

``freeze_mask`` labels each port parameter by its flax path as the JAX
mask labels the same leaf.  One Adam step with frozen convs: the port's
``frozen_optimizer`` (an optimizer over the trainable parameters only)
against the JAX ``frozen_optimizer`` (``optax.multi_transform`` with
``set_to_zero``).  Frozen leaves stay bitwise unchanged in both and keep no
optimizer state in the port; trainable leaves move as the JAX step moves
them, within ``tests/test_torch_train.py``'s one-step rule (2e-7 where the
gradient is clearly nonzero, 2 x lr elsewhere, with the JAX distance
diagonal zeroed as that file explains)."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import train_step as J
from ugaitnet_tpu.utils import net_utils as jnu

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.train import train_step as T
from ugaitnet_tpu_torch.utils import net_utils as nu
from ugaitnet_tpu_torch.utils.weights import (flax_path, flax_to_state_dict,
                                              state_dict_to_flax)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import (GRAD_REL_ATOL, PARAM_ATOL,  # noqa: E402
                              _batch, _exact_diagonal_dist, _leaves, _tcfg)

torch.set_num_threads(1)

PREDICATES = {"convs": nu.freeze_convs_predicate,
              "branches": nu.freeze_branches_predicate}
J_PREDICATES = {"convs": jnu.freeze_convs_predicate,
                "branches": jnu.freeze_branches_predicate}


def _path(keypath):
    return "/".join(str(getattr(e, "key", e)) for e in keypath)


@pytest.mark.parametrize("eps,labels,n", [(0.1, [0, 2], 4),
                                          (0.3, [5, 0, 5, 1], 6),
                                          (0.0, [1], 2)])
def test_soft_labels_match_jax(eps, labels, n):
    got = nu.soft_labels(labels, n, eps)
    want = jnu.soft_labels(labels, n, eps)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("which", sorted(PREDICATES))
def test_freeze_mask_matches_jax(which):
    mcfg = graft._flagship_cfg(tiny=True)
    model = UGaitNet(_tcfg(mcfg), device="cpu")
    params = state_dict_to_flax(model.state_dict())
    jmask = {_path(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        jnu.freeze_mask(params, J_PREDICATES[which]))}
    got = nu.freeze_mask(model, PREDICATES[which])
    assert {flax_path(k): v for k, v in got.items()} == jmask
    assert set(jmask.values()) == {"frozen", "trainable"}
    assert flax_path("branches.branch_of.a_conv1.weight") == \
        "params/branch_of/a_conv1/kernel"
    assert flax_path("classprob.bias") == "params/classprob/bias"


def test_one_frozen_step_matches_jax():
    mcfg = graft._flagship_cfg(tiny=True)
    jtcfg = JTrainConfig()
    jmodel = JNet(mcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        base = J.init_state(jmodel, J.make_optimizer(jtcfg),
                            jax.random.PRNGKey(0))
        tx = jnu.frozen_optimizer(J.make_optimizer(jtcfg), base.params,
                                  jnu.freeze_convs_predicate)
        jstate = J.TrainState(step=jnp.int32(0), params=base.params,
                              opt_state=tx.init(base.params))
        jb, tb = _batch(0)
        grads = _leaves(jax.grad(lambda p: J.compute_losses(
            jmodel, p, jb, jax.random.PRNGKey(0), mcfg, jtcfg,
            train=True)[0])(base.params))
        jstate, jm = jax.jit(J.make_train_step_fn(jmodel, tx, mcfg, jtcfg))(
            jstate, jb, jax.random.PRNGKey(1))
    init = _leaves(base.params)

    tmcfg, ttcfg = _tcfg(mcfg), tconfig.TrainConfig(**vars(jtcfg))
    model = UGaitNet(tmcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, base.params)))
    opt = nu.frozen_optimizer(functools.partial(T.make_optimizer, ttcfg),
                              model, nu.freeze_convs_predicate)
    tstate, tm = T.make_train_step(tmcfg, ttcfg)(
        T.TrainState(model=model, optimizer=opt), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)

    frozen = nu.freeze_mask(model, nu.freeze_convs_predicate)
    by_path = {flax_path(k): p for k, p in model.named_parameters()}
    assert len(opt.state) == sum(v == "trainable" for v in frozen.values())
    for name, p in model.named_parameters():
        assert (p in opt.state) == (frozen[name] == "trainable"), name
    jparams = _leaves(jstate.params)
    tparams = _leaves(state_dict_to_flax(model.state_dict()))
    moved = 0
    for key, want in jparams.items():
        path = _path(key)
        if "conv" in path.lower():
            assert np.array_equal(want, init[key]), path
            assert np.array_equal(tparams[key], init[key]), path
        else:
            moved += not np.array_equal(tparams[key], init[key])
            g = grads[key]
            clear = np.abs(g) > 100 * GRAD_REL_ATOL * np.abs(g).max()
            diff = np.abs(tparams[key] - want)
            assert diff[clear].max(initial=0) <= PARAM_ATOL[0], path
            assert diff.max() <= 2 * jtcfg.lr + 1e-7, path
    assert moved >= 2 and set(by_path) == {_path(k) for k in jparams}
