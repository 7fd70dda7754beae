"""The port's optimizer menu against the JAX package's optax optimizers, on
the CPU: the same initial parameters and the same numpy gradients for 6
steps, with the lr set midway (``set_lr``), then the parameters compared
after every step.

Tolerance: max |port - optax| <= 4e-7 per parameter after every step, with
parameters of size ~1 and lr 1e-3 (a few float32 ulps of the parameters:
the two compute the same float32 update in another order; measured 1.2e-7
for adam, which is torch.optim.Adam, <= 1.5e-8 for amsgrad, adamw and sgd,
0 for adam_keras).  A JAX Adam trajectory carried over mid-run by the state
bridge continues within the same limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.train import train_step as J

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.train import train_step as T
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              optax_adam_to_state_dict,
                                              state_dict_to_optax_adam,
                                              state_dict_to_flax)

torch.set_num_threads(1)

ATOL = 4e-7
SHAPES = {"w": (6, 5), "b": (7,), "k": (2, 3, 4)}
STEPS, SET_AT, NEW_LR = 6, 3, 2.5e-4


def _grads(step, shapes=SHAPES):
    rng = np.random.RandomState(10 + step)
    out = {}
    for k, s in shapes.items():
        g = rng.randn(*s).astype(np.float32)
        g[..., 0] *= 1e-4                 # small gradients: eps matters
        out[k] = g
    return out


def _jax_run(name, params, grads_at, lr=1e-3):
    tx = J.make_optimizer(JTrainConfig(optimizer=name, lr=lr))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = J.TrainState(step=jnp.int32(0), params=p, opt_state=tx.init(p))
    out = []
    for i in range(STEPS):
        if i == SET_AT:
            st = J.set_lr(st, NEW_LR)
        g = {k: jnp.asarray(v) for k, v in grads_at(i).items()}
        u, o = tx.update(g, st.opt_state, st.params)
        st = J.TrainState(step=st.step + 1,
                          params=optax.apply_updates(st.params, u),
                          opt_state=o)
        out.append({k: np.asarray(v) for k, v in st.params.items()})
    return out, J.get_lr(st)


def _port_run(name, params, grads_at, lr=1e-3):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = T.make_optimizer(tconfig.TrainConfig(optimizer=name, lr=lr),
                           list(tp.values()))
    st = T.TrainState(model=None, optimizer=opt)
    out = []
    for i in range(STEPS):
        if i == SET_AT:
            st = T.set_lr(st, NEW_LR)
        for k, g in grads_at(i).items():
            tp[k].grad = torch.from_numpy(g)
        opt.step()
        out.append({k: v.detach().numpy().copy() for k, v in tp.items()})
    return out, T.get_lr(st)


@pytest.mark.parametrize("name", ["adam", "adam_keras", "amsgrad", "adamw",
                                  "sgd"])
def test_optimizer_matches_optax(name):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    want, want_lr = _jax_run(name, params, _grads)
    got, got_lr = _port_run(name, params, _grads)
    assert got_lr == want_lr == float(np.float32(NEW_LR))
    moved = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ATOL,
                                       err_msg=f"{name} step {i} {k}")
            moved = max(moved, float(np.abs(w[k] - params[k]).max()))
    assert moved > 1e-3, name          # the steps did move the parameters


def test_amsgrad_is_not_torch_amsgrad():
    """optax takes the running max over the bias-corrected second moment;
    torch.optim.Adam(amsgrad=True) does not, and differs above the limit
    on a gradient that shrinks."""
    params = {"w": np.ones((4,), np.float32)}
    grads_at = lambda i: {"w": np.full((4,), 1.0 / (1 + 10 * i), np.float32)}
    want, _ = _jax_run("amsgrad", params, grads_at)
    tp = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.Adam([tp], lr=1e-3, amsgrad=True)
    for i in range(STEPS):
        if i == SET_AT:
            opt.param_groups[0]["lr"] = NEW_LR
        tp.grad = torch.from_numpy(grads_at(i)["w"])
        opt.step()
    assert np.abs(tp.detach().numpy() - want[-1]["w"]).max() > 100 * ATOL
    got, _ = _port_run("amsgrad", params, grads_at)
    np.testing.assert_allclose(got[-1]["w"], want[-1]["w"], atol=ATOL)


def test_adamw_is_not_torch_adamw():
    """torch.optim.AdamW multiplies the parameter by 1 - lr * wd in
    float32, which is exactly 1 at the flagship's lr 1e-4 and wd 1e-4: its
    steps equal torch.optim.Adam's bitwise, with no decay at all.  optax
    adds wd * p into the update before the lr scale, and at that lr its
    adamw still differs from its adam; the port follows optax."""
    lr, shapes = 1e-4, {"w": (64, 32)}
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(*shapes["w"]).astype(np.float32)}
    grads_at = lambda i: _grads(i, shapes)

    def run(make):
        p = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
        opt = make([p])
        for i in range(STEPS):
            p.grad = torch.from_numpy(grads_at(i)["w"])
            opt.step()
        return p.detach().numpy().copy()

    def run_optax(tx):
        p = {"w": jnp.asarray(params["w"])}
        st = tx.init(p)
        for i in range(STEPS):
            u, st = tx.update({"w": jnp.asarray(grads_at(i)["w"])}, st, p)
            p = optax.apply_updates(p, u)
        return np.asarray(p["w"])

    torch_w = run(lambda ps: torch.optim.AdamW(ps, lr=lr, eps=1e-8,
                                               weight_decay=1e-4))
    torch_a = run(lambda ps: torch.optim.Adam(ps, lr=lr, eps=1e-8))
    assert np.array_equal(torch_w, torch_a)
    want = run_optax(optax.adamw(lr, weight_decay=1e-4))
    assert np.abs(want - run_optax(optax.adam(lr))).max() > ATOL
    assert np.abs(torch_w - want).max() > ATOL
    port = run(lambda ps: T.make_optimizer(
        tconfig.TrainConfig(optimizer="adamw", lr=lr), ps))
    np.testing.assert_allclose(port, want, rtol=0, atol=ATOL)


def test_sgd_set_lr_sticks():
    """The JAX behavior of tests/test_trainer.py::test_sgd_set_lr_sticks:
    the base lr set by set_lr is used, with the 1e-5 decay on top."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = T.make_optimizer(tconfig.TrainConfig(optimizer="sgd", lr=1e-4,
                                               momentum=0.0), [p])
    st = T.TrainState(model=None, optimizer=opt)
    p.grad = torch.ones(4)
    opt.step()
    np.testing.assert_allclose(-p.detach()[0].item(), 1e-4, rtol=1e-4)
    st = T.set_lr(st, 5e-6)
    assert np.isclose(T.get_lr(st), 5e-6)
    before = p.detach()[0].item()
    opt.step()
    np.testing.assert_allclose(before - p.detach()[0].item(),
                               5e-6 / (1 + 1e-5), rtol=1e-4)


def test_lr_is_stored_as_float32():
    """set_lr rounds as inject_hyperparams does, so the trainer's plateau
    test np.isclose(new_lr, get_lr(state), rtol=1e-5) decides alike."""
    opt = T.make_optimizer(tconfig.TrainConfig(lr=1e-4),
                           [torch.nn.Parameter(torch.ones(1))])
    st = T.TrainState(model=None, optimizer=opt)
    jtx = J.make_optimizer(JTrainConfig(lr=1e-4))
    jst = J.TrainState(step=jnp.int32(0), params={"w": jnp.ones(1)},
                       opt_state=jtx.init({"w": jnp.ones(1)}))
    assert T.get_lr(st) == J.get_lr(jst) != 1e-4
    for lr in (1e-5, 3e-7, 0.1):
        assert T.get_lr(T.set_lr(st, lr)) == J.get_lr(J.set_lr(jst, lr))


def test_state_bridge_continues_a_jax_adam_trajectory():
    """Three optax Adam steps on the tiny flagship's parameters, carried
    into torch.optim.Adam by the bridge, then three more steps in each:
    the port continues where JAX would have gone; the bridge round trip is
    exact."""
    mcfg = graft._flagship_cfg(tiny=True)
    model = UGaitNet(tconfig.ModelConfig(**{**vars(mcfg), "branches": tuple(
        tconfig.BranchConfig(**vars(b)) for b in mcfg.branches)}),
        device="cpu", seed=1)
    params = state_dict_to_flax(model.state_dict())
    leaves, treedef = jax.tree_util.tree_flatten(params)

    def grads_at(i):
        rng = np.random.RandomState(50 + i)
        return jax.tree_util.tree_unflatten(
            treedef, [rng.randn(*x.shape).astype(np.float32) for x in leaves])

    tx = J.make_optimizer(JTrainConfig(lr=1e-3))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = J.TrainState(step=jnp.int32(0), params=jp, opt_state=tx.init(jp))

    def jstep(st, i):
        u, o = tx.update(jax.tree_util.tree_map(jnp.asarray, grads_at(i)),
                         st.opt_state, st.params)
        return J.TrainState(step=st.step + 1,
                            params=optax.apply_updates(st.params, u),
                            opt_state=o)

    for i in range(3):
        st = jstep(st, i)
    adam = st.opt_state.inner_state[0]
    carried = {"count": np.asarray(adam.count),
               "mu": jax.tree_util.tree_map(np.asarray, adam.mu),
               "nu": jax.tree_util.tree_map(np.asarray, adam.nu),
               "learning_rate": np.asarray(
                   st.opt_state.hyperparams["learning_rate"])}

    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, st.params)))
    tst = T.init_state(model, tconfig.TrainConfig(lr=1e-3))
    tst.optimizer.load_state_dict(
        optax_adam_to_state_dict(carried, tst.optimizer, model))
    back = state_dict_to_optax_adam(tst.optimizer.state_dict(), model)
    assert int(back["count"]) == 3
    assert back["learning_rate"] == carried["learning_rate"]
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(back[name]),
                        jax.tree_util.tree_leaves(carried[name])):
            assert np.array_equal(a, b)

    for i in range(3, 6):
        st = jstep(st, i)
        g = flax_to_state_dict(grads_at(i))
        for name, p in model.named_parameters():
            p.grad = g[name]
        tst.optimizer.step()
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, st.params))
    got = jax.tree_util.tree_leaves(state_dict_to_flax(model.state_dict()))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
