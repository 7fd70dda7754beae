"""Warm starts of the port (``utils/warm_start.py``, the train CLI's
``--initnet`` / ``--initbranch`` / ``--initepoch``) against the JAX
package's ``utils/warm_start.py``, at the tiny flagship.

Sources are a prior experiment (a port checkpoint, and the same weights as
a JAX checkpoint through the weight bridge) and Keras h5 files written by
``tests/test_warm_start.py``'s writer.  Both packages start from the same
target tree, so every result leaf must be bitwise equal; the port's result
goes into a model through the bridge.  The input tree is never mutated, and
the Trainer applies the hook once at a fresh start and never on resume."""

import argparse
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core import checkpoint as jckpt
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.train import train_step as J
from ugaitnet_tpu.utils import warm_start as jws

from ugaitnet_tpu_torch.cli import train as cli_train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.train import trainer as TR
from ugaitnet_tpu_torch.train.train_step import init_state
from ugaitnet_tpu_torch.utils import warm_start as ws
from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_keras import _leaves, _tcfg, assert_same_tree  # noqa: E402
from test_warm_start import _write_fake_gaitset_h5  # noqa: E402

torch.set_num_threads(1)


def _jcfg(mods=("of", "gray"), nclasses=7):
    cfg = graft._flagship_cfg(tiny=True)
    by_mod = {b.modality: b for b in cfg.branches}
    return JModelConfig(branches=tuple(by_mod[m] for m in mods),
                        merge=cfg.merge if len(mods) > 1 else "max",
                        nclasses=nclasses)


def _model(jcfg, seed):
    return UGaitNet(_tcfg(jcfg), device="cpu", seed=seed)


def _tree(jcfg, seed=0):
    return state_dict_to_flax(_model(jcfg, seed).state_dict())


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A 'trained' single-modality OF net (seed 42, 4 classes) saved as a
    port experiment at epochs 1 and 'best' (epoch 2's weights differ) and,
    bridged, as a JAX experiment at the same steps."""
    root = tmp_path_factory.mktemp("ws_sources")
    port, jax_exp = str(root / "port"), str(root / "jax")
    jcfg = _jcfg(("of",), nclasses=4)
    trees = {}
    for step, seed in ((1, 42), (2, 43), ("best", 44)):
        model = _model(jcfg, seed)
        ckpt.save_checkpoint(port, step, init_state(model, tconfig
                                                    .TrainConfig()))
        tree = state_dict_to_flax(model.state_dict())
        params = _jnp(tree)
        tx = J.make_optimizer(JTrainConfig())
        jckpt.save_checkpoint(jax_exp, step, J.TrainState(
            step=jnp.int32(0), params=params, opt_state=tx.init(params)))
        trees[step] = tree
    return dict(port=port, jax=jax_exp, trees=trees)


def _both(port_fn, jax_fn, target, *args):
    """Run one warm start in each package from the same target tree; the
    input must come back unmutated."""
    before = copy.deepcopy(target)
    got = port_fn(target, *args[0])
    want = jax_fn(_jnp(target), *args[1])
    assert_same_tree(target, before)
    assert_same_tree(got, want)
    return got


@pytest.mark.parametrize("epoch", [-1, 1, "best"])
def test_full_warm_start_with_head_surgery(sources, epoch):
    target = _tree(_jcfg(("of",), nclasses=9), seed=0)
    got = _both(ws.warm_start_full, jws.warm_start_full, target,
                (sources["port"], epoch), (sources["jax"], epoch))
    src = sources["trees"][2 if epoch == -1 else epoch]["params"]
    assert_same_tree(got["params"]["branch_of"], src["branch_of"])
    # the 9-wide head keeps the fresh init (the source's is 4 wide)
    assert_same_tree(got["params"]["classprob"],
                     target["params"]["classprob"])


def test_branch_warm_start_from_experiment(sources):
    target = _tree(_jcfg(), seed=0)
    got = _both(ws.warm_start_branches, jws.warm_start_branches, target,
                ({"of": (sources["port"], "of")},),
                ({"of": (sources["jax"], "of")},))
    assert_same_tree(got["params"]["branch_of"],
                     sources["trees"][2]["params"]["branch_of"])
    for k in ("branch_gray", "classprob"):
        assert_same_tree(got["params"][k], target["params"][k])


def test_gray_from_of_quirk(sources):
    """gray=path@of: the gray branch takes the OF branch's weights wherever
    shapes match (all but the first conv, 1 vs 2 input channels)."""
    target = _tree(_jcfg(), seed=0)
    got = _both(ws.warm_start_branches, jws.warm_start_branches, target,
                ({"gray": (sources["port"], "of")}, 1),
                ({"gray": (sources["jax"], "of")}, 1))
    src = _leaves(sources["trees"][1]["params"]["branch_of"])
    dst = _leaves(got["params"]["branch_gray"])
    fresh = _leaves(target["params"]["branch_gray"])
    assert src.keys() == dst.keys()
    kept = [k for k in dst if src[k].shape != dst[k].shape]
    assert kept == ["['a_conv1']['kernel']"]
    for k in dst:
        assert np.array_equal(dst[k], fresh[k] if k in kept else src[k]), k
    assert_same_tree(got["params"]["branch_of"],
                     target["params"]["branch_of"])


def test_h5_sources(tmp_path):
    """Keras h5 sources: a per-branch start from a 2-branch h5 touches only
    its branch; the gray-from-OF quirk from a 1-branch h5; a full start
    from an h5 of the same net."""
    two = str(tmp_path / "two.h5")
    one = str(tmp_path / "one.h5")
    c, d = (8, 8, 16), 16
    _write_fake_gaitset_h5(two, 2, [2, 1], channels=c, part_dim=d,
                           nclasses=7, seed=1)
    _write_fake_gaitset_h5(one, 1, [1], channels=c, part_dim=d, seed=3)
    target = _tree(_jcfg(), seed=0)
    got = _both(ws.warm_start_branches, jws.warm_start_branches, target,
                ({"gray": (two, "gray")},), ({"gray": (two, "gray")},))
    assert not np.array_equal(
        got["params"]["branch_gray"]["a_conv1"]["kernel"],
        target["params"]["branch_gray"]["a_conv1"]["kernel"])
    for k in ("branch_of", "classprob"):
        assert_same_tree(got["params"][k], target["params"][k])
    got = _both(ws.warm_start_branches, jws.warm_start_branches, target,
                ({"gray": (one, "of")},), ({"gray": (one, "of")},))
    assert not np.array_equal(
        got["params"]["branch_gray"]["a_conv2"]["kernel"],
        target["params"]["branch_gray"]["a_conv2"]["kernel"])
    got = _both(ws.warm_start_full, jws.warm_start_full, target, (two,),
                (two,))
    assert not np.array_equal(got["params"]["classprob"]["kernel"],
                              target["params"]["classprob"]["kernel"])
    for fn in (ws.warm_start_branches, jws.warm_start_branches):
        with pytest.raises(ValueError, match="unknown source modality"):
            fn(target, {"gray": (two, "flow")})
        with pytest.raises(ValueError, match="branch"):
            fn(target, {"gray": (two, "5")})


def test_errors_match_jax(sources, tmp_path):
    target = _tree(_jcfg(), seed=0)
    errors = []
    for fn, path in ((ws.warm_start_branches, sources["port"]),
                     (jws.warm_start_branches, sources["jax"])):
        with pytest.raises(KeyError) as e:
            fn(target, {"gray": (path, "gray")})
        errors.append(str(e.value).replace(path, "P"))
    for mod in (ws, jws):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            mod.load_source_params(str(tmp_path))
        with pytest.raises(ValueError, match="target params"):
            mod.load_source_params(str(tmp_path / "x.h5"))
    assert errors[0] == errors[1]


def test_parse_initbranch_specs_matches_jax():
    for specs in (["gray=/x/y@of", "of=/a/b"], ["gray=/p@q/r@1"],
                  ["of=/ckpt@home/run"]):
        assert ws.parse_initbranch_specs(specs, ("of", "gray")) == \
            jws.parse_initbranch_specs(specs, ("of", "gray"))
    for bad in (["depth=/x"], ["/x"]):
        with pytest.raises(ValueError):
            ws.parse_initbranch_specs(bad, ("of", "gray"))


def _args(**kw):
    base = dict(initnet="", initbranch=[], initepoch="-1")
    base.update(kw)
    return argparse.Namespace(**base)


def test_trainer_applies_the_cli_hook_once(sources, tmp_path):
    """The CLI's hook (state_dict -> flax -> warm start -> state_dict) at a
    fresh start: branches equal the source bitwise, the head stays the
    seed's; after a checkpoint the Trainer resumes and never calls it."""
    jcfg = _jcfg(("of",), nclasses=9)
    mcfg = _tcfg(jcfg)
    hook = cli_train.make_warm_start(_args(initnet=sources["port"],
                                           initepoch="best"), mcfg)
    assert cli_train.make_warm_start(_args(), mcfg) is None
    calls = []

    def counted(sd):
        calls.append(1)
        return hook(sd)

    dcfg = tconfig.DataConfig(batch_size=4, expand_level=1, augment=False)
    tcfg = tconfig.TrainConfig(epochs=0, save_every_epochs=1)
    exp = str(tmp_path / "exp")
    t = TR.Trainer(mcfg, dcfg, tcfg, exp, warm_start=counted, device="cpu")
    state, start = t.init_or_resume(seed=0)
    assert start == 0 and len(calls) == 1
    got = state_dict_to_flax(state.model.state_dict())
    assert_same_tree(got["params"]["branch_of"],
                     sources["trees"]["best"]["params"]["branch_of"])
    fresh = state_dict_to_flax(UGaitNet(mcfg, device="cpu", seed=0)
                               .state_dict())
    assert_same_tree(got["params"]["classprob"], fresh["params"]["classprob"])
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ckpt.save_checkpoint(exp, 1, state)
    t2 = TR.Trainer(mcfg, dcfg, tcfg, exp, warm_start=counted, device="cpu")
    state2, start2 = t2.init_or_resume(seed=0)
    assert start2 == 1 and len(calls) == 1
    assert_same_tree(state_dict_to_flax(state2.model.state_dict()),
                     state_dict_to_flax(state.model.state_dict()))


def test_cli_initbranch_run(sources, tmp_path):
    """cli.train --initbranch gray=<exp>@of --initepoch 1 for one epoch:
    the hook runs once, the gray branch starts from the source's OF branch
    and the OF branch from the seed's init."""
    ds = make_synthetic_dataset(num_subjects=4, videos_per_subject=2,
                                subseqs_per_video=2, seed=1)
    ds.save(str(tmp_path / "data"))
    calls = []
    orig = cli_train.make_warm_start

    def spy(args, mcfg):
        fn = orig(args, mcfg)

        def call(sd):
            out = fn(sd)
            calls.append(state_dict_to_flax(out))
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_train, "make_warm_start", spy)
        exp = cli_train.main([
            "--datadir", str(tmp_path / "data"), "--nclasses", "4",
            "--bs", "8", "--repetitions", "2", "--epochs", "1",
            "--savemodelfreq", "1", "--gschannels", "8,8,16",
            "--gspartdim", "16", "--expandlevel", "1", "--noaugment",
            "--mergefun", "sign_max", "--device", "cpu",
            "--initbranch", f"gray={sources['port']}@of",
            "--initepoch", "1", "--experdir", str(tmp_path / "exp")])
    assert len(calls) == 1 and ckpt.latest_checkpoint_step(exp) == 1
    src = _leaves(sources["trees"][1]["params"]["branch_of"])
    dst = _leaves(calls[0]["params"]["branch_gray"])
    assert all(np.array_equal(dst[k], src[k]) for k in src
               if src[k].shape == dst[k].shape)
    assert_same_tree(calls[0]["params"]["branch_of"],
                     _tree(_jcfg(nclasses=4), seed=0)["params"]["branch_of"])
