"""The port's Trainer against the JAX package's, on the CPU.

Both trainers run the tiny two-branch config of ``tests/test_trainer.py``
(gaitset channels (4, 4, 8), part_dim 8, sign_max, 4 classes, batch 8) on
the same synthetic set, with ``augment=False`` and ``expand_level=1`` so no
batch draws anything random, from the same initial weights (the JAX
``warm_start`` and the port's, through the weight bridge).  The JAX run has
its ``pairwise_dist`` diagonal zeroed, as ``tests/test_torch_train.py``
does (ROADMAP.md section 3); ``test_unpatched_reference_epoch`` holds the
port to the JAX trainer as it is.

Tolerances, with the values measured on this CPU (torch on one thread):
  * per-epoch train/val/fine-tune losses and accuracies, val EER: rtol 1e-4
    (measured <= 7.8e-7 relative over 7 steps: float32 forwards and Adam
    updates of two frameworks round differently).
  * weights after the 7 steps: abs 1e-4 (measured 7.7e-6).
  * unpatched JAX trainer, epoch 1: |port - JAX as is| <= |JAX zeroed -
    JAX as is| + RTOL |JAX as is| per loss, with both JAX runs made here.
    The diagonal residue comes from the BLAS's summation order, not from
    the inputs, so its effect differs between machines (2.54e-3 relative
    on train/loss on one CPU, 7.5e-5 on another); the limit is that
    effect on the machine that runs the test, never a constant from
    another.
  * resume against an uninterrupted run: abs 1e-6, the JAX kill-and-resume
    test's limit (measured 0: the CPU replays the same arithmetic); each
    planted fault must exceed it.
"""

import dataclasses
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.core import checkpoint as jckpt
from ugaitnet_tpu.core.config import BranchConfig as JBranch
from ugaitnet_tpu.core.config import DataConfig as JDataConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import trainer as JTR
from ugaitnet_tpu.train.train_step import get_lr as j_get_lr

from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.obsv.logger import MetricsLogger, read_metrics
from ugaitnet_tpu_torch.train import trainer as TR
from ugaitnet_tpu_torch.train.train_step import get_lr
from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict

torch.set_num_threads(1)

RTOL = 1e-4
WEIGHT_ATOL = 1e-4
RESUME_ATOL = 1e-6
VAL_PERC = 0.3


def _jcfgs(epochs=2, extra=0):
    b = dict(kind="gaitset", gaitset_channels=(4, 4, 8), part_dim=8)
    mcfg = JModelConfig(branches=(JBranch(modality="of", **b),
                                  JBranch(modality="gray", **b)),
                        merge="sign_max", nclasses=4)
    dcfg = JDataConfig(batch_size=8, expand_level=1, repetitions=2,
                       augment=False)
    tcfg = JTrainConfig(lr=1e-3, epochs=epochs, extra_epochs=extra,
                        save_every_epochs=1, loss_weights=(1.0, 0.1))
    return mcfg, dcfg, tcfg


def _tcfgs(mcfg, dcfg, tcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in mcfg.branches)
    kw = {k: v for k, v in vars(mcfg).items() if k != "branches"}
    return (tconfig.ModelConfig(branches=branches, **kw),
            tconfig.DataConfig(**vars(dcfg)), tconfig.TrainConfig(**vars(tcfg)))


def _datasets(videos_per_subject=3):
    kw = dict(num_subjects=4, videos_per_subject=videos_per_subject,
              subseqs_per_video=2, seed=1)
    return j_synth(**kw), make_synthetic_dataset(**kw)


@pytest.fixture(scope="module")
def init_params_np():
    mcfg, _, _ = _jcfgs()
    params = init_params(JNet(mcfg), jax.random.PRNGKey(0), batch=2)
    return jax.tree_util.tree_map(np.asarray, params)


def _exact_diagonal_dist(x, squared=False, _orig=JT.pairwise_dist):
    d = _orig(x, squared)
    return jnp.where(jnp.eye(d.shape[-1], dtype=bool), 0.0, d)


def _jax_fit(experdir, params, epochs, extra, patched=True):
    mcfg, dcfg, tcfg = _jcfgs(epochs, extra)
    jds, _ = _datasets()
    with pytest.MonkeyPatch.context() as mp:
        if patched:
            mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        t = JTR.Trainer(mcfg, dcfg, tcfg, experdir, warm_start=lambda p: (
            jax.tree_util.tree_map(jnp.asarray, params)))
        state = t.fit(jds, val_perc=VAL_PERC)
    return read_metrics(experdir), state


def _port_fit(experdir, params, epochs, extra):
    mcfg, dcfg, tcfg = _tcfgs(*_jcfgs(epochs, extra))
    _, tds = _datasets()
    t = TR.Trainer(mcfg, dcfg, tcfg, experdir, device="cpu",
                   warm_start=lambda sd: flax_to_state_dict(params))
    state = t.fit(tds, val_perc=VAL_PERC)
    return read_metrics(experdir), state


def _by_epoch(records, key):
    return {int(r["step"]): r[key] for r in records if key in r}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_params_np):
    """Two main epochs and one fine-tune epoch of both trainers."""
    root = tmp_path_factory.mktemp("trainer_parity")
    jrec, jstate = _jax_fit(str(root / "jax"), init_params_np, 2, 1)
    trec, tstate = _port_fit(str(root / "port"), init_params_np, 2, 1)
    return dict(root=root, jrec=jrec, trec=trec, jstate=jstate,
                tstate=tstate)


@pytest.mark.parametrize("key", ["train/loss", "train/acc", "train/triplet",
                                 "train/id_ce", "train/lr", "val/loss",
                                 "val/acc", "val/eer", "finetune/loss"])
def test_epoch_metrics_match_jax(runs, key):
    want, got = _by_epoch(runs["jrec"], key), _by_epoch(runs["trec"], key)
    assert want and set(got) == set(want), (key, want, got)
    for e in want:
        np.testing.assert_allclose(got[e], want[e], rtol=RTOL, atol=1e-7,
                                   err_msg=f"{key} epoch {e}")


def test_checkpointed_epochs_match_jax(runs):
    root = runs["root"]
    want = sorted(os.listdir(root / "jax" / "ckpt"))
    got = sorted(os.listdir(root / "port" / "ckpt"))
    assert got == want == ["1", "2", "3", "best"]
    assert ckpt.latest_checkpoint_step(str(root / "port")) == \
        jckpt.latest_checkpoint_step(str(root / "jax")) == 3
    assert json.load(open(root / "port" / "controller.json")).keys() == \
        json.load(open(root / "jax" / "controller.json")).keys()


def test_final_weights_match_jax(runs):
    """After 7 Adam steps (lr 1e-3) the port's weights sit where the JAX
    trainer's do."""
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, runs["jstate"].params))
    got = runs["tstate"].model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
    assert get_lr(runs["tstate"]) == j_get_lr(runs["jstate"])


def test_projector_exports_match_jax(runs):
    """Per validated epoch both trainers export the same labels, codes
    within RTOL, and the same sprite sheet of middle-frame thumbnails."""
    from PIL import Image
    root = runs["root"]
    want = sorted(os.listdir(root / "jax" / "projector"))
    assert sorted(os.listdir(root / "port" / "projector")) == want
    assert want == ["signatures_00001", "signatures_00002"]
    for d in want:
        j, t = root / "jax" / "projector" / d, root / "port" / "projector" / d
        assert (t / "metadata.tsv").read_text() == \
            (j / "metadata.tsv").read_text()
        np.testing.assert_allclose(np.load(t / "codes.npy"),
                                   np.load(j / "codes.npy"), rtol=RTOL,
                                   atol=1e-6)
        assert np.array_equal(np.asarray(Image.open(t / "sprite.png")),
                              np.asarray(Image.open(j / "sprite.png")))
    assert sorted(os.listdir(root / "port" / "filters")) == \
        sorted(os.listdir(root / "jax" / "filters"))


def test_unpatched_reference_epoch(tmp_path, init_params_np, runs):
    """The JAX trainer as it is (diagonal residue and all), one epoch.  The
    limit is the residue's own effect in this run: the gap between the
    JAX trainer with its diagonal zeroed (the module's run, epoch 1) and
    as it is, plus RTOL.  The port must also sit within RTOL of the zeroed
    run, the gap the residue explains."""
    jrec, _ = _jax_fit(str(tmp_path / "jax"), init_params_np, 1, 0,
                       patched=False)
    for key in ("train/loss", "train/triplet", "val/loss"):
        as_is = _by_epoch(jrec, key)[1]
        zeroed = _by_epoch(runs["jrec"], key)[1]
        got = _by_epoch(runs["trec"], key)[1]
        np.testing.assert_allclose(got, zeroed, rtol=RTOL, err_msg=key)
        limit = abs(zeroed - as_is) + RTOL * abs(as_is)
        assert abs(got - as_is) <= limit, (key, got, as_is, zeroed)


# --- controllers: plateau, best, early stop (epochs faked, both packages) --

def _fake_epochs(mp, cls, accs, losses):
    """Replace one epoch of training with given metrics (the state stays
    as it is), and validation with a flat or scripted val loss."""
    it = iter(zip(accs, losses))

    def epoch(self, state, pipe, sampler, epoch, seed):
        acc, loss = next(it)
        return state, {"loss": loss, "acc": acc}

    mp.setattr(cls, "_epoch", epoch)
    mp.setattr(cls, "_validate", lambda self, state, ds, idx, epoch=0: {})


def _controller_run(pkg, experdir, params, epochs, accs, losses, val):
    """Fit with faked epochs; returns (lr per epoch, checkpoint dirs)."""
    mod = JTR if pkg == "jax" else TR
    with pytest.MonkeyPatch.context() as mp:
        _fake_epochs(mp, mod.Trainer, accs, losses)
        vals = iter(val)
        mp.setattr(mod.Trainer, "_val_metrics",
                   lambda self, state, pipe: {"loss": next(vals)})
        if pkg == "jax":
            mcfg, dcfg, tcfg = _jcfgs(epochs)
            state = mod.Trainer(mcfg, dcfg, tcfg, experdir,
                                warm_start=lambda p: p).fit(
                _datasets()[0], val_perc=VAL_PERC)
            lr = j_get_lr(state)
        else:
            mcfg, dcfg, tcfg = _tcfgs(*_jcfgs(epochs))
            state = mod.Trainer(mcfg, dcfg, tcfg, experdir, device="cpu").fit(
                _datasets()[1], val_perc=VAL_PERC)
            lr = get_lr(state)
    return (lr, sorted(os.listdir(os.path.join(experdir, "ckpt"))),
            _by_epoch(read_metrics(experdir), "train/lr"))


def test_plateau_drops_match_jax(tmp_path, init_params_np):
    """A flat val loss drops the lr after patience 3; a restart keeps the
    reduced lr and the plateau counters, in both packages."""
    out = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        first = _controller_run(pkg, d, init_params_np, 5, [0.1] * 5,
                                [1.0] * 5, [1.0] * 5)
        second = _controller_run(pkg, d, init_params_np, 8, [0.1] * 3,
                                 [1.0] * 3, [1.0] * 3)
        out[pkg] = (first, second, read_metrics(d))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    lrs = _by_epoch(out["port"][2], "train/lr")
    assert lrs[5] < lrs[4] == lrs[1], lrs          # dropped after patience
    assert lrs[8] < lrs[7] == lrs[5], lrs           # and again after resume


def test_best_slot_matches_jax(tmp_path, init_params_np):
    """'best' follows the minimum of the monitored val loss."""
    val = [3.0, 1.0, 2.0, 2.5]
    out = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        _controller_run(pkg, d, init_params_np, 4, [0.1] * 4, [1.0] * 4, val)
        out[pkg] = json.load(open(os.path.join(d, "controller.json")))
    assert out["port"] == out["jax"]
    assert out["port"]["best_monitor"] == 1.0


def test_early_stop_matches_jax_and_survives_restart(tmp_path,
                                                     init_params_np):
    out = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        first = _controller_run(pkg, d, init_params_np, 5,
                                [0.5, 0.995, 1.0, 1.0, 1.0], [1.0] * 5,
                                [1.0] * 5)
        # a restart must not re-enter the main loop: any faked epoch would
        # raise StopIteration from the empty script
        second = _controller_run(pkg, d, init_params_np, 5, [], [], [])
        out[pkg] = (first, second,
                    json.load(open(os.path.join(d, "controller.json"))))
    assert out["port"] == out["jax"]
    assert out["port"][0][1] == ["1", "2", "best"]      # stopped at epoch 2
    assert out["port"][2]["early_stopped"] is True


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_controller_never_ahead_of_checkpoints(tmp_path, monkeypatch,
                                               async_ckpt):
    """Every controller.json the trainer publishes describes checkpoints
    already on disk, so a kill right after it never resumes an older
    checkpoint under a newer record.  Saves every 2 epochs; the early stop
    at epoch 3 falls between them; each write is slowed so an async one is
    still in flight while the loop goes on."""
    real_publish, real_write = ckpt._publish, TR._write_json

    def slow_publish(path, payload):
        time.sleep(0.2)
        return real_publish(path, payload)

    seen = []

    def write(path, rec):
        seen.append((ckpt.latest_checkpoint_step(os.path.dirname(path)),
                     rec["early_stopped"]))
        real_write(path, rec)

    monkeypatch.setattr(ckpt, "_publish", slow_publish)
    monkeypatch.setattr(TR, "_write_json", write)
    _fake_epochs(monkeypatch, TR.Trainer, [0.5, 0.5, 0.995, 1.0, 1.0],
                 [1.0] * 5)
    monkeypatch.setattr(TR.Trainer, "_val_metrics",
                        lambda self, state, pipe: {"loss": 1.0})
    mcfg, dcfg, tcfg = _tcfgs(*_jcfgs(5))
    tcfg = dataclasses.replace(tcfg, save_every_epochs=2,
                               async_checkpoint=async_ckpt)
    TR.Trainer(mcfg, dcfg, tcfg, str(tmp_path), device="cpu").fit(
        _datasets()[1], val_perc=VAL_PERC)
    assert seen == [(2, False), (3, True)]
    assert json.load(open(tmp_path / "controller.json"))["early_stopped"]


# --- resume -------------------------------------------------------------

def _losses(experdir):
    return _by_epoch(read_metrics(experdir), "train/loss")


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """An uninterrupted 2-epoch run, and a 1-epoch run restarted to 2, with
    and without each planted fault, all without a validation split, on 16
    clips (2 steps an epoch)."""
    root = tmp_path_factory.mktemp("resume")

    def fit(name, epochs):
        mcfg, dcfg, tcfg = _tcfgs(*_jcfgs(epochs))
        tcfg = dataclasses.replace(tcfg, async_checkpoint=True)
        t = TR.Trainer(mcfg, dcfg, tcfg, str(root / name), device="cpu")
        return t.fit(_datasets(videos_per_subject=2)[1], val_perc=0.0)

    full = fit("full", 2)
    fit("resumed", 1)
    for fault in ("no_fast_forward", "optimizer_dropped"):
        shutil.copytree(root / "resumed", root / fault)
    state = fit("resumed", 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR.Trainer, "_fast_forward", staticmethod(
            lambda sampler, epochs: None))
        fit("no_fast_forward", 2)
    with pytest.MonkeyPatch.context() as mp:
        real = ckpt.restore_checkpoint

        def model_only(experdir, step, state):
            fresh = state.optimizer.state_dict()
            real(experdir, step, state)
            state.optimizer.load_state_dict(fresh)
            return state
        mp.setattr(ckpt, "restore_checkpoint", model_only)
        fit("optimizer_dropped", 2)
    return root, full, state


def test_resume_equals_uninterrupted(resumed):
    root, full, state = resumed
    want, got = _losses(root / "full"), _losses(root / "resumed")
    assert set(got) == set(want) == {1, 2}
    for e in want:
        assert abs(got[e] - want[e]) <= RESUME_ATOL, (e, got[e], want[e])
    for k, v in full.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert state.step == full.step == 4


@pytest.mark.parametrize("fault", ["no_fast_forward", "optimizer_dropped"])
def test_resume_planted_faults_fail_the_limit(resumed, fault):
    root, _, _ = resumed
    want, got = _losses(root / "full"), _losses(root / fault)
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) > RESUME_ATOL, (fault, got[2], want[2])


def _conv2d_cfgs(epochs):
    mcfg, dcfg, tcfg = _jcfgs(epochs)
    b = dict(kind="conv2d", filters_numbers=(8, 8, 16, 16), ndense_units=16,
             dropout=0.4)
    mcfg = dataclasses.replace(mcfg, branches=(
        JBranch(modality="of", **b), JBranch(modality="gray", **b)))
    return _tcfgs(mcfg, dcfg, tcfg)


def _process_stream_dropout(self, x, key):
    """Planted fault: masks from a generator seeded once per branch
    instance (so once per process), whatever the step."""
    gen = self.__dict__.setdefault(
        "_fault_gen", torch.Generator().manual_seed(self._drop_seed))
    keep = 1.0 - self.dropout
    mask = torch.rand(x.shape, generator=gen) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@pytest.mark.parametrize("fault", [None, "process_stream"])
def test_resume_conv2d_dropout(tmp_path, monkeypatch, fault):
    """A 2D CNN run with dropout 0.4 restarted from its epoch-1 checkpoint
    repeats the uninterrupted run's epoch-2 loss within RESUME_ATOL: its
    masks are keyed by the step count, which the checkpoint holds.  With
    masks from a per-process stream (the planted fault) the restarted run
    redraws epoch 1's masks and misses the limit."""
    from ugaitnet_tpu_torch.models.branches import Conv2DBranch
    if fault:
        monkeypatch.setattr(Conv2DBranch, "_dropout", _process_stream_dropout)

    def fit(name, epochs):
        mcfg, dcfg, tcfg = _conv2d_cfgs(epochs)
        t = TR.Trainer(mcfg, dcfg, tcfg, str(tmp_path / name), device="cpu")
        return t.fit(_datasets(videos_per_subject=2)[1], val_perc=0.0)

    full = fit("full", 2)
    fit("resumed", 1)
    state = fit("resumed", 2)
    want, got = _losses(tmp_path / "full"), _losses(tmp_path / "resumed")
    assert set(got) == set(want) == {1, 2} and got[1] == want[1]
    if fault:
        assert abs(got[2] - want[2]) > RESUME_ATOL, (got[2], want[2])
        return
    assert abs(got[2] - want[2]) <= RESUME_ATOL, (got[2], want[2])
    for k, v in full.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


# --- names and logging --------------------------------------------------

def test_experiment_name_matches_jax():
    jcfgs = _jcfgs()
    for kw in ({}, {"optimizer": "sgd"}, {"triplet_kind": "semi_hard"}):
        j = (jcfgs[0], jcfgs[1], dataclasses.replace(jcfgs[2], **kw))
        assert TR.experiment_name(*_tcfgs(*j), prefix="x") == \
            JTR.experiment_name(*j, prefix="x")


def test_metrics_logger_strict_json_on_nonfinite(tmp_path):
    lg = MetricsLogger(str(tmp_path))
    lg.log(3, {"loss": 1.5, "eer": float("nan"), "peak": float("inf"),
               "step": 99, "time": -1.0})
    lg.close()
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write('{"torn": ')                          # a crash mid-write
    line = open(tmp_path / "metrics.jsonl").read().splitlines()[0]
    assert "NaN" not in line and "Infinity" not in line
    rec = json.loads(line)
    assert rec["loss"] == 1.5 and rec["step"] == 3 and rec["time"] > 0
    assert rec["eer"] is None and rec["peak"] is None
    assert read_metrics(str(tmp_path)) == [rec]


def test_filter_grid_and_sprite_match_jax(tmp_path):
    """save_filter_grid on the port's OIHW weight draws the JAX package's
    grid of the HWIO kernel the weight bridge makes of it; the sprite sheet
    of the same thumbnails is the same image."""
    from PIL import Image

    from ugaitnet_tpu.utils import net_utils as JU
    from ugaitnet_tpu_torch.utils import net_utils as TU
    rng = np.random.RandomState(0)
    for shape in ((32, 2, 5, 5), (8, 1, 3, 3), (4, 2, 3, 5, 5)):
        w = rng.randn(*shape).astype(np.float32)
        hwio = w.transpose(*range(2, w.ndim), 1, 0)
        a = TU.save_filter_grid(w, str(tmp_path / "port" / f"{w.ndim}.png"))
        b = JU.save_filter_grid(hwio, str(tmp_path / "jax" / f"{w.ndim}.png"))
        assert np.array_equal(np.asarray(Image.open(a)),
                              np.asarray(Image.open(b)))
    thumbs = [rng.rand(60, 60).astype(np.float32) for _ in range(7)]
    a = TU.save_sprite(thumbs, str(tmp_path / "s_port.png"), max_size=256)
    b = JU.save_sprite(thumbs, str(tmp_path / "s_jax.png"), max_size=256)
    assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def test_profile_writes_a_trace(tmp_path):
    from ugaitnet_tpu_torch.obsv.logger import profile
    with profile(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]
    with profile(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")
