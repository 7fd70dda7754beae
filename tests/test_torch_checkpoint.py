"""The port's torch checkpoints (``core/checkpoint.py``), on the CPU: bitwise
save/restore of model, optimizer and step; surgery across ``nclasses``; the
async writer's round trip, overlapping saves and error propagation; a
process killed mid-publish leaves no step ``latest_checkpoint_step`` picks
up; every file loads with ``torch.load(weights_only=True)``."""

import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.train.train_step import TrainState, init_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mcfg(**kw):
    j = graft._flagship_cfg(tiny=True)
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in j.branches)
    return dataclasses.replace(tconfig.ModelConfig(**{**vars(j),
                                                      "branches": branches}),
                               **kw)


def _trained_state(optimizer="adam", seed=0, steps=2):
    """A state whose optimizer holds moments: a few steps on a cheap loss."""
    model = UGaitNet(_mcfg(), device="cpu", seed=seed)
    state = init_state(model, tconfig.TrainConfig(optimizer=optimizer,
                                                  lr=1e-3))
    for _ in range(steps):
        state.optimizer.zero_grad()
        sum((p * p).sum() for p in model.parameters()).backward()
        state.optimizer.step()
        state.step += 1
    return state


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _assert_same_state(a: TrainState, b: TrainState):
    assert a.step == b.step
    for x, y in ((a.model.state_dict(), b.model.state_dict()),
                 (a.optimizer.state_dict(), b.optimizer.state_dict())):
        fx, fy = _flat(x), _flat(y)
        assert fx.keys() == fy.keys()
        for k in fx:
            if isinstance(fx[k], torch.Tensor):
                assert fx[k].dtype == fy[k].dtype and torch.equal(
                    fx[k], fy[k]), k
            else:
                assert fx[k] == fy[k], k


@pytest.mark.parametrize("optimizer", ["adam", "amsgrad", "sgd"])
def test_save_restore_bitwise(tmp_path, optimizer):
    state = _trained_state(optimizer)
    path = ckpt.save_checkpoint(str(tmp_path), 3, state)
    assert path == os.path.join(str(tmp_path), "ckpt", "3", "state.pt")
    fresh = init_state(UGaitNet(_mcfg(), device="cpu", seed=7),
                       tconfig.TrainConfig(optimizer=optimizer, lr=1e-3))
    ckpt.restore_checkpoint(str(tmp_path), 3, fresh)
    _assert_same_state(fresh, state)
    # restored moments keep training exactly as the original would
    for s in (state, fresh):
        s.optimizer.zero_grad()
        sum((p * p).sum() for p in s.model.parameters()).backward()
        s.optimizer.step()
    _assert_same_state(fresh, state)


def test_weights_only_load_and_layout(tmp_path):
    state = _trained_state()
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    ckpt.save_checkpoint(str(tmp_path), "best", state)
    raw = torch.load(ckpt.checkpoint_path(str(tmp_path), "best"),
                     weights_only=True)
    assert set(raw) == {"step", "model", "optimizer"} and raw["step"] == 2
    assert all(t.device.type == "cpu" for t in _flat(raw).values()
               if isinstance(t, torch.Tensor))
    assert ckpt.restore_raw(str(tmp_path), 1)["step"] == 2
    assert ckpt.has_best_checkpoint(str(tmp_path))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "best"]


def test_latest_step_counts_published_digit_dirs(tmp_path):
    assert ckpt.latest_checkpoint_step(str(tmp_path)) is None
    state = _trained_state(steps=0)
    for step in (1, 5, 12):
        ckpt.save_checkpoint(str(tmp_path), step, state)
    ckpt.save_checkpoint(str(tmp_path), "best", state)
    os.makedirs(tmp_path / "ckpt" / "20")          # no state.pt: unpublished
    os.makedirs(tmp_path / "ckpt" / "7x")
    assert ckpt.latest_checkpoint_step(str(tmp_path)) == 12
    assert ckpt.latest_checkpoint_step(str(tmp_path), epoch_max=11) == 5
    assert not ckpt.has_best_checkpoint(str(tmp_path / "other"))


def test_surgery_across_nclasses(tmp_path):
    src = UGaitNet(_mcfg(nclasses=5), device="cpu", seed=1)
    ckpt.save_checkpoint(str(tmp_path), 4, src)
    tgt = UGaitNet(_mcfg(nclasses=9), device="cpu", seed=2)
    merged = ckpt.restore_params_surgery(str(tmp_path), 4, tgt.state_dict())
    tgt.load_state_dict(merged)
    for k, v in tgt.state_dict().items():
        if k.startswith("classprob"):         # (9, F) head kept fresh
            assert torch.equal(v, UGaitNet(_mcfg(nclasses=9), device="cpu",
                                           seed=2).state_dict()[k])
        else:
            assert torch.equal(v, src.state_dict()[k]), k


def test_merge_matching_trees():
    t = {"a": torch.zeros(2), "b": [torch.zeros(3), torch.zeros(1)],
         "c": torch.zeros(4), "d": 7}
    s = {"a": torch.ones(2), "b": [torch.ones(3), torch.ones(2)],
         "c": torch.ones(4, dtype=torch.float64)}
    m = ckpt.merge_matching(t, s)
    assert torch.equal(m["a"], torch.ones(2))
    assert torch.equal(m["b"][0], torch.ones(3))
    assert torch.equal(m["b"][1], torch.zeros(1))   # shape mismatch: kept
    assert m["c"].dtype == torch.float32 and m["d"] == 7


def test_async_round_trip_and_overlapping_saves(tmp_path):
    state = _trained_state()
    with ckpt.AsyncCheckpointWriter() as w:
        snaps = []
        for step in range(1, 6):                 # more saves than MAX_PENDING
            w.save(str(tmp_path), step, state)
            w.save(str(tmp_path), "best", state)
            snaps.append(ckpt.snapshot(state))
            # the live state moves on right after save() returns
            state.optimizer.zero_grad()
            sum((p * p).sum() for p in state.model.parameters()).backward()
            state.optimizer.step()
            state.step += 1
        w.wait()
        for step in range(1, 6):
            raw = ckpt.restore_raw(str(tmp_path), step)
            want = snaps[step - 1]
            assert raw["step"] == want["step"]
            for k, v in want["model"].items():
                assert torch.equal(raw["model"][k], v), (step, k)
        best = ckpt.restore_raw(str(tmp_path), "best")
        assert best["step"] == snaps[-1]["step"]
    assert ckpt.latest_checkpoint_step(str(tmp_path)) == 5
    assert not [f for f in os.listdir(tmp_path / "ckpt" / "best")
                if f != "state.pt"]


def test_async_write_error_is_raised_again(tmp_path):
    state = _trained_state(steps=0)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    w = ckpt.AsyncCheckpointWriter()
    w.save(str(blocker), 1, state)            # ckpt/ under a regular file
    with pytest.raises(OSError):
        w.wait()
    w.save(str(blocker), 2, state)
    deadline = time.time() + 60
    while not all(f.done() for f, _ in w._pending) and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(OSError):
        w.save(str(tmp_path), 3, state)       # the earlier failure surfaces
    assert ckpt.latest_checkpoint_step(str(tmp_path)) is None
    w.save(str(tmp_path), 3, state)
    w.close()
    assert ckpt.latest_checkpoint_step(str(tmp_path)) == 3


_KILL_MID_PUBLISH = textwrap.dedent("""
    import os, sys, torch
    sys.path.insert(0, {repo!r})
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    real_save = torch.save

    def save_then_die(obj, f):
        real_save(obj, f)      # the temporary file is written in full
        f.flush()
        os._exit(9)            # killed before the rename publishes it

    torch.save = save_then_die
    ckpt.save_checkpoint(sys.argv[1], sys.argv[2],
                         torch.nn.Linear(3, 2))
""")


@pytest.mark.parametrize("step", ["2", "best"])
def test_crash_mid_publish_leaves_no_step(tmp_path, step):
    ckpt.save_checkpoint(str(tmp_path), 1, torch.nn.Linear(3, 2))
    res = subprocess.run([sys.executable, "-c",
                          _KILL_MID_PUBLISH.format(repo=REPO),
                          str(tmp_path), step], timeout=120)
    assert res.returncode == 9
    assert ckpt.latest_checkpoint_step(str(tmp_path)) == 1
    assert not ckpt.has_best_checkpoint(str(tmp_path))
    left = os.listdir(tmp_path / "ckpt" / step)
    assert left and all(f.startswith(".state-") for f in left), left
