"""The plain reference against the port at tiny width on the CPU: the
forward pass, the input path with its draws, the triplet loss and three
train steps agree within float32 rounding."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell, tiny_config
from portbench import traffic
from portbench.drivers.train import (make_dataset, program_configs,
                                     reference_batches)
from portbench.harness import build_model, model_config
from portbench.reference import data as RD
from portbench.reference import judge as J
from portbench.reference import model as RM
from portbench.reference import train as RT

MODS = ("of", "gray")


def raw_batch(n, seed):
    clips = traffic.make_clips(seed, n, "cpu")
    raw = {f"raw_{m}": torch.from_numpy(v) for m, v in clips.items()}
    raw.update(present_of=torch.ones(n), present_gray=torch.ones(n),
               labels=torch.arange(n) // 2)
    return raw


@pytest.mark.parametrize("config", ["gaitset_of_gray", "cnn3d_of_gray"])
def test_forward(config):
    cfg = tiny_config(config)
    model, W = build_model(model_config(cfg), 3, "cpu")
    raw = raw_batch(4, 3)
    raw["present_gray"] = torch.tensor([1.0, 0.0, 1.0, 1.0])
    vols, flags, _ = RD.preprocess(raw, MODS, None, False, 1)
    with torch.no_grad():
        got = model(vols, flags, train=False)
        want = RM.forward(cfg["model"], W, vols, flags)
    for k in ("signature", "flatten"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got["classprob_logits"], want["logits"],
                               rtol=1e-4, atol=1e-5)


def test_input_path_with_draws():
    """The reference draws the program's augmentation and dropout stream
    (batch_generator) and builds the same batch, to the bit: the train
    checks' gradient norms move by ~1e-3 when an input moves by an ulp."""
    from ugaitnet_tpu_torch.data.pipeline import batch_generator
    cell, cfg = tiny_cell("gaitset.train"), tiny_config("gaitset_of_gray")
    p = cell["params"]
    ds, arr = make_dataset(p, 9, "cpu")
    from ugaitnet_tpu_torch.data.pipeline import GaitPipeline
    dcfg, _ = program_configs(cfg, p)
    pipe = GaitPipeline(ds, dcfg, MODS, labmap=ds.label_map(), device="cpu")
    idx = np.array([0, 1, 11, 12, 20, 21, 30, 31])
    got = pipe.load(idx, batch_generator(9, 0, 2))
    want = reference_batches(arr, [idx, idx, idx], p, MODS, 9, "cpu")[2]
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w)
    torch.testing.assert_close(got[2].long(), want[2].long())


def test_triplet_matches_program():
    from ugaitnet_tpu_torch.ops.triplet import batch_all_triplet_loss
    g = torch.Generator().manual_seed(1)
    sig = torch.randn(12, 5, 16, generator=g)
    labels = torch.arange(12) // 3
    torch.testing.assert_close(RT.batch_all(sig, labels, 0.2),
                               batch_all_triplet_loss(sig, labels, 0.2),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config", ["gaitset_of_gray", "cnn3d_of_gray"])
def test_three_train_steps(config):
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    cfg = tiny_config(config)
    cell = tiny_cell("gaitset.train")
    mcfg = model_config(cfg)
    model, W = build_model(mcfg, 4, "cpu")
    _, tcfg = program_configs(cfg, cell["params"])
    state, step = init_state(model, tcfg), make_train_step(mcfg, tcfg)
    batches = []
    for i in range(3):
        raw = raw_batch(8, 40 + i)
        batches.append(RD.preprocess(raw, MODS, RD.batch_generator(4, 0, i),
                                     True, 3))
    losses = [float(step(state, Batch(tuple(v), tuple(f), l))[1]["loss"])
              for v, f, l in batches]
    ref = RT.follow(cfg["model"], cfg["train"], W, batches)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    change = {k: float((q.detach() - W[k]).norm())
              for k, q in model.named_parameters()}
    gap, _ = J.norm_gap(change, ref["change"])
    assert gap < 1e-2


def test_train_readings_median_leaf():
    """One small leaf's gap moves the worst-leaf change, not the median
    leaf's; a state left unchanged reads about 1 on both."""
    ref = {"losses": [2.0, 1.0], "grad_norms": {k: 1.0 for k in "abcde"},
           "change": {"a": 1.0, "b": 2.0, "c": 3.0, "d": 4.0, "e": 0.1}}
    prog = dict(ref, losses=[2.0, 1.001], change=dict(ref["change"], e=0.2))
    r = J.train_readings(prog, ref)
    assert r["loss_gap"] == pytest.approx(1e-3)
    assert r["loss_gap_first"] == 0.0
    assert r["change_gap"] == pytest.approx(0.05)
    assert r["change_gap_median"] == 0.0
    frozen = dict(ref, change={k: 0.0 for k in ref["change"]})
    assert J.train_readings(frozen, ref)["change_gap_median"] == 1.0


def test_merged_error_tie_rule():
    a = torch.tensor([[[1.0, -2.0, 0.5]]])
    b = torch.tensor([[[-1.001, 1.0, 0.1]]])
    scale = torch.ones(1, 1, 3)
    # element 0 is a near tie: either branch is accepted
    assert float(J.merged_error(torch.tensor([[-1.001, -2.0, 0.5]]), a, b,
                                scale, 0.01)) == 0.0
    assert float(J.merged_error(torch.tensor([[1.0, -2.0, 0.5]]), a, b,
                                scale, 0.01)) == 0.0
    # element 1 is not: the wrong branch is an error
    assert float(J.merged_error(torch.tensor([[1.0, 1.0, 0.5]]), a, b,
                                scale, 0.01)) > 0.5



def _sampler_epoch(ids, cameras, batch, repetition, seed=3):
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    cols = traffic.casiab_columns(ids, cameras, 1)
    s = BalancedGaitSampler(cols["labels"], cols["gaits"], batch,
                            repetition, seed=seed)
    return cols, [np.array(b) for b in s.epoch()]


@pytest.mark.parametrize("shape", [(74, 11, 40, 5), (4, 1, 8, 2),
                                   (6, 2, 14, 3)])
def test_sampler_faults_none_on_the_program_sampler(shape):
    ids, cameras, batch, rep = shape
    cols, epoch = _sampler_epoch(*shape)
    _, second = _sampler_epoch(*shape, seed=4)
    assert J.sampler_faults([epoch, second[:5]], cols["labels"],
                            cols["gaits"], batch, rep) == 0


def _planted(kind, cols, epoch):
    labels, gaits = cols["labels"], cols["gaits"]
    epoch = [b.copy() for b in epoch]
    b = epoch[2]
    if kind == "repeat":
        b[1] = b[0]
    elif kind == "out_of_range":
        b[-1] = len(labels)
    elif kind == "short":
        epoch[2] = b[:-1]
    elif kind == "composition":
        # one row of the first subject becomes another subject's row
        other = np.flatnonzero(labels != labels[b[0]])
        b[0] = next(i for i in other if i not in b)
    elif kind == "gait":
        # two of the first subject's gait-0 rows become its own rows of
        # gait 1: its 4 / 3 / 3 draws turn 2 / 5 / 3
        s = labels[b[0]]
        for j in (0, 3):
            assert gaits[b[j]] == 0 and labels[b[j]] == s
            b[j] = next(i for i in np.flatnonzero(
                (labels == s) & (gaits == 1)) if i not in b)
    elif kind == "starved":
        # subject s is never drawn: its rows go to a subject t that shares
        # no batch with it, row for row of the same gait, so every batch
        # keeps its design and only the epoch's balance breaks
        s = labels[epoch[0][0]]
        with_s = [k for k, bb in enumerate(epoch) if s in labels[bb]]
        t = next(u for u in np.unique(labels)
                 if all(u not in labels[epoch[k]] for k in with_s))
        for k in with_s:
            bb = epoch[k]
            for j in np.flatnonzero(labels[bb] == s):
                bb[j] = next(i for i in np.flatnonzero(
                    (labels == t) & (gaits == gaits[bb[j]])) if i not in bb)
    return epoch


@pytest.mark.parametrize("kind", ["repeat", "out_of_range", "short",
                                  "composition", "gait", "starved"])
def test_sampler_faults_planted(kind):
    cols, epoch = _sampler_epoch(74, 11, 40, 5)
    faults = J.sampler_faults([_planted(kind, cols, epoch)], cols["labels"],
                              cols["gaits"], 40, 5)
    assert faults == 1 if kind in ("starved", "gait") else faults >= 1
