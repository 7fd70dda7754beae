"""A whole run of each traffic kind at tiny width on the CPU, past the
harness's look for a card: sound, ``correct`` is true; with the timed path
broken underneath, once for each fault the kind can have, it is false."""

import pytest
import torch

from conftest import tiny_cell, tiny_config
from portbench import run

SEED = 2 ** 31 + 2 ** 30 + 99


def execute(cell_name, seconds=0.5):
    cell = tiny_cell(cell_name)
    return run.execute(cell, tiny_config(cell["config"]), SEED, seconds,
                       False, device="cpu")


@pytest.mark.parametrize("cell", ["gaitset.train", "gaitset.encode_bf16"])
def test_sound_run_is_correct(cell):
    res = execute(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def test_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    res = execute("gaitset.train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch(monkeypatch):
    from ugaitnet_tpu_torch.train import train_step as TS
    real = TS.compute_losses

    def half(model, batch, *a, **k):
        n = batch.labels.shape[0] // 2
        return real(model, TS.Batch(tuple(v[:n] for v in batch.volumes),
                                    tuple(f[:n] for f in batch.use_flags),
                                    batch.labels[:n]), *a, **k)
    monkeypatch.setattr(TS, "compute_losses", half)
    assert not execute("gaitset.train")["correct"]


def test_train_sampler_repeats_a_row(monkeypatch):
    """A sampler fault both sides would be fed alike: the reference takes
    the program's rows, so only the sampler's own check sees it."""
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    real = BalancedGaitSampler.next_batch

    def repeat(self):
        idx = real(self)
        idx[1] = idx[0]
        return idx
    monkeypatch.setattr(BalancedGaitSampler, "next_batch", repeat)
    res = execute("gaitset.train")
    assert not res["correct"]
    assert res["checks"]["sampler_faults"]["value"] > 0


def test_train_fault_readings():
    """--readings 1 reads the planted faults that set the train limits'
    upper readings: the reference on half of each batch, and a state left
    unchanged (1 by the change measure)."""
    cell = tiny_cell("gaitset.train")
    res = run.execute(cell, tiny_config(cell["config"]), SEED, 0.5, False,
                      device="cpu", readings=True)
    assert res["correct"], res["checks"]
    half = res["extra"]["fault.half_batch"]
    frozen = res["extra"]["fault.frozen"]
    assert frozen["change_gap"] == pytest.approx(1.0)
    assert half["grad_gap"] > 10 * res["checks"]["grad_gap"]["value"]


def test_encode_fp8_control_runs_through_the_check():
    """--control fp8 judges the fp8 reference's codes in the program's
    place: a reading of its own, above the sound run's."""
    cell = tiny_cell("gaitset.encode_bf16")
    cfg = tiny_config(cell["config"])
    sound = run.execute(cell, cfg, SEED, 0.5, False, device="cpu")
    fp8 = run.execute(cell, cfg, SEED, 0.5, False, device="cpu",
                      control="fp8")
    assert (fp8["checks"]["code_err"]["value"]
            > 2 * sound["checks"]["code_err"]["value"])


def _patch_tap(monkeypatch, fault):
    from ugaitnet_tpu_torch.eval import encode as E
    real = E._tap

    def tap(out, typecode):
        x = real(out, typecode).clone()
        fault(x)
        return x
    monkeypatch.setattr(E, "_tap", tap)


def test_encode_answer_altered(monkeypatch):
    def alter(x):
        x[0] = x[0] * 1.5
    _patch_tap(monkeypatch, alter)
    assert not execute("gaitset.encode_bf16")["correct"]


def test_encode_half_batch(monkeypatch):
    def drop(x):
        x[x.shape[0] // 2:] = 0.0
    _patch_tap(monkeypatch, drop)
    assert not execute("gaitset.encode_bf16")["correct"]

