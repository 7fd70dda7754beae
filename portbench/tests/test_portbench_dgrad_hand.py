"""The reader of the hand input-gradient kernel's launches a step
(``portbench/metrics/dgrad_hand.train.py``) on hand-built registries; a
program without the registry, or without the counter, gives no reading.
On the card (``python -m pytest -q -m cuda portbench/tests``): a traced
tiny train run reads 6 launches a step in the 3D CNN's cell (conv1-conv3
of each branch: at the tiny run's 24 rows conv4's input is under the
kernel's size rule, which takes conv1-conv4 at the cell's 120) and nothing
in GaitSet's."""

import sys

import pytest

from test_portbench_spans import TRAIN_SNAP, card, registry, traced  # noqa: F401
from test_portbench_trace import read

DGRAD = "dgrad_hand.train"         # the 3D CNN's cell only


def test_dgrad_hand_reader(registry):
    """Launches of the hand input-gradient kernel a step: 18 over the
    three steps of TRAIN_SNAP."""
    registry(dict(TRAIN_SNAP, counters=dict(TRAIN_SNAP["counters"],
                                            **{"conv3d.dgrad_hand": 18})))
    assert read(DGRAD, {"kind": "train"}) == pytest.approx(6.0)
    assert read(DGRAD, {"kind": "encode"}) is None


@pytest.mark.parametrize("snap", ["no counter", "no steps", "no registry"])
def test_dgrad_hand_reads_nothing_without_its_counter(registry, monkeypatch,
                                                      snap):
    """A program whose registry lacks the counter (one without the hand
    kernel, as before it) gives no reading, not 0."""
    rec = {"kind": "train"}
    if snap == "no counter":
        registry(dict(TRAIN_SNAP, counters=dict(TRAIN_SNAP["counters"],
                                                **{"conv3d.wgrad_hand": 6})))
    elif snap == "no steps":
        registry({"spans": [], "counters": {"conv3d.dgrad_hand": 6},
                  "dropped": 0})
    else:
        monkeypatch.setitem(sys.modules, "ugaitnet_tpu_torch.obsv.spans",
                            None)
    assert read(DGRAD, rec) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaitset.train", "cnn3d.train"])
def test_traced_train_reads_dgrad_launches(card, monkeypatch, name):
    # conv1-conv3 of each branch at 24 rows: one hand input-gradient
    # launch each a step, counted from autograd's thread
    res, _, _ = traced(monkeypatch, name, 4.0)
    assert res["metrics"].get(DGRAD, {}).get("value") == (
        6.0 if name == "cnn3d.train" else None)
