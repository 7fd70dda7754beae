"""The reader of the hand weight-gradient kernel's launches a step
(``portbench/metrics/wgrad_hand.train.py``) on hand-built registries; a
program without the registry, or without the counter, gives no reading.
On the card (``python -m pytest -q -m cuda portbench/tests``): a traced
tiny train run reads 2 launches a step in the 3D CNN's cell and nothing in
GaitSet's."""

import sys

import pytest

from test_portbench_spans import TRAIN_SNAP, card, registry, traced  # noqa: F401
from test_portbench_trace import read

WGRAD = "wgrad_hand.train"         # the 3D CNN's cell only


def test_wgrad_hand_reader(registry):
    """Launches of the hand weight-gradient kernel a step: 6 over the
    three steps of TRAIN_SNAP."""
    registry(dict(TRAIN_SNAP, counters=dict(TRAIN_SNAP["counters"],
                                            **{"conv3d.wgrad_hand": 6})))
    assert read(WGRAD, {"kind": "train"}) == pytest.approx(2.0)
    assert read(WGRAD, {"kind": "encode"}) is None


@pytest.mark.parametrize("snap", ["no counter", "no steps", "no registry"])
def test_wgrad_hand_reads_nothing_without_its_counter(registry, monkeypatch,
                                                      snap):
    """A program whose registry lacks the counter (one without the hand
    kernel) gives no reading, not 0."""
    rec = {"kind": "train"}
    if snap == "no counter":
        registry(TRAIN_SNAP)
    elif snap == "no steps":
        registry({"spans": [], "counters": {"conv3d.wgrad_hand": 2},
                  "dropped": 0})
    else:
        monkeypatch.setitem(sys.modules, "ugaitnet_tpu_torch.obsv.spans",
                            None)
    assert read(WGRAD, rec) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaitset.train", "cnn3d.train"])
def test_traced_train_reads_wgrad_launches(card, monkeypatch, name):
    # the 3D CNN's first conv of each branch: one hand weight-gradient
    # launch each a step, counted from autograd's thread
    res, _, _ = traced(monkeypatch, name, 4.0)
    assert res["metrics"].get(WGRAD, {}).get("value") == (
        2.0 if name == "cnn3d.train" else None)
