"""The readers of the program's spans and counters
(``ugaitnet_tpu_torch/obsv/spans.py``) on hand-built registries, with every
number worked out by hand; a program without the registry gives no
reading.  On the card (``python -m pytest -q -m cuda portbench/tests``):
traced tiny encode and train runs report all seven readings, and the
encode spans account for the traced pass."""

import json
import sys

import pytest
import torch

from conftest import tiny_cell, tiny_config
from portbench import harness, run
from test_portbench_trace import read

ENCODE = ("gather_ms.encode", "launch_ms.encode", "readback_ms.encode",
          "collect_ms.encode")
TRAIN = ("queue_wait_ms.train", "pageable_copies.train",
         "step_host_ms.train")
MS = 1_000_000


def sp(name, start_ms, dur_ms, id=None, parent=None):
    return {"name": name, "start_ns": start_ms * MS,
            "end_ns": (start_ms + dur_ms) * MS, "id": id, "parent": parent,
            "tid": 1}


# one pass of two batches: gathers 6 + 8 ms, launches 2 + 3 (the second
# batch's in two pieces, as a mirrored encode makes), readbacks 20 + 18,
# collect 50
ENCODE_SNAP = {"spans": [
    sp("input.gather", 0, 6, (4, 0)),
    sp("input.preprocess", 6, 1, (4, 0), "encode.launch"),
    sp("encode.launch", 6, 2, (4, 0)),
    sp("encode.readback", 8, 20, (4, 0)),
    sp("input.gather", 28, 8, (4, 1)),
    sp("encode.launch", 36, 1, (4, 1)),
    sp("encode.launch", 37, 2, (4, 1)),
    sp("encode.readback", 39, 18, (4, 1)),
    sp("encode.collect", 57, 50, 4)],
    "counters": {}, "dropped": 0}

# three steps: queue waits 0.5 + 1.5 + 4 ms (one more at an epoch's end:
# 2), steps 30 + 40 + 50 ms with their phases, 57 pageable copies
TRAIN_SNAP = {"spans": [
    sp("input.queue_wait", 0, 0.5, (0, 7)),
    sp("input.gather", -20, 9, (0, 7)),
    sp("train.forward", 2, 10, 3, "train.step"),
    sp("train.step", 1, 30, 3),
    sp("input.queue_wait", 31, 1.5, (0, 8)),
    sp("train.step", 33, 40, 4),
    sp("input.queue_wait", 73, 2, (0, 9)),
    sp("input.queue_wait", 75, 4, (1, 0)),
    sp("train.step", 80, 50, 5)],
    "counters": {"input.pageable_copies": 57}, "dropped": 0}


@pytest.fixture
def registry(monkeypatch):
    from ugaitnet_tpu_torch.obsv import spans

    def use(snap):
        monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return use


def test_encode_readers(registry):
    registry(ENCODE_SNAP)
    rec = {"kind": "encode"}
    assert read("gather_ms.encode", rec) == pytest.approx((6 + 8) / 2)
    assert read("launch_ms.encode", rec) == pytest.approx((2 + 1 + 2) / 2)
    assert read("readback_ms.encode", rec) == pytest.approx((20 + 18) / 2)
    assert read("collect_ms.encode", rec) == pytest.approx(50.0)
    for m in TRAIN:
        assert read(m, rec) is None


def test_train_readers(registry):
    registry(TRAIN_SNAP)
    rec = {"kind": "train"}
    assert read("queue_wait_ms.train", rec) == pytest.approx(
        (0.5 + 1.5 + 2 + 4) / 3)
    assert read("pageable_copies.train", rec) == pytest.approx(57 / 3)
    assert read("step_host_ms.train", rec) == pytest.approx(
        (30 + 40 + 50) / 3)
    for m in ENCODE:
        assert read(m, rec) is None


@pytest.mark.parametrize("metric", ENCODE + TRAIN)
def test_nothing_to_read(registry, monkeypatch, metric):
    """An empty registry, and a program without one, give None."""
    kind = metric.rsplit(".", 1)[1]
    registry({"spans": [], "counters": {}, "dropped": 0})
    assert read(metric, {"kind": kind}) is None
    monkeypatch.setitem(sys.modules, "ugaitnet_tpu_torch.obsv.spans", None)
    assert read(metric, {"kind": kind}) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the program's CUDA kernels)")


def traced(monkeypatch, name, seconds):
    """A traced tiny run of cell ``name`` on the card, with the host
    durations of the trace's "pb.encode_pass" ranges."""
    from ugaitnet_tpu_torch.obsv import spans
    passes = []
    reduce = harness.reduce_trace

    def keep_passes(path):
        with open(path) as f:
            passes.extend(e["dur"] / 1e3 for e in json.load(f)["traceEvents"]
                          if e.get("name") == "pb.encode_pass"
                          and e.get("cat") == "user_annotation")
        return reduce(path)

    monkeypatch.setattr(harness, "reduce_trace", keep_passes)
    spans.clear()
    c = tiny_cell(name)
    if c["kind"] == "encode":
        c["params"]["cameras"] = 11        # 440 clips, 28 batches a pass
    res = run.execute(c, tiny_config(c["config"]), 2 ** 31 + 21, seconds,
                      True)
    return res, spans.snapshot(), passes


@pytest.mark.cuda
def test_traced_encode_reports_its_readings(card, monkeypatch):
    res, snap, passes = traced(monkeypatch, "gaitset.encode_bf16", 3.0)
    assert res["correct"], res["checks"]
    got = {m: res["metrics"][m]["value"] for m in ENCODE}
    assert all(v > 0 for v in got.values()), got
    # one traced pass: its batches' gather, launch and readback and its
    # collect account for the harness's host span of the pass
    (pass_ms,) = passes
    nb = len({s["id"] for s in snap["spans"] if s["name"] == "encode.launch"})
    total = nb * (got["gather_ms.encode"] + got["launch_ms.encode"]
                  + got["readback_ms.encode"]) + got["collect_ms.encode"]
    assert total == pytest.approx(pass_ms, rel=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaitset.train", "cnn3d.train"])
def test_traced_train_reports_its_readings(card, monkeypatch, name):
    # the readings only: the cells' limits hold at their own widths
    res, snap, _ = traced(monkeypatch, name, 4.0)
    got = {m: res["metrics"][m]["value"] for m in TRAIN}
    assert sum(s["name"] == "train.step" for s in snap["spans"]) == 4
    # each step's batch moves 9 augmentation parameters a modality and the
    # dropout masks from the CPU generator's pageable draws; the gathered
    # rows, flags and labels are page-locked
    assert got["pageable_copies.train"] == 2 * 9 + 1
    assert got["step_host_ms.train"] > 0
    assert got["queue_wait_ms.train"] >= 0


@pytest.mark.cuda
def test_pageable_classification_on_the_card(card):
    from ugaitnet_tpu_torch.obsv.spans import holds_host
    dev = torch.device("cuda")
    assert holds_host(torch.zeros(4), dev)
    assert not holds_host(torch.zeros(4).pin_memory(), dev)
    assert not holds_host(torch.zeros(4, device=dev), dev)
