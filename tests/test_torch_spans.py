"""The span and counter registry (``obsv/spans.py``) and the spans of the
input path, the encode loop and the train step, on the CPU at tiny
widths: nothing is recorded without a profiler; under one, the encode
loop's spans partition a pass, the prefetch loader's consumer records the
producer's gathers, the step's phases nest in it, the profiler's ``ugn.``
ranges and the registry agree, and ``obsv/logger.py:profile`` writes the
spans into its trace."""

import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
from ugaitnet_tpu_torch.data.pipeline import GaitPipeline, PrefetchLoader
from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.encode import encode_dataset
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv import logger, spans
from ugaitnet_tpu_torch.parallel.dryrun import tiny_flagship
from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                 make_train_step)

torch.set_num_threads(1)
MODS = ("of", "gray")
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def empty_registry():
    spans.clear()
    yield
    spans.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def dataset():
    # 4 subjects x 3 videos x 2 subsequences = 24 clips
    return make_synthetic_dataset(num_subjects=4, videos_per_subject=3,
                                  subseqs_per_video=2, seed=3)


def test_nothing_recorded_without_a_profiler(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    with spans.span("train.step", 1):
        spans.count("input.pageable_copies", 3)
        spans.count_pageable("input.pageable_copies", torch.zeros(2), CUDA)
        spans.add("input.gather", 1, 2, (0, 0))
    ds = dataset()
    encode_dataset(UGaitNet(tiny_flagship(), device="cpu", seed=0), ds, MODS,
                   batch_size=10)
    assert spans.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_encode_spans_partition_the_pass():
    ds = dataset()
    model = UGaitNet(tiny_flagship(), device="cpu", seed=0)
    encode_dataset(model, ds, MODS, batch_size=10)        # warm-up
    with cpu_profile():
        t0 = time.time_ns()
        encode_dataset(model, ds, MODS, batch_size=10)
        t1 = time.time_ns()
    got = by_name(spans.snapshot())
    nb = 3                                    # 24 clips: 10 + 10 + 4
    for name in ("input.gather", "input.preprocess", "encode.launch",
                 "encode.readback"):
        assert len(got[name]) == nb, name
    (collect,) = got["encode.collect"]
    npass = collect["id"]
    for name in ("input.gather", "encode.launch", "encode.readback"):
        assert [s["id"] for s in got[name]] == [(npass, b) for b in
                                                range(nb)], name
    assert all(s["parent"] == "encode.launch"
               for s in got["input.preprocess"])
    assert all(s["parent"] is None for s in got["encode.launch"])
    # the batches' spans follow each other: gather, launch, readback
    seq = sorted((s["start_ns"], s["end_ns"]) for name in (
        "input.gather", "encode.launch", "encode.readback", "encode.collect")
        for s in got[name])
    assert all(a[1] <= b[0] for a, b in zip(seq, seq[1:]))
    total = sum(e - s for s, e in seq)
    assert total == pytest.approx(t1 - t0, rel=0.05)


def test_prefetch_and_step_spans():
    ds = dataset()
    mcfg = tiny_flagship()
    dcfg = DataConfig(batch_size=8, expand_level=3, repetitions=2,
                      augment=True)
    pipe = GaitPipeline(ds, dcfg, MODS, labmap=ds.label_map(), device="cpu")
    sampler = BalancedGaitSampler(ds.labels, ds.gaits, 8, 2, seed=1)
    state = init_state(UGaitNet(mcfg, device="cpu", seed=0), TrainConfig())
    step = make_train_step(mcfg, TrainConfig())
    loader = iter(PrefetchLoader(pipe, sampler, seed=5, epoch=7))
    vols, flags, labels = next(loader)        # before the profiler
    step(state, Batch(tuple(vols), tuple(flags), labels))
    with cpu_profile():
        for _ in range(2):
            vols, flags, labels = next(loader)
            step(state, Batch(tuple(vols), tuple(flags), labels))
    loader.close()
    got = by_name(spans.snapshot())
    ids = [(7, 1), (7, 2)]
    me = threading.get_native_id()
    for name in ("input.queue_wait", "input.gather", "input.preprocess"):
        assert [s["id"] for s in got[name]] == ids, name
    # the producer's gathers, recorded by the consumer with their thread
    assert all(s["tid"] != me for s in got["input.gather"])
    assert all(s["tid"] == me for s in got["input.preprocess"])
    assert [s["id"] for s in got["train.step"]] == [1, 2]
    assert all(s["parent"] is None for s in got["train.step"])
    for child in ("train.forward", "train.backward", "train.update"):
        assert [(s["id"], s["parent"]) for s in got[child]] == [
            (1, "train.step"), (2, "train.step")], child
    for st in got["train.step"]:
        kids = [s for c in ("train.forward", "train.backward", "train.update")
                for s in got[c] if s["id"] == st["id"]]
        assert all(st["start_ns"] <= k["start_ns"] <= k["end_ns"]
                   <= st["end_ns"] for k in kids)
    # the CPU pipeline's moves hold nothing
    assert spans.snapshot()["counters"] == {}


def test_ranges_agree_with_the_registry_and_the_trace_holds_spans(tmp_path):
    ds = dataset()
    mcfg = tiny_flagship()
    dcfg = DataConfig(batch_size=8, expand_level=1, repetitions=2)
    pipe = GaitPipeline(ds, dcfg, MODS, labmap=ds.label_map(), device="cpu")
    sampler = BalancedGaitSampler(ds.labels, ds.gaits, 8, 2, seed=1)
    state = init_state(UGaitNet(mcfg, device="cpu", seed=0), TrainConfig())
    step = make_train_step(mcfg, TrainConfig())
    loader = iter(PrefetchLoader(pipe, sampler, seed=5, epoch=0))
    with logger.profile(str(tmp_path)):
        vols, flags, labels = next(loader)
        step(state, Batch(tuple(vols), tuple(flags), labels))
    loader.close()
    snap = by_name(spans.snapshot())
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = int(trace["baseTimeNanoseconds"])
    ranges = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    for name in ("train.step", "train.backward", "input.preprocess"):
        (s,) = snap[name]
        r = ranges["ugn." + name]
        assert abs(r["ts"] - (s["start_ns"] - base) / 1e3) < 1e3, name
        assert abs(r["dur"] - (s["end_ns"] - s["start_ns"]) / 1e3) < 1e3
    # every registry span is in the trace, the producer's gather with its
    # own thread, which has no profiler range
    added = [e for e in trace["traceEvents"] if e.get("cat") == "ugn_span"]
    assert sorted(e["name"] for e in added) == sorted(
        "ugn." + s["name"] for v in snap.values() for s in v)
    (g,) = [e for e in added if e["name"] == "ugn.input.gather"]
    (s,) = snap["input.gather"]
    assert g["tid"] == s["tid"] != threading.get_native_id()
    assert g["ts"] == pytest.approx((s["start_ns"] - base) / 1e3)
    assert "ugn.input.gather" not in ranges


class Pinned(torch.Tensor):
    """A CPU tensor that reads as page-locked (this build has no pinned
    allocator)."""

    def is_pinned(self, *args):
        return True


def test_pageable_copy_classification():
    pageable = torch.zeros(4)
    pinned = torch.zeros(4).as_subclass(Pinned)
    assert spans.holds_host(pageable, CUDA)
    assert not spans.holds_host(pinned, CUDA)
    assert not spans.holds_host(pageable, torch.device("cpu"))
    assert not spans.holds_host(torch.empty(4, device="meta"), CUDA)
    with cpu_profile():
        for src in (pageable, pinned, pageable):
            spans.count_pageable("input.pageable_copies", src, CUDA)
        spans.count("other", 5)
    assert spans.snapshot()["counters"] == {"input.pageable_copies": 2,
                                            "other": 5}


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    with cpu_profile():
        for i in range(5):
            with spans.span("x", i):
                pass
    snap = spans.snapshot()
    assert [s["id"] for s in snap["spans"]] == [0, 1, 2]
    assert snap["dropped"] == 2
    spans.clear()
    assert spans.snapshot() == {"spans": [], "counters": {}, "dropped": 0}
