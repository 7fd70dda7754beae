"""The trace reduction and the per-layer readers on a small recorded
trace, with every number worked out by hand."""

import json
import os

import pytest

from portbench import harness
from portbench.run import BENCH, load_file


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# host: a step range 0..100 us holding a conv range 10..40 us, which
# launches kernel 1 (correlation 7); kernel 2 is launched outside it.
# device: kernel 1 at 20..50 us, a memcpy 45..60, kernel 2 at 80..120.
TRACE = [
    ev("pb.step", "user_annotation", 0, 100),
    ev("pb.conv3x3.of.a_conv2", "user_annotation", 10, 30),
    ev("cudaLaunchKernel", "cuda_runtime", 15, 2, corr=7),
    ev("cudaLaunchKernel", "cuda_runtime", 60, 2, corr=8),
    ev("conv_kernel", "kernel", 20, 30, tid=9, corr=7),
    ev("Memcpy HtoD", "gpu_memcpy", 45, 15, tid=9),
    ev("other_kernel", "kernel", 80, 40, tid=9, corr=8),
    ev("pb.input_wait", "user_annotation", 100, 30),
]


@pytest.fixture
def reduced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": TRACE}))
    return harness.reduce_trace(str(path))


def test_reduce_trace(reduced):
    # window 0..130 us; busy = [20, 60] + [80, 120] = 80 us
    assert reduced["window_s"] == pytest.approx(130e-6)
    assert reduced["busy_s"] == pytest.approx(80e-6)
    assert dict(reduced["device_ops"]) == pytest.approx(
        {"other_kernel": 40e-6, "conv_kernel": 30e-6})
    # idle: 0..10 and 60..80 in pb.step, 10..20 in the conv range inside
    # it, 120..130 in input_wait
    assert dict(reduced["idle_gaps"]) == pytest.approx(
        {"pb.step": 30e-6, "pb.conv3x3.of.a_conv2": 10e-6,
         "pb.input_wait": 10e-6})
    assert reduced["idle_by_range"] == pytest.approx(
        dict(reduced["idle_gaps"]))
    assert reduced["ranges"]["pb.conv3x3.of.a_conv2"] == (
        1, pytest.approx(30e-6))
    assert reduced["ranges"]["pb.step"] == (1, pytest.approx(70e-6))


def read(metric, rec):
    return load_file(f"t_{metric}", os.path.join(
        BENCH, "metrics", f"{metric}.py")).read(rec)


def test_readers(reduced):
    rec = {"kind": "encode", "trace": reduced, "window_s": 2.0,
           "flops": 4e12, "peak_flops": 1e12,
           "conv3x3": {"of.a_conv2": 15e-6}}
    assert read("device_idle.encode", rec) == pytest.approx(
        100 * (1 - 80 / 130))
    assert read("device_idle.train", rec) is None
    assert read("conv3x3_roofline.encode", rec) == pytest.approx(50.0)
    assert read("encode_mfu", rec) == pytest.approx(200.0)
    assert read("train_mfu", rec) is None
    passes = dict(rec, spans={"encode_pass": [1.5, 1.25, 1.75]})
    assert read("fastest_pass_ms.encode", passes) == pytest.approx(1250.0)
    assert read("fastest_pass_ms.encode", rec) is None
    train = {"kind": "train", "window_s": 2.0, "flops": 67e12,
             "peak_flops": 67e12, "spans": {"input_wait": [0.1, 0.3]},
             "trace": reduced}
    assert read("train_mfu", train) == pytest.approx(50.0)
    assert read("device_idle.train", train) == pytest.approx(
        100 * (1 - 80 / 130))
    # the device's idle time inside pb.input_wait (120..130 us) over its
    # one call; the host's 0.1 s and 0.3 s in the span do not count
    assert read("input_idle_ms.train", train) == pytest.approx(10e-3)


def test_reader_finds_nothing():
    """A reader with nothing to read returns None, never 0."""
    rec = {"kind": "encode", "trace": {}, "conv3x3": {"of.a_conv2": 1.0}}
    for m in ("conv3x3_roofline.encode", "device_idle.encode",
              "input_idle_ms.train"):
        assert read(m, rec) is None
    # a train record whose trace has no pb.input_wait range
    train = {"kind": "train", "trace": {"ranges": {}, "idle_by_range": {}}}
    assert read("input_idle_ms.train", train) is None


def test_empty_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("k", "kernel", 0, 5)]}))
    assert harness.reduce_trace(str(path)) == {}
