"""The port's trace reader (``obsv/profiling.py``): a real CPU trace of one
tiny train step, written by ``obsv/logger.py:profile``, parses into per-op
rows; the card's rows take ``kernel`` events only (a hand-made trace with
copies and memsets beside the kernels); a missing trace raises."""

import json

import numpy as np
import pytest
import torch

from ugaitnet_tpu_torch.core.config import TrainConfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv.logger import profile
from ugaitnet_tpu_torch.obsv.profiling import (OpTime, print_op_profile,
                                               summarize_trace)
from ugaitnet_tpu_torch.parallel.dryrun import dryrun_batch, tiny_flagship
from ugaitnet_tpu_torch.train.train_step import init_state, make_train_step

torch.set_num_threads(1)


def test_cpu_trace_of_a_step_parses(tmp_path, capsys):
    mcfg = tiny_flagship()
    state = init_state(UGaitNet(mcfg, device="cpu"), TrainConfig())
    step = make_train_step(mcfg, TrainConfig())
    batch = dryrun_batch(4, "cpu")
    with profile(str(tmp_path)):
        for _ in range(2):
            step(state, batch)
    rows = summarize_trace(str(tmp_path), iters=2, device_substr="cpu")
    assert rows and all(isinstance(r, OpTime) for r in rows)
    ms = [r.ms_per_iter for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    names = {r.name: r for r in rows}
    # ten convs a branch, two branches, two steps
    assert names["aten::conv2d"].count == 2 * 2 * 10
    # the file itself reads the same
    assert summarize_trace(str(tmp_path / "trace.json"), 2, "cpu") == rows
    assert summarize_trace(str(tmp_path)) == []      # no card: no kernels
    print_op_profile(str(tmp_path), iters=2, top=3, device_substr="cpu")
    assert capsys.readouterr().out.count("ms/iter") == 3


def test_card_rows_take_kernels_only(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "triplet_fwd_kernel",
           "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "triplet_fwd_kernel",
           "dur": 34.0},
          {"ph": "X", "cat": "kernel", "name": "gemm", "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "dur": 500.0},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 50.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 900.0},
          {"ph": "i", "cat": "kernel", "name": "marker"}]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    rows = summarize_trace(str(tmp_path), iters=2)
    assert [(r.name, r.count) for r in rows] == [
        ("gemm", 1), ("triplet_fwd_kernel", 2)]
    np.testing.assert_allclose([r.ms_per_iter for r in rows],
                               [0.05, 0.032])
    assert [r.name for r in summarize_trace(str(tmp_path), 1, "cpu")] == \
        ["aten::mm"]
    with pytest.raises(ValueError, match="device_substr"):
        summarize_trace(str(tmp_path), 1, "TPU")


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path / "nothing.json"))
