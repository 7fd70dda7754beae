"""The DeepGaitV2-3D cell's pieces on the CPU: its configuration builds the
program's ModelConfig, the analytic counts (``flops_dgv2.py``) equal what
PyTorch counts, both new metric readers on hand-built records, the
silhouette traffic and its sampler design, the trace reduction of the
program's ranges, and whole tiny runs of the driver: sound, ``correct``;
each control and planted fault, past a limit.  On the card
(``python -m pytest -q -m cuda portbench/tests``): a traced tiny run
reads 17 BatchNorm layers a step and a roofline share."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import load
from portbench import flops_dgv2, run, traffic_sil
from portbench.drivers import train_dgv2 as D
from portbench.reference import deepgaitv2 as R
from portbench.reference import judge as J
from test_portbench_spans import TRAIN_SNAP, card, registry  # noqa: F401
from test_portbench_trace import ev, read

SEED = 2 ** 31 + 2 ** 30 + 77
CELL = "deepgaitv2.train_bf16"
GEOMETRY = dict(frames=8, height=28, width=38)


def tiny(compute_dtype="float32"):
    """The cell at 8 ids x 4 clips, batch 8 (2 ids x 4), channels (8, 16,
    32, 64), blocks (1, 2, 2, 1), 8 classes; float32 by default, so that
    the limits of a sound run hold by the margins of the full cell."""
    cell = copy.deepcopy(load("workloads", f"{CELL}.json"))
    cfg = copy.deepcopy(load("configs", f"{cell['config']}.json"))
    cell["params"].update(ids=8, clips_per_id=4, batch=8)
    cfg["model"]["branches"][0].update(stage_channels=[8, 16, 32, 64],
                                       stage_blocks=[1, 2, 2, 1],
                                       part_dim=16)
    cfg["model"].update(nclasses=8, compute_dtype=compute_dtype)
    return cell, cfg


def test_configuration_builds_the_driver_model():
    from ugaitnet_tpu_torch.core.config import DeepGaitV2Config, ModelConfig
    cfg = load("configs", "deepgaitv2_3d_gait3d.json")
    pub = cfg["published"]
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entry = next(c for c in spec["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == cfg["reduced"] == ["frames_num_fixed"]
    assert cfg["frames_num_fixed"] == 25
    assert cfg["published"]["sampler"]["frames_num_fixed"] == 30
    mcfg = D.model_config(cfg)
    assert mcfg == ModelConfig(
        branches=(DeepGaitV2Config(
            stage_channels=(64, 128, 256, 512), stage_blocks=(1, 4, 4, 1),
            hpp_bins=(16,), part_dim=256, logit_scale=16.0),),
        merge="max", nclasses=3000, l2_mode="reference",
        compute_dtype="bfloat16")
    assert mcfg.bnneck_scale == pub["CrossEntropyLoss"]["scale"]
    b = cfg["model"]["branches"][0]
    assert b["stage_channels"] == pub["Backbone"]["channels"]
    assert b["stage_blocks"] == pub["Backbone"]["layers"]
    assert cfg["model"]["nclasses"] == pub["SeparateBNNecks"]["class_num"]
    from ugaitnet_tpu_torch.train.train_step import SGD_WEIGHT_DECAY
    assert cfg["train"]["lr"] == pub["optimizer"]["lr"]
    assert cfg["train"]["weight_decay"] == SGD_WEIGHT_DECAY == \
        pub["optimizer"]["weight_decay"]
    w = load("workloads", f"{CELL}.json")["params"]
    assert (w["batch"], 2 * w["repetitions"]) == (
        pub["sampler"]["batch_size"][0] * pub["sampler"]["batch_size"][1],
        pub["sampler"]["batch_size"][1])


def test_full_width_counts():
    m = load("configs", "deepgaitv2_3d_gait3d.json")["model"]
    assert flops_dgv2.forward_flops_per_clip(m) == pytest.approx(339.2e9,
                                                                 rel=1e-3)
    bounds = flops_dgv2.span_bounds(m, 128, 2, 989e12)
    assert set(bounds) == {"model.dgv2.stem", "model.dgv2.stage1",
                           "model.dgv2.stage2", "model.dgv2.stage3",
                           "model.dgv2.stage4", "model.dgv2.pool",
                           "head.bnneck"}


def test_forward_count_of_the_program():
    """PyTorch's count of the program's tiny forward (convs and matmuls)."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    _, cfg = tiny()
    model = UGaitNet(D.model_config(cfg), device="cpu")
    x = torch.rand(2, 8, 28, 38, 1)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model([x], train=True, key=0)
    assert fc.get_total_flops() == 2 * flops_dgv2.forward_flops_per_clip(
        cfg["model"], **GEOMETRY)


def test_train_count_of_the_reference():
    """Forward and backward of the reference's loss, counted by PyTorch:
    the stem conv's input needs no gradient; the triplet and the
    cross-entropy add no conv or matmul."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    _, cfg = tiny()
    model = UGaitNet(D.model_config(cfg), device="cpu")
    W = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = [k for k in W if not R.is_buffer(k)]
    for k in params:
        W[k].requires_grad_(True)
    x, labels = torch.rand(4, 8, 28, 38, 1), torch.tensor([0, 0, 1, 1])
    with FlopCounterMode(display=False) as fc:
        total = R.loss(cfg["model"], cfg["train"], W, x, labels)[0]
        torch.autograd.grad(total, [W[k] for k in params])
    assert fc.get_total_flops() == 4 * flops_dgv2.train_flops_per_row(
        cfg["model"], **GEOMETRY)


def test_bn_batch_stats_reader(registry):
    """BatchNorm layers a step: 75 over the three steps of TRAIN_SNAP."""
    registry(dict(TRAIN_SNAP, counters=dict(TRAIN_SNAP["counters"],
                                            **{"bn.batch_stats": 75})))
    assert read("bn_batch_stats.train", {"kind": "train"}) == 25.0
    assert read("bn_batch_stats.train", {"kind": "encode"}) is None


@pytest.mark.parametrize("snap", ["no counter", "no steps", "no registry"])
def test_bn_batch_stats_reads_nothing_without_its_counter(
        registry, monkeypatch, snap):
    if snap == "no counter":
        registry(TRAIN_SNAP)
    elif snap == "no steps":
        registry({"spans": [], "counters": {"bn.batch_stats": 25},
                  "dropped": 0})
    else:
        monkeypatch.setitem(sys.modules,
                            "ugaitnet_tpu_torch.obsv.spans", None)
    assert read("bn_batch_stats.train", {"kind": "train"}) is None


def test_roofline_reader():
    """Two ranges, 3 calls each: least 3 x (2 + 1) ms over 12 + 6 ms."""
    rec = {"kind": "train",
           "dgv2_ranges": {"ugn.model.dgv2.stem": [3, 0.012],
                           "ugn.model.dgv2.pool": [3, 0.006],
                           "ugn.model.other": [3, 1.0]},
           "dgv2_bounds": {"ugn.model.dgv2.stem": 0.002,
                           "ugn.model.dgv2.pool": 0.001,
                           "ugn.model.dgv2.stage2": 0.004}}
    assert read("dgv2_fwd_roofline.train", rec) == pytest.approx(50.0)
    for r in ({"kind": "train"}, {"kind": "train", "dgv2_ranges": {},
                                  "dgv2_bounds": rec["dgv2_bounds"]},
              dict(rec, kind="encode")):
        assert read("dgv2_fwd_roofline.train", r) is None


def test_range_device_seconds(tmp_path):
    """Kernels launched inside a range count to it, whatever their own
    times; a launch outside, or on another thread, does not."""
    trace = [
        ev("ugn.model.dgv2.stem", "user_annotation", 0, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 10, 2, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 60, 2, corr=2),
        ev("cudaLaunchKernel", "cuda_runtime", 20, 2, tid=3, corr=3),
        ev("ugn.model.dgv2.stem", "user_annotation", 100, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 120, 2, corr=4),
        ev("k1", "kernel", 30, 40, tid=9, corr=1),
        ev("k2", "kernel", 70, 10, tid=9, corr=2),
        ev("k3", "kernel", 80, 10, tid=9, corr=3),
        ev("k4", "kernel", 130, 25, tid=9, corr=4),
        ev("ugn.train.step", "user_annotation", 0, 200),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": trace}))
    got = D.range_device_seconds(str(path), D.RANGE_PREFIX)
    assert got == {"ugn.model.dgv2.stem": [2, pytest.approx(65e-6)]}


def test_traffic_is_seeded_and_binary():
    p = {"ids": 3, "clips_per_id": 2}
    a = traffic_sil.dataset_arrays(p, SEED, "cpu")
    b = traffic_sil.dataset_arrays(p, SEED, "cpu")
    np.testing.assert_array_equal(a["raw_silhouette"], b["raw_silhouette"])
    x = a["raw_silhouette"]
    assert x.shape == (6, 25, 60, 60) and x.dtype == np.uint8
    assert set(np.unique(x)) == {0, 255}
    assert 0.03 < (x > 0).mean() < 0.4
    assert a["labels"].tolist() == [1, 1, 2, 2, 3, 3]
    assert not a["gaits"].any()
    c = traffic_sil.dataset_arrays(p, SEED + 1, "cpu")["raw_silhouette"]
    assert not np.array_equal(c, x)


def test_sampler_draws_32_ids_of_4():
    """The cell's columns (3,000 ids x 6 clips, one gait code): every batch
    of an epoch holds 32 subjects x 4 distinct clips, and the design check
    finds no fault."""
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    p = load("workloads", f"{CELL}.json")["params"]
    n = p["ids"] * p["clips_per_id"]
    labels = np.repeat(np.arange(1, p["ids"] + 1), p["clips_per_id"])
    gaits = np.zeros(n, np.int32)
    s = BalancedGaitSampler(labels, gaits, p["batch"], p["repetitions"],
                            seed=5)
    epoch = [s.next_batch() for _ in range(len(s))]
    assert len(epoch) == n // 128
    for idx in epoch:
        _, counts = np.unique(labels[idx], return_counts=True)
        assert counts.tolist() == [4] * 32 and len(set(idx)) == 128
    assert J.sampler_faults([epoch], labels, gaits, p["batch"],
                            p["repetitions"]) == 0


def execute(readings=False, compute_dtype="float32"):
    cell, cfg = tiny(compute_dtype)
    cell["limits"] = dict(cell["limits"], **LIMITS)
    return run.execute(cell, cfg, SEED, 0.5, False, device="cpu",
                       readings=readings)


# the cell's limits, which a float32 tiny run meets by their margins too
LIMITS = load("workloads", f"{CELL}.json")["limits"]


def test_sound_run_and_controls():
    """The sound tiny run is correct; each control of ``--readings 1``
    reads past at least one of the cell's limits; the program's float32
    witness, in a float32 run, reads the sound run's own numbers."""
    res = execute(readings=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    controls = [k for k in res["extra"] if k.startswith("control.")]
    assert len(controls) == 9
    for name in controls:
        got = res["extra"][name]
        assert any(got[k] > LIMITS[k] for k in LIMITS if k in got), name
    f32 = res["extra"]["witness.fp32_program"]
    for k, c in res["checks"].items():
        if k in f32:
            assert f32[k] == pytest.approx(c["value"], abs=1e-12), k
    assert "witness.bf16" in res["extra"]


def _bn_running(monkeypatch):
    """BatchNorm on its running statistics while training."""
    from ugaitnet_tpu_torch.models import deepgaitv2 as DG
    real = DG.BatchNorm.forward
    monkeypatch.setattr(DG.BatchNorm, "forward",
                        lambda self, x, train: real(self, x, False))


def _no_smoothing(monkeypatch):
    """The cross-entropy without its label smoothing."""
    from ugaitnet_tpu_torch.ops import losses
    real = losses.softmax_crossentropy_logits
    monkeypatch.setattr(losses, "softmax_crossentropy_logits",
                        lambda logits, onehot, smoothing=0.0:
                        real(logits, onehot, 0.0))


def _triplet_half(monkeypatch):
    """The triplet over the first half of the batch alone, as a kernel
    planned for fewer rows than the batch would take it."""
    from ugaitnet_tpu_torch.train import train_step as TS
    real = TS.make_triplet_loss

    def make(kind, margin):
        fn = real(kind, margin)
        return lambda x, labels: fn(x[: x.shape[0] // 2],
                                    labels[: labels.shape[0] // 2])
    monkeypatch.setattr(TS, "make_triplet_loss", make)


def _sgd_no_decay(monkeypatch):
    """SGD without its weight decay."""
    from ugaitnet_tpu_torch.train import train_step as TS
    monkeypatch.setattr(TS, "SGD_WEIGHT_DECAY", 0.0)


def _repeated_row(monkeypatch):
    """A batch of the sampler with a row twice."""
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    real = BalancedGaitSampler.next_batch

    def repeat(self):
        idx = real(self)
        idx[1] = idx[0]
        return idx
    monkeypatch.setattr(BalancedGaitSampler, "next_batch", repeat)


# each fault planted in the program, and the reading that must catch it
PLANTED = {"bn_running": (_bn_running, "stats1_err"),
           "no_smoothing": (_no_smoothing, "loss_fn_grad_err"),
           "triplet_half": (_triplet_half, "loss_fn_grad_err"),
           "sgd_no_decay": (_sgd_no_decay, "update_err"),
           "repeated_row": (_repeated_row, "sampler_faults")}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_fails(monkeypatch, fault):
    plant, reading = PLANTED[fault]
    plant(monkeypatch)
    res = execute()
    assert res["checks"][reading]["value"] > LIMITS[reading]
    assert not res["correct"]


@pytest.mark.cuda
def test_traced_tiny_run_on_the_card(card):
    """Both new readings, and no launch of the 3D CNN's hand
    weight-gradient kernel (``ops/cuda/conv3d_wgrad.py``)."""
    from ugaitnet_tpu_torch.obsv import spans
    from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW
    spans.clear()
    launches = CW.launches
    cell, cfg = tiny("bfloat16")
    res = run.execute(cell, cfg, SEED, 4.0, True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["bn_batch_stats.train"] == 17.0
    assert 0 < got["dgv2_fwd_roofline.train"] < 100
    assert CW.launches == launches
    assert "conv3d.wgrad_hand" not in spans.snapshot()["counters"]
