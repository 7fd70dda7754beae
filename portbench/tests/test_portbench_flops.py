"""flops.py against torch.utils.flop_counter at small shapes: the analytic
count of a forward, and of a forward + backward, equals what PyTorch counts
for the plain reference running it."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_config
from portbench import flops
from portbench.harness import build_model, model_config
from portbench.reference import model as RM
from portbench.reference import train as RT


def _inputs(cfg, rows):
    g = torch.Generator().manual_seed(0)
    vols = [torch.randn(rows, 25, 60, 60, flops.MODALITY_CHANNELS[b["modality"]],
                        generator=g) for b in cfg["model"]["branches"]]
    flags = [torch.ones(rows) for _ in vols]
    return vols, flags


def _weights(cfg):
    _, W = build_model(model_config(cfg), 0, "cpu")
    return W


@pytest.mark.parametrize("config", ["gaitset_of_gray", "cnn3d_of_gray"])
def test_forward_count(config):
    cfg = tiny_config(config)
    W = _weights(cfg)
    vols, flags = _inputs(cfg, 2)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        RM.forward(cfg["model"], W, vols, flags)
    assert fc.get_total_flops() == 2 * flops.forward_flops_per_clip(
        cfg["model"])


@pytest.mark.parametrize("config", ["gaitset_of_gray", "cnn3d_of_gray"])
def test_train_count(config):
    cfg = tiny_config(config)
    W = {k: v.requires_grad_(True) for k, v in _weights(cfg).items()}
    vols, flags = _inputs(cfg, 4)
    labels = torch.tensor([0, 0, 1, 1])
    with FlopCounterMode(display=False) as fc:
        out = RM.forward(cfg["model"], W, vols, flags)
        loss = torch.nn.functional.cross_entropy(out["logits"], labels)
        torch.autograd.grad(loss, list(W.values()), allow_unused=True)
    # the triplet's distance matmuls are not the model's, so the count
    # leaves the loss out
    assert fc.get_total_flops() == 4 * flops.train_flops_per_row(
        cfg["model"])


def test_full_width_counts():
    from conftest import load
    g = load("configs", "gaitset_of_gray.json")["model"]
    c = load("configs", "cnn3d_of_gray.json")["model"]
    assert flops.forward_flops_per_clip(g) == pytest.approx(16.05e9, rel=1e-3)
    assert flops.forward_flops_per_clip(c) == pytest.approx(5.19e9, rel=1e-3)


def test_conv3x3_roofline_bound():
    cfg = tiny_config("gaitset_of_gray")
    layers = flops.conv3x3_layers(cfg["model"], 8, 2)
    assert len(layers) == 2 * 9          # a_conv2..6, b_conv1..4, x2
    ops, byts = layers["of.a_conv2"]
    assert ops == 2 * 8 * 25 * 64 * 64 * 4 * 4 * 9
    assert byts == 2 * (8 * 25 * 64 * 64 * 8 + 4 * 4 * 9)
    t = flops.roofline_seconds(ops, byts, flops.PEAKS["bfloat16"])
    assert t == max(ops / 989e12, byts / 3.35e12)


def test_triplet_not_in_model_count():
    """The triplet's own work is elementwise and B x B distances; the count
    is of the model's convs and matmuls only (its share is below 0.1 % at
    the cells' widths)."""
    sig = torch.randn(4, 3, 5)
    with FlopCounterMode(display=False) as fc:
        RT.batch_all(sig, torch.tensor([0, 0, 1, 1]), 0.2)
    assert fc.get_total_flops() == 0
