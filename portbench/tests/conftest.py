"""Tiny cells for the CPU: the committed configurations and cells with
narrow widths and few clips, so a whole run (set-up, window, check) takes
seconds on the CPU with the program's plain kernels."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
BENCH = os.path.join(ROOT, "portbench")


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_config(name):
    cfg = copy.deepcopy(load("configs", f"{name}.json"))
    for b in cfg["model"]["branches"]:
        if b["kind"] == "gaitset":
            b["gaitset_channels"], b["part_dim"] = [4, 4, 8], 8
    cfg["model"]["nclasses"] = 4
    return cfg


def tiny_cell(name):
    cell = copy.deepcopy(load("workloads", f"{name}.json"))
    p = cell["params"]
    if cell["kind"] in ("train", "encode"):
        p.update(ids=4, cameras=1)
    if cell["kind"] == "train":
        p.update(batch=8, repetitions=2)
    if cell["kind"] == "encode":
        p.update(batch=16)
    return cell


@pytest.fixture
def tiny():
    return lambda cell: (tiny_cell(cell),
                         tiny_config(load("workloads",
                                          f"{cell}.json")["config"]))
