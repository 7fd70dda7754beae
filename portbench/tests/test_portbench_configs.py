"""Each configuration file builds the model the CLI builds, and
BENCHMARK.json holds to the benchmark's contract: every cell, metric and
configuration it names is a file of its own that the harness finds."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT, load
from portbench.harness import model_config

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_builds_the_cli_model(entry):
    from ugaitnet_tpu_torch.cli.train import build_parser, configs_from_args
    cfg = load("configs", f"{entry['name']}.json")
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"] and entry["reduced"] == []
    mcfg, dcfg, tcfg = configs_from_args(build_parser().parse_args(
        cfg["cli"]))
    assert model_config(cfg) == mcfg
    t = cfg["train"]
    assert (tcfg.optimizer, tcfg.lr, tcfg.margin, tcfg.loss_weights,
            tcfg.triplet_kind) == (t["optimizer"], t["lr"], t["margin"],
                                   tuple(t["loss_weights"]),
                                   t["triplet_kind"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_file(cell):
    w = load("workloads", f"{cell['name']}.json")
    for k in ("name", "config", "traffic", "chips", "why"):
        assert w[k] == cell[k]
    cfg = load("configs", f"{w['config']}.json")
    p = w["params"]
    assert os.path.exists(os.path.join(BENCH, "drivers", f"{w['kind']}.py"))
    if w["kind"] == "train":
        assert (p["batch"], p["repetitions"]) == (
            int(cfg["cli"][cfg["cli"].index("--bs") + 1]),
            int(cfg["cli"][cfg["cli"].index("--repetitions") + 1]))
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # the whole check must fit 43200 s with 24 cells
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (
        SPEC["run_seconds"] + 60)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["workloads"] + SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    cells = {c["name"] for c in SPEC["workloads"]}
    for c in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if c in m.get("workloads", [c])]
        assert len(reported) >= 2
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024
