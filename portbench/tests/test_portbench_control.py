"""The precision controls, on the card at the cells' widths with a smaller
data set: the program with TF32 on (train) and the reference in fp8 put
in the program's place (the bf16 encode) must come out not correct.  Run
on the chip:

    python -m pytest -q -m cuda portbench/tests
"""

import copy

import pytest
import torch

from conftest import load
from portbench import run

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the program's CUDA kernels)")


def cell(name, **params):
    c = copy.deepcopy(load("workloads", f"{name}.json"))
    c["params"].update(params)
    return c, load("configs", f"{c['config']}.json")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["gaitset.train", "cnn3d.train"])
def test_train_tf32_fails(card, name, seed):
    c, cfg = cell(name, ids=16, cameras=11)
    res = run.execute(c, cfg, seed, 1.0, False, control="tf32")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_encode_fp8_fails(card, seed):
    c, cfg = cell("gaitset.encode_bf16", ids=4, cameras=11)
    res = run.execute(c, cfg, seed, 1.0, False, control="fp8")
    assert not res["correct"], res["checks"]
    assert res["checks"]["code_err"]["value"] > c["limits"]["code_err"]

