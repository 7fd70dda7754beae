"""Resume across world sizes: a run whose first epoch trained on 2 gloo
CPU ranks continues in one process, and the reverse, through the port's
train CLI.  Checkpoints hold the one-process layout (rank 0 writes them),
so both land on the uninterrupted one-process run's per-epoch losses.  An
expert-parallel run (``--ep 2 --moe 4``), whose ranks hold half of every
``expert_proj`` and of its optimizer moments, writes them whole and
continues in one process.

The tiny two-branch config of ``tests/test_torch_trainer_parallel.py``
(its FLAGS and initial weights).  Tolerance: per-epoch train and
validation losses within 1e-5 relative: the global form is the
one-process step up to float32 summation order (measured ~1e-7).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_trainer_parallel import FLAGS, _by_epoch, _init_experiments
from ugaitnet_tpu_torch.cli import train

torch.set_num_threads(1)

RESUME_RTOL = 1e-5


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    """Epoch 1 at world 1 and at world 2, then epoch 2 resumed at world 1
    and at world 2 from each."""
    root = tmp_path_factory.mktemp("resume")
    _init_experiments(root, [])
    moe_root = root / "moe"
    moe_root.mkdir()
    _init_experiments(moe_root, ["--moe", "4"])

    def cli(name, mode, epochs, base=root, extra=()):
        flags = FLAGS + list(extra) + [
            "--device", "cpu", "--initnet", str(base / "init_port"),
            "--experdir", str(base / name), "--epochs", str(epochs)]
        return train.main(flags + mode)
    one = cli("one", [], 1)
    two = cli("two_one", ["--ndevices", "2"], 1)
    shutil.copytree(root / "one", root / "one_two")
    cli("one", [], 2)
    cli("two_one", [], 2)
    cli("one_two", ["--ndevices", "2"], 2)
    moe = ("--moe", "4")
    ep = cli("ep_one", ["--ep", "2"], 1, moe_root, moe)
    cli("ep_one", [], 2, moe_root, moe)
    moe_one = cli("moe_one", [], 2, moe_root, moe)
    return {"uninterrupted": _by_epoch(one),
            "2 -> 1": _by_epoch(two),
            "1 -> 2": _by_epoch(str(root / "one_two" /
                                    os.path.basename(one))),
            "moe uninterrupted": _by_epoch(moe_one),
            "ep 2 -> 1": _by_epoch(ep)}


@pytest.mark.parametrize("case", ["2 -> 1", "1 -> 2", "ep 2 -> 1"])
def test_resume_across_world_sizes(resume_runs, case):
    want = resume_runs["moe uninterrupted" if case.startswith("ep")
                       else "uninterrupted"]
    got = resume_runs[case]
    for k in ("train/loss", "train/id_ce", "val/loss"):
        assert sorted(got[k]) == sorted(want[k]) == [1, 2], (case, k)
        for e in (1, 2):
            np.testing.assert_allclose(got[k][e], want[k][e],
                                       rtol=RESUME_RTOL,
                                       err_msg=f"{case} {k} epoch {e}")
