"""The port's train CLI with ``--ep 2 --moe 4`` on two gloo CPU ranks
against the JAX train CLI with the same flags: the flags, tolerances and
planted fault of ``tests/test_torch_trainer_parallel.py``, whose helpers
run it (a file of its own to keep each near 120 s)."""

import pytest

import test_torch_trainer_parallel as T


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    return T.run_clis("ep2", tmp_path_factory)


def test_cli_epoch_losses_match_jax(cli_runs):
    T.check_epoch_losses(*cli_runs)


def test_cli_world_factor_fault_fails(cli_runs, tmp_path):
    T.check_world_factor_fault(*cli_runs, tmp_path)
