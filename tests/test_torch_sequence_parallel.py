"""The port's sequence parallelism (``parallel/sequence.py``, the GaitSet
set pools over a seq group) on gloo CPU ranks, against the JAX package's
``make_sp_train_step`` on the 8-device virtual CPU mesh.

The tiny flagship with the JAX init's weights (``utils/weights.py``), a
global batch of 8 from a numpy seed, T = 25 padded to 26 at sp = 2.
Tolerances as ``tests/test_torch_parallel.py``: losses rtol 1e-5,
gradients per leaf 2e-4 x the leaf's largest |grad|, the JAX
``pairwise_dist`` diagonal zeroed; padding bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import TrainConfig as JTrainConfig
from ugaitnet_tpu.parallel import sequence as JQ

import torch_ranks as R
from test_torch_parallel import (batch_arrays, check_grads, check_metrics,
                                 jax_sharded, run_ranks, tcfg_of)
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.parallel import sequence as TQ
from ugaitnet_tpu_torch.parallel.sharding import Mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("t,sp", [(25, 2), (25, 4), (24, 2), (25, 1)])
def test_pad_frames_matches_jax(t, sp):
    v = np.random.RandomState(t + sp).randn(3, t, 4, 4, 2).astype(
        np.float32)
    got = TQ.pad_frames(torch.from_numpy(v), sp).numpy()
    want = np.asarray(JQ.pad_frames(jnp.asarray(v), sp))
    assert got.shape == want.shape and got.shape[1] % sp == 0
    assert np.array_equal(got, want)


def test_shard_batch_sp_takes_rows_and_frames():
    mesh = Mesh(shape={"data": 2, "seq": 2}, coords={"data": 1, "seq": 1},
                groups={}, rank=3, world=4, device=torch.device("cpu"),
                backend="gloo")
    b = R.batch_of(batch_arrays())
    local = TQ.shard_batch_sp(b, mesh)
    assert tuple(local.volumes[0].shape) == (4, 13, 60, 60, 2)
    assert torch.equal(local.volumes[1][:, :12], b.volumes[1][4:, 13:])
    # frame 25 repeats frame 24
    assert torch.equal(local.volumes[1][:, 12], b.volumes[1][4:, 24])
    assert torch.equal(local.labels, b.labels[4:])


@pytest.fixture(scope="module")
def params():
    from test_torch_parallel import np_tree
    import jax
    from ugaitnet_tpu.models.network import UGaitNet as JNet
    from ugaitnet_tpu.models.network import init_params
    return np_tree(init_params(JNet(graft._flagship_cfg(tiny=True)),
                               jax.random.PRNGKey(0), batch=2))


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)], ids=["dp1sp2",
                                                         "dp2sp2"])
def test_sp_step_matches_jax(params, tmp_path, dp, sp):
    jcfg = graft._flagship_cfg(tiny=True)
    arrays = batch_arrays()
    R.save(str(tmp_path / "in.pt"), {
        "params": params, "batch": arrays, "mcfg": tcfg_of(jcfg),
        "tcfg": dict(vars(JTrainConfig()))})
    pm, pg, shapes = run_ranks(tmp_path, R.sp_steps, dp * sp, dp, sp)
    assert shapes[0] == (8 // dp, 13, 60, 60, 2)
    jm, jg = jax_sharded(JQ.make_sp_train_step, jcfg, params, arrays,
                         dp * sp, mesh=JQ.make_mesh_dpsp(dp, sp),
                         shard=JQ.shard_batch_sp)
    check_metrics(pm, jm)
    check_grads(pg, jg)


def test_sp_rejects_non_gaitset_and_needs_its_mesh():
    cfg = tcfg_of(graft._flagship_cfg(tiny=True))
    conv = dataclasses.replace(cfg, branches=(dataclasses.replace(
        cfg.branches[0], kind="conv2d"),) + cfg.branches[1:])
    with pytest.raises(ValueError, match="requires gaitset branches"):
        TQ.sp_model_config(conv)
    with pytest.raises(ValueError, match="requires gaitset branches"):
        TQ.make_sp_train_step(conv, tconfig.TrainConfig(), None)
    with pytest.raises(ValueError, match="requires gaitset branches"):
        UGaitNet(dataclasses.replace(conv, seq_axis="seq"), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh with that axis"):
        UGaitNet(TQ.sp_model_config(cfg), device="cpu")
