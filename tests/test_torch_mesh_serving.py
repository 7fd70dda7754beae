"""The port's row-sharded gallery search on gloo CPU ranks: ``ops/knn.py``'s
``pad_gallery_int8`` and ``knn_predict_sharded``, the mesh mode of
``eval/serving.py:SignatureService``, ``eval/encode.py:encode_dataset``
with a mesh, and ``cli.evaluate --dp``, held against the one-device paths
and the JAX package's (on the 8-device virtual CPU mesh of
``tests/conftest.py``).  Mirrors ``tests/test_serving.py:381-430`` and the
sharded-kNN block of ``__graft_entry__.py:dryrun_multichip``.

One world of 4 ranks (``tests/torch_ranks.py:mesh_serving``) runs every
piece; each rank also builds the one-device service, so the parent holds
each rank's results against it.  Labels, neighbor distances, capacities
and tie order are compared exactly: a rank scores its rows with the one
device's ops, and the merge orders by (distance, row) as ``nearest`` does.
Codes: the mesh encode against the one-device encode within 1e-6 of the
codes' largest entry (the batch-axis L2 sums over the ranks in another
order), against JAX's mesh encode at ``tests/test_torch_head.py``'s
forward tolerance (rtol 1e-4, atol 1e-5).
"""

import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import BranchConfig as JBranchConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from ugaitnet_tpu.eval.encode import encode_dataset as j_encode
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import knn as JK
from ugaitnet_tpu.parallel import sharding as JS

import torch_ranks as R
from test_torch_parallel import np_tree, tcfg_of
from ugaitnet_tpu_torch.cli import evaluate
from ugaitnet_tpu_torch.cli.build_data import main as build_main
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import knn as TK
from ugaitnet_tpu_torch.parallel import sharding as S
from ugaitnet_tpu_torch.train.train_step import init_state

torch.set_num_threads(1)

N = 4
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
ENCODE_REL = 1e-6


def _knn_data():
    """The dryrun's 99-row gallery of 11 prototypes (99 % 4 != 0)."""
    rng = np.random.RandomState(1)
    protos = rng.randn(11, 64).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    gal = np.repeat(protos, 9, 0) + rng.randn(99, 64).astype(
        np.float32) * 0.05
    glab = np.repeat(np.arange(11), 9)
    probes = np.repeat(protos, 2, 0) + rng.randn(22, 64).astype(
        np.float32) * 0.05
    return probes, gal, glab


def _ties():
    """30 random rows, of which rows 5, 13, 21 and 29 (one in each rank's
    block of 8) are one code under labels 0..3: the k = 3 nearest of that
    code are rows 5, 13, 21, whose vote is label 0; any other choice of
    three votes otherwise."""
    rng = np.random.RandomState(2)
    codes = rng.randn(30, 16).astype(np.float32)
    labels = 10 + np.arange(30)
    for lab, row in enumerate((5, 13, 21, 29)):
        codes[row] = codes[5]
        labels[row] = lab
    return {"codes": codes, "labels": labels, "queries": codes[[5, 0]]}


def _serve_cfg():
    kw = dict(gaitset_channels=(4, 4, 8), part_dim=8)
    return JModelConfig(
        branches=(JBranchConfig(kind="gaitset", modality="of", **kw),
                  JBranchConfig(kind="gaitset", modality="gray", **kw)),
        merge="sign_max", nclasses=0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    serve_cfg, enc_cfg = _serve_cfg(), graft._flagship_cfg(tiny=True)
    inp = {"knn": _knn_data(), "ties": _ties(),
           "serve_cfg": tcfg_of(serve_cfg), "encode_cfg": tcfg_of(enc_cfg),
           "serve_params": np_tree(init_params(JNet(serve_cfg),
                                               jax.random.PRNGKey(0))),
           "encode_params": np_tree(init_params(JNet(enc_cfg),
                                                jax.random.PRNGKey(0),
                                                batch=2))}
    R.save(str(work / "in.pt"), inp)
    S.spawn(R.mesh_serving, N, args=(str(work), N), devices=["cpu"] * N,
            init_file=str(work / "rdzv"), threads=1)
    return inp, [R.load(str(work / f"serve{r}.pt")) for r in range(N)]


def test_pad_gallery_int8_bitwise_jax():
    codes = np.random.RandomState(3).randn(13, 24).astype(np.float32)
    quantized = JK.quantize_gallery(codes)
    dense = np.arange(13, dtype=np.int32) % 5
    for multiple in (1, 4, 8):
        got = TK.pad_gallery_int8(*quantized, dense, multiple)
        want = JK.pad_gallery_int8(*quantized, dense, multiple)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(got[0]) % multiple == 0
        assert (got[2][13:] == np.float32(1e12)).all()


def test_knn_predict_sharded_matches_jax(ranks):
    inp, res = ranks
    probes, gal, glab = inp["knn"]
    one = TK.knn_predict(probes, gal, glab, k=3, device="cpu")
    mesh = JS.make_mesh(N)
    for dt in ("float32", "int8"):
        want = JK.knn_predict_sharded(probes, gal, glab, mesh, k=3,
                                      gallery_dtype=dt)
        for r in res:
            np.testing.assert_array_equal(r["knn"][dt], want, err_msg=dt)
            np.testing.assert_array_equal(r["knn"][dt], one, err_msg=dt)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mesh_service_equals_one_device(ranks, dtype):
    _, res = ranks
    for rank, r in enumerate(res):
        one, mesh = r[dtype]["one"], r[dtype]["mesh"]
        # 30 rows: capacity 32 in blocks of 8; after the rebuild, 64
        assert mesh["capacity"] == one["capacity"] == 32
        assert mesh["rows"] == 8 and one["rows"] == 32
        assert mesh["in_place"] and one["in_place"]
        assert mesh["removed"] == one["removed"] >= 1
        assert mesh["capacity_after"] == one["capacity_after"] == 64
        for k in ("identify", "enrolled", "after_remove", "rebuilt",
                  "ties"):
            for a, b in zip(mesh[k], one[k]):
                np.testing.assert_array_equal(a, b, err_msg=f"{rank} {k}")
        labels, dists = mesh["ties"]
        assert labels[0] == 0 and len(set(dists[0].tolist())) == 1


def test_mesh_service_remove_answers_no_removed_label(ranks):
    """After the enrolled label is removed, no query returns it (the
    enrolled labels are the gallery's + 100)."""
    _, res = ranks
    for dt in ("float32", "int8"):
        assert (res[0][dt]["mesh"]["after_remove"][0] < 100).all()


def test_mesh_encode_equals_one_device_and_jax(ranks):
    inp, res = ranks
    one = res[0]["encode"]["one"]
    for r in res:
        got = r["encode"]["mesh"]
        assert got.shape == one.shape
        assert np.abs(got - one).max() <= ENCODE_REL * np.abs(one).max()
    ds = j_synth(num_subjects=5, videos_per_subject=2, subseqs_per_video=3,
                 seed=7)
    jcfg = graft._flagship_cfg(tiny=True)
    want = j_encode(JNet(jcfg), {"params": inp["encode_params"]["params"]},
                    ds, ("of", "gray"), batch_size=8,
                    mesh=JS.make_mesh(N))[0]
    np.testing.assert_allclose(res[0]["encode"]["mesh"], want,
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    with pytest.raises(ValueError, match="not divisible"):
        from ugaitnet_tpu_torch.eval.encode import encode_dataset
        from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
        encode_dataset(
            UGaitNet(inp["encode_cfg"], device="cpu"),
            make_synthetic_dataset(num_subjects=2, videos_per_subject=1,
                                   subseqs_per_video=2),
            ("of", "gray"), batch_size=6, mesh=S.Mesh(
                shape={"data": 4}, coords={"data": 0}, groups={"data": None},
                rank=0, world=4, device=torch.device("cpu"),
                backend="gloo"))


def test_evaluate_dp_equals_one_process(tmp_path):
    """``cli.evaluate --dp 2 --device cpu`` gives the results of the
    one-process evaluate on the same checkpoint and sets."""
    data = str(tmp_path / "packed")
    build_main(["--synthetic", "--outdir", data])
    mcfg = tconfig.ModelConfig(
        branches=(tconfig.BranchConfig(kind="gaitset", modality="of",
                                       gaitset_channels=(4, 4, 8),
                                       part_dim=8),
                  tconfig.BranchConfig(kind="gaitset", modality="gray",
                                       gaitset_channels=(4, 4, 8),
                                       part_dim=8)),
        merge="sign_max", nclasses=5)
    exp = str(tmp_path / "exp")
    os.makedirs(exp)
    tconfig.dump_json(os.path.join(exp, "config.json"), model=mcfg,
                      data=tconfig.DataConfig(), train=tconfig.TrainConfig())
    ckpt.save_checkpoint(exp, 1, init_state(UGaitNet(mcfg, device="cpu"),
                                            tconfig.TrainConfig()))
    flags = ["--experdir", exp, "--gallery", data, "--probes", data,
             "--bs", "8", "--device", "cpu"]
    one = evaluate.main(flags + ["--outfile", str(tmp_path / "one.json")])
    for f in os.listdir(exp):          # no cached codes for the --dp run
        if f.startswith("codes_"):
            os.unlink(os.path.join(exp, f))
    assert evaluate.main(flags + ["--dp", "2", "--outfile",
                                  str(tmp_path / "dp.json")]) is None
    import json
    got = json.load(open(tmp_path / "dp.json"))
    assert got == json.loads(json.dumps(one, default=float))
    assert any(f.startswith("codes_gallery") for f in os.listdir(exp))
