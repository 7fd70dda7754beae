"""The PyTorch port (ugaitnet_tpu_torch) held against the JAX package on the
CPU: weight bridge, preprocessing, fusion, the GaitSet branch and the full
UGaitNet forward, at the tiny flagship (channels (8, 8, 16), part_dim 16).

Inputs come from numpy seeds and go through both packages; the flax params
are carried into the port by utils/weights.py.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import DataConfig as JDataConfig
from ugaitnet_tpu.data.pipeline import _dropout_masks as j_dropout_masks
from ugaitnet_tpu.data.pipeline import preprocess_batch as j_preprocess
from ugaitnet_tpu.models.gaitset import GaitSetBranch as JBranch
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import preprocess as JP
from ugaitnet_tpu.ops.fusion import merge_sign_max as j_sign_max

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.core.device import resolve_device
from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import preprocess as TP
from ugaitnet_tpu_torch.ops.fusion import merge_sign_max
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 forward: the two frameworks sum the convolutions and the HPP means in
# different orders; over 10 conv layers that stays within a few 1e-6 of
# values of order 1e-1..1 (measured max abs err ~1e-6 at the tiny flagship)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5


def _tcfg(jcfg):
    """The port's ModelConfig with the same fields as a JAX one."""
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = graft._flagship_cfg(tiny=True)
    jmodel = JNet(jcfg)
    params = init_params(jmodel, jax.random.PRNGKey(0), batch=2)
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_to_np(params)))
    return jcfg, jmodel, params, tmodel


def _volumes(b, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 25, 60, 60, 2).astype(np.float32),
            rng.randn(b, 25, 60, 60, 1).astype(np.float32))


def test_weight_bridge_round_trip_bit_exact(tiny):
    _, _, params, tmodel = tiny
    back = state_dict_to_flax(tmodel.state_dict())
    want = jax.tree_util.tree_leaves_with_path(_to_np(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want) == 2 * 11 + 2
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype, path
        assert np.array_equal(got[path], leaf), path


def test_weight_bridge_layouts(tiny):
    _, _, params, tmodel = tiny
    sd = tmodel.state_dict()
    p = _to_np(params)["params"]
    k = p["branch_of"]["a_conv1"]["kernel"]                  # (5, 5, 2, 8)
    assert sd["branches.branch_of.a_conv1.weight"].shape == (8, 2, 5, 5)
    assert np.array_equal(sd["branches.branch_of.a_conv1.weight"][3, 1]
                          .numpy(), k[:, :, 1, 3])
    assert sd["classprob.weight"].shape == (74, 62 * 16)


def _raw(b, seed, normalize):
    rng = np.random.RandomState(seed)
    raw = {
        "raw_of": rng.randint(-3000, 3000, (b, 50, 60, 60)).astype(np.int16),
        "raw_gray": rng.randint(0, 255, (b, 25, 60, 60)).astype(np.uint8),
        "present_of": (rng.rand(b) > 0.3).astype(np.float32),
        "present_gray": np.ones((b,), np.float32),
        "labels": np.repeat(np.arange(b // 2), 2).astype(np.int32),
    }
    if normalize:
        raw["source"] = rng.randint(0, 2, (b,)).astype(np.int32)
        for m, n in (("of", 50), ("gray", 25)):
            raw[f"norm_mean_{m}"] = rng.randn(2, n).astype(np.float32) * 0.1
            raw[f"norm_std_{m}"] = (rng.rand(2, n) + 0.5).astype(np.float32)
    return raw


@pytest.mark.parametrize("expand", [1, 3])
@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_bitwise(expand, normalize):
    b = 4
    raw = _raw(b, 7 + expand, normalize)
    key = jax.random.PRNGKey(3)
    jvols, jflags, jlab = j_preprocess(
        {k: jnp.asarray(v) for k, v in raw.items()}, key, ("of", "gray"),
        (2, 1), (100.0, 1.0), 2, expand, False, JDataConfig(),
        normalize=normalize)
    # the same keep-masks the JAX call drew from its dropout key
    masks = np.asarray(j_dropout_masks(jax.random.split(key, 2)[1], b, 2,
                                       expand))
    tvols, tflags, tlab = preprocess_batch(
        raw, ("of", "gray"), (2, 1), (100.0, 1.0), 2, expand, False,
        tconfig.DataConfig(), normalize=normalize, masks=masks,
        device="cpu")
    for jv, tv in zip(jvols, tvols):
        assert tuple(tv.shape) == jv.shape
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    for jf, tf in zip(jflags, tflags):
        assert np.array_equal(tf.numpy(), np.asarray(jf))
    assert np.array_equal(tlab.numpy(), np.asarray(jlab))


def test_preprocess_helpers_bitwise():
    """ops/preprocess.py against the JAX helpers as XLA compiles them (the
    way preprocess_batch runs them)."""
    rng = np.random.RandomState(5)
    of = rng.randint(-3000, 3000, (2, 50, 6, 6)).astype(np.int16)
    u8 = rng.randint(0, 255, (2, 25, 6, 6)).astype(np.uint8)
    flags = np.array([1.0, 0.0], np.float32)
    pairs = [
        (jax.jit(lambda r: JP.dequantize(r, 100.0, 2, 2300.0, 50.0))(of),
         TP.dequantize(torch.from_numpy(of), 100.0, 2, 2300.0, 50.0)),
        (jax.jit(lambda r: JP.dequantize(r, 37.0, 1))(of),
         TP.dequantize(torch.from_numpy(of), 37.0, 1)),
        (jax.jit(JP.normalize_uint8)(u8),
         TP.normalize_uint8(torch.from_numpy(u8))),
        (jax.jit(lambda r: JP.normalize_uint8(r, True))(u8),
         TP.normalize_uint8(torch.from_numpy(u8), True)),
    ]
    frames = JP.planes_to_frames(jnp.asarray(of), 2)
    tframes = TP.planes_to_frames(torch.from_numpy(of), 2)
    pairs += [(frames, tframes),
              (JP.frames_to_planes(frames), TP.frames_to_planes(tframes)),
              (JP.apply_modality_dropout(frames.astype(jnp.float32),
                                         jnp.asarray(flags)),
               TP.apply_modality_dropout(tframes.float(),
                                         torch.from_numpy(flags)))]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_preprocess_draws_two_modality_masks():
    raw = _raw(6, 1, False)
    gen = torch.Generator().manual_seed(0)
    _, flags, labels = preprocess_batch(
        raw, ("of", "gray"), (2, 1), (100.0, 1.0), 2, 3, False,
        tconfig.DataConfig(), generator=gen, device="cpu")
    of, gray = (f.reshape(6, 3).numpy() for f in flags)
    present = raw["present_of"]
    # copy 0 keeps the sample's own flags; copies 1 and 2 each drop one
    # modality, and between them both
    assert np.array_equal(of[:, 0], present) and gray[:, 0].all()
    assert np.array_equal(gray[:, 1] + gray[:, 2], np.ones(6))
    assert np.array_equal(of[:, 1] + of[:, 2], present)
    assert np.array_equal(labels.numpy(), np.repeat(raw["labels"], 3))
    # with augmentation on, the same generator draws the same masks after
    # the transform params
    gen = torch.Generator().manual_seed(0)
    vols, aug_flags, _ = preprocess_batch(
        raw, ("of", "gray"), (2, 1), (100.0, 1.0), 2, 3, True,
        tconfig.DataConfig(), generator=gen, device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in vols)
    of, gray = (f.reshape(6, 3).numpy() for f in aug_flags)
    assert np.array_equal(gray[:, 1] + gray[:, 2], np.ones(6))


def test_sign_max_ties_first_wins():
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3, 5).astype(np.float32)
    b = rng.randn(4, 3, 5).astype(np.float32)
    b[0] = -a[0]            # |a| == |b|: the first branch must win
    b[1] = a[1]
    c = np.where(rng.rand(4, 3, 5) > 0.5, -a, b).astype(np.float32)
    for embs in ([a, b], [a, b, c], [b, a]):
        want = np.asarray(j_sign_max([jnp.asarray(e) for e in embs]))
        got = merge_sign_max([torch.from_numpy(e) for e in embs]).numpy()
        assert np.array_equal(got, want)


def test_gaitset_branch_matches(tiny):
    jcfg, _, params, tmodel = tiny
    bc = jcfg.branches[0]
    of, _ = _volumes(3, seed=1)
    jb = JBranch(channels=bc.gaitset_channels, hpp_bins=bc.hpp_bins,
                 part_dim=bc.part_dim, leaky_alpha=bc.leaky_alpha)
    want = np.asarray(jb.apply({"params": params["params"]["branch_of"]},
                               jnp.asarray(of)))
    with torch.no_grad():
        got = tmodel.branches["branch_of"](torch.from_numpy(of)).numpy()
    assert got.shape == want.shape == (3, 62, 16)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)


def _outputs(jcfg, params, tmodel, flags):
    of, gray = _volumes(4, seed=2)
    vols = [of, gray][:len(jcfg.branches)]
    jout = JNet(jcfg).apply(params, [jnp.asarray(v) for v in vols],
                            [jnp.asarray(f) for f in flags], train=False)
    with torch.no_grad():
        tout = tmodel([torch.from_numpy(v) for v in vols],
                      [torch.from_numpy(f) for f in flags])
    return jout, tout


FLAGS = [np.array([1, 0, 1, 1], np.float32),
         np.array([1, 1, 0, 1], np.float32)]


def test_ugaitnet_outputs_match(tiny):
    jcfg, _, params, tmodel = tiny
    jout, tout = _outputs(jcfg, params, tmodel, FLAGS)
    assert set(tout) == set(jout)
    for key in ("signature", "flatten", "classprob_logits", "classprob",
                "fused"):
        want = np.asarray(jout[key])
        got = tout[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("variant", ["max", "average_norm", "single"])
def test_head_variants_match(variant):
    """The head's other paths: merge max, average with per-branch L2
    before the merge, and the single-modality net (no signature L2)."""
    import dataclasses
    jcfg = graft._flagship_cfg(tiny=True)
    if variant == "max":
        jcfg = dataclasses.replace(jcfg, merge="max", nclasses=0)
    elif variant == "average_norm":
        jcfg = dataclasses.replace(jcfg, merge="average",
                                   norm_before_merge=True, nclasses=0)
    else:
        jcfg = dataclasses.replace(jcfg, branches=jcfg.branches[:1],
                                   nclasses=5)
    params = init_params(JNet(jcfg), jax.random.PRNGKey(1), batch=2)
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_to_np(params)))
    jout, tout = _outputs(jcfg, params, tmodel, FLAGS[:len(jcfg.branches)])
    assert set(tout) == set(jout)
    for key in ("signature", "flatten"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=key)


def test_missing_modality_equals_noise_input(tiny):
    """use_flag=0 gates the branch to exactly 0, whatever its input."""
    _, _, _, tmodel = tiny
    of, gray = _volumes(2, seed=3)
    flags = [torch.ones(2), torch.zeros(2)]
    noise = np.full_like(gray, 1e-9)
    with torch.no_grad():
        a = tmodel([torch.from_numpy(of), torch.from_numpy(gray)], flags)
        b = tmodel([torch.from_numpy(of), torch.from_numpy(noise)], flags)
    assert torch.equal(a["signature"], b["signature"])


def test_unported_options_raise():
    from ugaitnet_tpu_torch.eval.serving import SignatureService
    jcfg = graft._flagship_cfg(tiny=True)
    cfg = _tcfg(jcfg)
    import dataclasses
    # seq_axis needs the mesh whose axis it names (parallel/sequence.py);
    # the MoE projection is ported (ops/moe.py)
    with pytest.raises(ValueError, match="needs a mesh with that axis"):
        UGaitNet(dataclasses.replace(cfg, seq_axis="sp"), device="cpu")
    moe = UGaitNet(dataclasses.replace(cfg, branches=(dataclasses.replace(
        cfg.branches[0], moe_experts=4),) + cfg.branches[1:]), device="cpu")
    assert tuple(moe.branches["branch_of"].expert_proj.shape) == (4, 16, 16)
    with pytest.raises(ValueError, match="unknown branch kind"):
        UGaitNet(dataclasses.replace(cfg, branches=(dataclasses.replace(
            cfg.branches[0], kind="conv1d"),) + cfg.branches[1:]),
            device="cpu")
    model = UGaitNet(cfg, device="cpu")
    # mesh serving is ported (test_torch_mesh_serving.py); a mesh of one
    # rank holds the whole gallery and answers as the one-device service
    from ugaitnet_tpu_torch.parallel.sharding import Mesh
    one_rank = Mesh(shape={"data": 1}, coords={"data": 0},
                    groups={"data": None}, rank=0, world=1,
                    device=torch.device("cpu"), backend="gloo")
    codes = np.random.RandomState(0).randn(12, 8).astype(np.float32)
    got, want = (SignatureService(model, ("of", "gray"), mesh=m)
                 for m in (one_rank, None))
    for svc in (got, want):
        svc.set_gallery(codes, np.arange(12) % 5)
    for a, b in zip(got.identify_codes(codes), want.identify_codes(codes)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="gallery_dtype"):
        SignatureService(model, ("of", "gray"), gallery_dtype="int4")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = _tcfg(graft._flagship_cfg(tiny=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UGaitNet(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess_batch(_raw(2, 0, False), ("of", "gray"), (2, 1),
                         (100.0, 1.0), 2, 1, False, tconfig.DataConfig())
    assert resolve_device("cpu").type == "cpu"


# the JAX prototypes under benchmarks/ import JAX too
BANNED = {"jax", "flax", "optax", "orbax", "ugaitnet_tpu", "benchmarks"}
# modules of the later slices, which must be among those scanned
TRAINER_SLICE = ("train/schedule.py", "train/trainer.py", "obsv/logger.py",
                 "utils/net_utils.py", "data/native.py", "core/checkpoint.py",
                 "cli/train.py", "cli/evaluate.py", "models/branches.py",
                 "ops/quantize.py", "eval/export.py", "cli/export_model.py",
                 "data/partitions.py", "data/convert.py", "data/builders.py",
                 "data/tfrecord.py", "data/dataset_info.py",
                 "utils/warm_start.py", "utils/keras_import.py",
                 "utils/keras_export.py", "cli/build_data.py",
                 "cli/sweep.py", "parallel/sharding.py",
                 "parallel/sequence.py", "parallel/expert.py",
                 "parallel/dryrun.py", "ops/moe.py", "ops/collectives.py",
                 "ops/cuda/stage_tail.py", "ops/conv3x3.py",
                 "ops/cuda/conv3x3.py", "ops/cuda/probes.py")


def _port_sources():
    """The port, chip_smoke.py (whose phase 12 ranks run _p12_rank) and
    the test ranks' module, which spawned test processes import."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_ranks.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ugaitnet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files



def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 10
    for rel in TRAINER_SLICE:
        assert os.path.join(REPO, "ugaitnet_tpu_torch", rel) in files, rel
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BANNED, (path, n)


def test_config_json_drives_both(tmp_path):
    from ugaitnet_tpu.core.config import TrainConfig, dump_json
    jcfg = graft._flagship_cfg()
    path = str(tmp_path / "config.json")
    dump_json(path, model=jcfg, train=TrainConfig(), data=JDataConfig())
    got = tconfig.load_json(path)
    assert got["model"] == _tcfg(jcfg)
    assert vars(got["train"]) == vars(TrainConfig())
    assert vars(got["data"]) == vars(JDataConfig())
