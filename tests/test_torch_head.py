"""The port's head surface (``models/network.py:_head_forward``) against the
JAX package's, on the CPU: the extra dense "code" head (casenet C) with
postriplet 1 and 2, the per-branch aux heads, GaitSet ``flatten_output``,
the weight bridge for those subtrees, the typecode-2 (``code``) serving
path and the dropcode masks.

Nets: the tiny flagship (two GaitSet branches, channels (8, 8, 16),
part_dim 16, sign_max, 74 classes) with an extra dense of 24 units, so
extra_dense != part_dim, and a tiny 2D CNN pair.  Inputs are seeded numpy;
the JAX params reach the port through the weight bridge.

Tolerances: forward taps at rtol 1e-4 / atol 1e-5, the forward tolerance
of tests/test_torch_port.py (measured max abs error 1.4e-6 over every
tap of the GaitSet configs, 4.3e-6 on the 2D CNN pair's logits, torch on
one thread); the bridge round trip and the exported artifact bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import BranchConfig as JBranch
from ugaitnet_tpu.eval.serving import SignatureService as JService
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.export import ExportedEncoder, export_encoder
from ugaitnet_tpu_torch.eval.serving import SignatureService
from ugaitnet_tpu_torch.models.network import UGaitNet, _head_forward
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
MODS = ("of", "gray")
EXTRA = 24


def _jcfg(name):
    cfg = graft._flagship_cfg(tiny=True)
    if name.startswith("conv2d"):
        b = dict(kind="conv2d", filters_numbers=(8, 8, 16, 16),
                 ndense_units=16)
        cfg = dataclasses.replace(cfg, branches=(
            JBranch(modality="of", **b), JBranch(modality="gray", **b)))
    if name.startswith("flatten_output"):
        cfg = dataclasses.replace(cfg, branches=tuple(
            dataclasses.replace(b, flatten_output=True)
            for b in cfg.branches))
    kw = {}
    if "pt" in name:
        kw.update(extra_dense=(EXTRA,), postriplet=int(name[-1]))
    if "aux" in name:
        kw.update(aux_losses=True)
    return dataclasses.replace(cfg, **kw)


CONFIGS = ["pt1", "pt2", "aux_pt1", "aux_pt2", "aux", "flatten_output_aux",
           "flatten_output_pt2", "conv2d_aux_pt2"]


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


_NETS = {}


def _nets(name):
    """(JAX config, JAX model, params, port model), built once per name."""
    if name not in _NETS:
        jcfg = _jcfg(name)
        jmodel = JNet(jcfg)
        params = jax.jit(lambda k: init_params(jmodel, k, batch=2))(
            jax.random.PRNGKey(1))
        tmodel = UGaitNet(_tcfg(jcfg), device="cpu", seed=5)
        tmodel.load_state_dict(flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params)))
        _NETS[name] = (jcfg, jmodel, params, tmodel)
    return _NETS[name]


FLAGS = [np.array([1, 0, 1, 1], np.float32),
         np.array([1, 1, 0, 1], np.float32)]


def _volumes(seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 25, 60, 60, 2).astype(np.float32),
            rng.randn(4, 25, 60, 60, 1).astype(np.float32))


def _close(got, want, key):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{key}[{i}]")
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL,
                               err_msg=key)


@pytest.mark.parametrize("name", CONFIGS)
def test_head_taps_match(name):
    jcfg, jmodel, params, tmodel = _nets(name)
    vols = _volumes()
    jout = jax.jit(lambda p, v, f: jmodel.apply(p, v, f, train=False))(
        params, [jnp.asarray(v) for v in vols],
        [jnp.asarray(f) for f in FLAGS])
    with torch.no_grad():
        tout = tmodel([torch.from_numpy(v) for v in vols],
                      [torch.from_numpy(f) for f in FLAGS], train=False)
    assert set(tout) == set(jout)
    assert ("code" in tout) == ("pt" in name)
    assert ("aux_logits" in tout) == ("aux" in name)
    for key in sorted(jout):
        _close(tout[key], jout[key], key)
    if name.endswith("pt2"):
        assert torch.equal(tout["signature"], tout["code"])


def test_classprob_width_follows_extra_dense():
    """The id head reads the flattened extra-dense output: parts x
    extra_dense[0], not parts x part_dim (24 != 16 here)."""
    jcfg, _, params, tmodel = _nets("aux_pt2")
    assert tuple(tmodel.classprob.weight.shape) == (74, 62 * EXTRA)
    assert params["params"]["classprob"]["kernel"].shape == (62 * EXTRA, 74)
    assert tuple(tmodel.extra_dense.weight.shape) == (EXTRA, 16)
    for m in MODS:
        assert tuple(getattr(tmodel, f"classprob_{m}").weight.shape) == \
            (74, 62 * 16)
    # a fresh port net sizes it the same without the JAX tree
    fresh = UGaitNet(_tcfg(jcfg), device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == \
        {k: v.shape for k, v in tmodel.state_dict().items()}


@pytest.mark.parametrize("name", ["aux_pt2", "conv2d_aux_pt2"])
def test_weight_bridge_round_trip_with_head_subtrees(name):
    _, _, params, tmodel = _nets(name)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, params))
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_flax(tmodel.state_dict())))
    assert len(got) == len(want)
    names = {str(p[1].key) for p, _ in want}
    assert {"extra_dense", "classprob", "classprob_of",
            "classprob_gray"} <= names
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype, path
        assert np.array_equal(got[path], leaf), path


@pytest.fixture(scope="module")
def clips():
    ds = make_synthetic_dataset(num_subjects=3, videos_per_subject=2,
                                subseqs_per_video=1, num_cams=2,
                                template_seed=0, seed=1)
    raw = {f"raw_{m}": ds.modalities[m].volumes[:6] for m in MODS}
    raw["present_gray"] = np.array([1, 1, 0, 1, 1, 1], np.float32)
    return raw


@pytest.mark.parametrize("name", ["pt1", "aux_pt2"])
def test_service_typecode2_codes_match_jax(name, clips):
    _, jmodel, params, tmodel = _nets(name)
    jsvc = JService(jmodel, params, MODS, typecode=2, buckets=(4,))
    tsvc = SignatureService(tmodel, MODS, typecode=2, buckets=(4,))
    want, got = jsvc.encode_raw(clips), tsvc.encode_raw(clips)
    assert got.shape == want.shape == (6, 62 * EXTRA)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)


def test_typecode2_artifact_round_trip_bitwise(clips, tmp_path):
    _, _, _, tmodel = _nets("aux_pt2")
    svc = SignatureService(tmodel, MODS, typecode=2, buckets=(4,))
    export_encoder(svc, str(tmp_path))
    got = ExportedEncoder(str(tmp_path), device="cpu").encode(clips)
    assert np.array_equal(got, svc.encode_raw(clips))


def test_int8_still_refuses_extra_dense():
    _, _, _, tmodel = _nets("pt2")
    for typecode in (2, 3):
        with pytest.raises(ValueError, match="extra_dense"):
            SignatureService(tmodel, MODS, typecode=typecode,
                             quantized=True, calib_volumes=[])


def _head(net, key, train=True, seed=0):
    rng = np.random.RandomState(seed)
    emb = [torch.from_numpy(rng.randn(4, 62, 16).astype(np.float32))
           for _ in MODS]
    flags = [torch.ones(4) for _ in MODS]
    with torch.no_grad():
        return _head_forward(net.config, emb, flags, net, train, key)


def test_dropcode_masks():
    """Dropcode keeps about 1 - rate of its units, scales them by 1 / (1 -
    rate), draws from (the head's seed, key) without touching the global
    RNG, and only in train mode."""
    _, _, _, tmodel = _nets("pt1")
    rate = tmodel.config.dropout_code
    assert rate == 0.4
    state = torch.get_rng_state()
    out = _head(tmodel, key=7)
    assert torch.equal(torch.get_rng_state(), state)
    code, flat = out["code"].reshape(4, -1), out["flatten"]
    kept = flat != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.03
    np.testing.assert_allclose(flat[kept].numpy(),
                               (code[kept] / (1 - rate)).numpy(), rtol=1e-6)
    assert torch.equal(_head(tmodel, key=7)["flatten"], flat)
    assert not torch.equal(_head(tmodel, key=8)["flatten"], flat)
    assert torch.equal(_head(tmodel, key=None, train=False)["flatten"], code)
    with pytest.raises(ValueError, match="key"):
        _head(tmodel, key=None)


def test_dropcode_redraws_per_step_in_the_train_step():
    """The train step keys dropcode by its step count: step k of one run
    and step k of another from the same weights draw the same mask."""
    from ugaitnet_tpu_torch.train.train_step import Batch, compute_losses
    _, _, _, tmodel = _nets("pt2")
    mcfg = tmodel.config
    tcfg = tconfig.TrainConfig(triplet_kind="batch_all_xla")
    vols = [torch.from_numpy(v[:2]) for v in _volumes(3)]
    batch = Batch(tuple(vols), tuple(torch.ones(2) for _ in MODS),
                  torch.tensor([0, 1]))
    tmodel.train()
    try:
        with torch.no_grad():
            a = compute_losses(tmodel, batch, mcfg, tcfg, key=3)[1]["id_ce"]
            b = compute_losses(tmodel, batch, mcfg, tcfg, key=3)[1]["id_ce"]
            c = compute_losses(tmodel, batch, mcfg, tcfg, key=4)[1]["id_ce"]
    finally:
        tmodel.eval()
    assert float(a) == float(b) != float(c)
