"""The port's int8 encode (``ops/quantize.py``) held against the JAX
package's ``ugaitnet_tpu/ops/quantize.py`` on the CPU, for all three branch
families, at narrow widths (GaitSet: the tiny flagship; 2D CNN filters (16,
16, 32, 32); 3D CNN at its fixed spec), B = 2.

The JAX GaitSet path cannot run on XLA:CPU as it stands: its part
projection is a bf16 x bf16 einsum with float32 output, and XLA:CPU has no
BF16 x BF16 -> F32 dot.  The tests swap that one einsum, through a
test-local monkeypatch of the module's ``jnp``, for the same product on
float32 copies of the bf16 operands: bf16 x bf16 products are exact in
float32, so the semantics are the same.  The JAX package is not changed.

Tolerances:
  * int8 weights and per-channel scales: bitwise after the layout
    transpose (one formula, exact operations).
  * calibration scales: rtol 5e-6 (abs-maxes of float32 activations whose
    convolutions sum in another order; measured <= 2.8e-6).
  * the int8 conv's int32 sums: bitwise against ``lax.conv_general_dilated(
    ..., preferred_element_type=int32)``.
  * each ``*_branch_int8`` on the SAME carried quantized tree: max |port -
    JAX| <= 4e-6 x max |JAX|: the int8 activations are the same; what
    differs is float32 rounding in the float tails (set stream, HPP means,
    dense layers; GaitSet measured bitwise, the CNNs <= 8.5e-7).
  * the quantized service: labels equal; codes within the same limit.
  * int8 vs float32 codes (port only): cosine >= 0.99, the JAX package's
    limit (tests/test_quantize.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import __graft_entry__ as graft
from ugaitnet_tpu.core.config import BranchConfig as JBranchConfig
from ugaitnet_tpu.core.config import ModelConfig as JModelConfig
from ugaitnet_tpu.data.synthetic import make_synthetic_dataset as j_synth
from ugaitnet_tpu.eval.serving import SignatureService as JService
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.models.network import init_params
from ugaitnet_tpu.ops import quantize as JQ

from ugaitnet_tpu_torch.core import config as tconfig
from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.eval.serving import SignatureService
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import quantize as TQ
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              quantized_flax_to_state_dict,
                                              quantized_to_flax)

torch.set_num_threads(1)

CALIB_RTOL = 5e-6
INT8_REL = 4e-6
COS_MIN = 0.99
MODS = ("of", "gray")


class _F32Einsum:
    """``jax.numpy`` with einsum taking float32 copies of its operands."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, a, b, preferred_element_type=None):
        return jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32))


@pytest.fixture(autouse=True)
def _cpu_dot(monkeypatch):
    monkeypatch.setattr(JQ, "jnp", _F32Einsum())


def _jcfg(kind):
    if kind == "gaitset":
        return graft._flagship_cfg(tiny=True)
    kw = (dict(filters_numbers=(16, 16, 32, 32), ndense_units=32)
          if kind == "conv2d" else dict(ndense_units=32))
    return JModelConfig(branches=(
        JBranchConfig(kind=kind, modality="of", **kw),
        JBranchConfig(kind=kind, modality="gray", **kw)), merge="max",
        nclasses=0)


def _tcfg(jcfg):
    branches = tuple(tconfig.BranchConfig(**vars(b)) for b in jcfg.branches)
    kw = {k: v for k, v in vars(jcfg).items() if k != "branches"}
    return tconfig.ModelConfig(branches=branches, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _volumes(b, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, 25, 60, 60, 2) * 0.3).astype(np.float32),
            (rng.randn(b, 25, 60, 60, 1) * 0.3).astype(np.float32)]


@pytest.fixture(scope="module", params=["gaitset", "conv2d", "conv3d"])
def quantized(request):
    """Both packages' quantized nets from the same float weights and
    calibration volumes, and the port's net carrying JAX's int8 tree."""
    jcfg = _jcfg(request.param)
    jmodel = JNet(jcfg)
    params = jax.jit(lambda key: init_params(jmodel, key, batch=2))(
        jax.random.PRNGKey(0))
    tmodel = UGaitNet(_tcfg(jcfg), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(_np(params)))
    tmodel.eval()
    vols = _volumes(2, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JQ, "jnp", _F32Einsum())
        jq = JQ.quantize_model_params(params, jcfg,
                                      [jnp.asarray(v) for v in vols])
    own = TQ.quantize_model_params(tmodel, _tcfg(jcfg), vols)
    carried = TQ.quantize_model_params(tmodel, _tcfg(jcfg), vols)
    carried.load_state_dict(quantized_flax_to_state_dict(_np(jq)))
    return dict(kind=request.param, jcfg=jcfg, jmodel=jmodel, params=params,
                tmodel=tmodel, vols=vols, jq=jq, own=own, carried=carried)


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (7, 7, 50, 8),
                                   (3, 5, 5, 2, 64)])
def test_quantize_weight_bitwise(shape):
    rng = np.random.RandomState(0)
    w = rng.randn(*shape).astype(np.float32)          # HWIO / DHWIO
    wq, s = JQ.quantize_weight(jnp.asarray(w))
    perm = (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2))
    tq, ts = TQ.quantize_weight(torch.from_numpy(w.transpose(perm)))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(wq).transpose(perm))
    assert np.array_equal(ts.numpy(), np.asarray(s))


def test_calibration_and_weights_match(quantized):
    """The port's own quantization of the same float net: int8 kernels and
    scales bitwise, input scales within CALIB_RTOL; and the quantized-tree
    bridge round-trips JAX's tree bitwise."""
    jq, own = quantized["jq"], quantized["own"]
    mine = quantized_to_flax(own)
    n_conv = 0
    for name, sub in mine.items():
        for layer, leaf in sub.items():
            want = jq[name][layer]
            if not isinstance(leaf, dict) or "kernel_q" not in leaf:
                continue
            n_conv += 1
            assert np.array_equal(leaf["kernel_q"], want["kernel_q"]), layer
            assert np.array_equal(leaf["w_scale"], want["w_scale"]), layer
            assert float(leaf["in_scale"]) == pytest.approx(
                float(want["in_scale"]), rel=CALIB_RTOL), layer
    assert n_conv == {"gaitset": 12, "conv2d": 8,
                      "conv3d": 12}[quantized["kind"]]
    back = quantized_to_flax(quantized["carried"])
    want = {k: v for k, v in _np(jq).items() if k.startswith("branch_")}
    got = jax.tree_util.tree_leaves_with_path(back)
    ref = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got) == len(ref)
    for path, leaf in got:
        assert leaf.dtype == ref[path].dtype, path
        assert np.array_equal(leaf, ref[path]), path


@pytest.mark.parametrize("kernel,strides,same,cin,cout", [
    ((5, 5), (1, 1), True, 2, 8),        # GaitSet a_conv1 (K 50 -> 56)
    ((3, 3), (1, 1), True, 8, 16),
    ((7, 7), (1, 1), False, 3, 8),       # 2D CNN conv0 (K 147 -> 152)
    ((2, 2), (1, 1), False, 16, 8),
    ((3, 5, 5), (1, 2, 2), False, 2, 8),  # 3D CNN conv0 (K 150 -> 152)
    ((3, 3, 3), (2, 2, 2), False, 8, 16)])
def test_int8_conv_int32_matches_lax(monkeypatch, kernel, strides, same,
                                     cin, cout):
    """QuantConv's int32 sums against XLA's exact int32 conv, bitwise,
    with a small im2col budget so the rows go in several chunks."""
    monkeypatch.setattr(TQ, "IM2COL_BYTES", 1 << 16)
    rng = np.random.RandomState(len(kernel) + cin)
    spatial = (9, 20, 20) if len(kernel) == 3 else (14, 14)
    x = rng.randint(-127, 128, (5, *spatial, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (*kernel, cin, cout)).astype(np.int8)
    dn = (("NDHWC", "DHWIO", "NDHWC") if len(kernel) == 3
          else ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), strides, "SAME" if same else "VALID",
        dimension_numbers=dn, preferred_element_type=jnp.int32))
    conv = TQ.QuantConv(torch.from_numpy(np.moveaxis(w, -1, 0).copy()),
                        torch.ones(cout), 1.0, None, strides, same)
    got = conv(torch.from_numpy(x), lambda y: y)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_branch_int8_matches_jax(quantized):
    """Each ``*_branch_int8`` against JAX's on the same quantized tree,
    the JAX side jitted with the tree as an argument (as its service runs
    it)."""
    kind, jcfg = quantized["kind"], quantized["jcfg"]
    jfn = {"gaitset": JQ.gaitset_branch_int8,
           "conv2d": JQ.conv2d_branch_int8,
           "conv3d": JQ.conv3d_branch_int8}[kind]
    tcfg = _tcfg(jcfg)
    for i, bcfg in enumerate(jcfg.branches):
        key = f"branch_{bcfg.modality}"
        want = np.asarray(jax.jit(lambda qp, x: jfn(qp, x, bcfg))(
            quantized["jq"][key], jnp.asarray(quantized["vols"][i])))
        with torch.no_grad():
            got = TQ.BRANCH_INT8[kind](
                quantized["carried"].branches[key],
                torch.from_numpy(quantized["vols"][i]),
                tcfg.branches[i]).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= INT8_REL * np.abs(want).max()


def test_encode_int8_gating_and_cosine(quantized):
    """use_flag 0 equals a noise input exactly, and the int8 codes stay
    within cosine 0.99 of the float32 net's (per-sample L2)."""
    tcfg = _tcfg(quantized["jcfg"])
    vols = [torch.from_numpy(v) for v in _volumes(3, seed=1)]
    flags = [torch.ones(3), torch.ones(3)]
    off = [torch.ones(3), torch.zeros(3)]
    noise = [vols[0], torch.from_numpy(np.random.RandomState(2).randn(
        *vols[1].shape).astype(np.float32))]
    qnet = quantized["own"]
    with torch.no_grad():
        a = TQ.encode_int8(qnet, vols, off, tcfg)
        b = TQ.encode_int8(qnet, noise, off, tcfg)
        q = TQ.encode_int8(qnet, vols, flags, tcfg).numpy()
        fnet = quantized["tmodel"]
        cfg = dataclasses.replace(tcfg, l2_mode="feature")
        fnet.config, saved = cfg, fnet.config
        try:
            f = fnet(vols, flags, train=False)["flatten"].numpy()
        finally:
            fnet.config = saved
    assert torch.equal(a, b)
    cos = (q * f).sum(1) / (np.linalg.norm(q, axis=1)
                            * np.linalg.norm(f, axis=1))
    assert cos.min() >= COS_MIN, cos


@pytest.mark.parametrize("quantized", ["gaitset"], indirect=True)
def test_quantized_service_matches_jax(quantized):
    """The quantized SignatureService against the JAX one at the tiny
    flagship, both on JAX's int8 tree: gallery codes, identify labels and
    distances."""
    kw = dict(num_subjects=3, videos_per_subject=4, subseqs_per_video=2,
              num_cams=2, template_seed=0)
    jds, tds = j_synth(seed=1, **kw), make_synthetic_dataset(seed=1, **kw)
    probe = make_synthetic_dataset(seed=2, **kw)
    raw8 = {f"raw_{m}": tds.modalities[m].volumes[:8] for m in MODS}
    raw8.update({f"present_{m}": np.ones(8, np.float32) for m in MODS})
    raw8["labels"] = np.zeros(8, np.int32)
    vols, _, _ = preprocess_batch(raw8, MODS, (2, 1), (100.0, 1.0), 2, 1,
                                  False, tconfig.DataConfig(), device="cpu")
    vols = [v.numpy() for v in vols]
    jsvc = JService(quantized["jmodel"], quantized["params"], MODS, knn=3,
                    buckets=(8,), quantized=True,
                    calib_volumes=[jnp.asarray(v) for v in vols])
    tsvc = SignatureService(quantized["tmodel"], MODS, knn=3,
                            buckets=(8,), quantized=True,
                            calib_volumes=vols)
    tsvc._qnet.load_state_dict(quantized_flax_to_state_dict(
        _np(jsvc.params)))
    jsvc.build_gallery(jds, batch_size=8)
    tsvc.build_gallery(tds, batch_size=8)
    codes_j, codes_t = jsvc._host_codes, tsvc._host_codes
    assert np.abs(codes_t - codes_j).max() <= INT8_REL * np.abs(codes_j).max()
    raw = {f"raw_{m}": probe.modalities[m].volumes[:8] for m in MODS}
    want, wd = jsvc.identify_raw(raw)
    got, gd = tsvc.identify_raw(raw)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="typecode"):
        SignatureService(quantized["tmodel"], MODS, typecode=1,
                         quantized=True, calib_volumes=vols)
    with pytest.raises(ValueError, match="calib_volumes"):
        SignatureService(quantized["tmodel"], MODS, quantized=True)
