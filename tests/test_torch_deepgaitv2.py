"""DeepGaitV2-3D (``models/deepgaitv2.py``) against the plain reference
``portbench/reference/deepgaitv2.py`` on the CPU, at a small size: channels
(8, 16, 32, 64), blocks (1, 2, 2, 1), 8 frames of 28 x 38 (32 x 22 after
the pad and cut), batch 8, 5 classes, seeded weights.  Every forward tap,
both loss terms, every parameter's gradient, the running statistics after
a step and the eval forward agree; three planted faults (BatchNorm on its
running statistics while training, a shortcut left out, the cosine logits
without their scale) fail the same comparisons.  Then the guards of the
paths this branch shares or refuses, a checkpoint round trip and the
encode.

Tolerances (float32 on both sides), each the largest gap over the largest
magnitude of the tensor compared: the two sides compute the same
operations in other orders (the program runs its 2D stages channels-last,
its part matmuls as einsum; the reference as OpenGait lays them out), so
each value differs by float32 rounding accumulated over ~10 conv layers,
and a BatchNorm in train mode divides by a batch standard deviation that
can be small: FWD = 1e-4 of a tap's largest value, where the largest gap
seen is ~1e-5.  Gradients go back through the same layers: GRAD 1e-4 of a
leaf's largest entry.  The losses, the SGD update and the running
statistics: STEP 1e-5.  Each planted fault moves its numbers by 1e-2 or
more.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import model_config as bench_model_config
from portbench.reference import deepgaitv2 as R
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core.config import (DeepGaitV2Config, ModelConfig,
                                            TrainConfig)
from ugaitnet_tpu_torch.data.schema import GaitDataset, ModalityStore
from ugaitnet_tpu_torch.eval.encode import encode_dataset
from ugaitnet_tpu_torch.models import deepgaitv2 as DG
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv import spans
from ugaitnet_tpu_torch.ops.cuda import conv3d_dgrad as CD
from ugaitnet_tpu_torch.ops.cuda import conv3d_route
from ugaitnet_tpu_torch.train import train_step as TS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = GRAD = 1e-4
STEP = 1e-5
LABELS = torch.tensor([0, 0, 1, 1, 2, 2, 3, 4])
BRANCH = dict(kind="deepgaitv2", modality="silhouette",
              stage_channels=[8, 16, 32, 64], stage_blocks=[1, 2, 2, 1],
              hpp_bins=[16], part_dim=16, logit_scale=16.0)
MODEL = dict(branches=[BRANCH], nclasses=5, compute_dtype="float32")
TRAIN = dict(optimizer="sgd_opengait", lr=0.1, momentum=0.9,
             weight_decay=5e-4, margin=0.2, loss_weights=[1.0, 1.0],
             label_smoothing=0.1, triplet_kind="batch_all")


def mcfg(**kw):
    b = dict(BRANCH, **{k: v for k, v in kw.items() if k in BRANCH})
    m = {k: v for k, v in kw.items() if k not in BRANCH}
    return ModelConfig(branches=(DeepGaitV2Config(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in b.items()}),),
        **dict({k: v for k, v in MODEL.items() if k != "branches"}, **m))


def tcfg():
    """The program's TrainConfig; its SGD's weight decay is fixed
    (``SGD_WEIGHT_DECAY``), the reference takes TRAIN's."""
    assert TRAIN["weight_decay"] == TS.SGD_WEIGHT_DECAY
    return TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in TRAIN.items() if k != "weight_decay"})


def net(cfg=None, seed=0):
    """The program's model with every BatchNorm parameter and buffer moved
    off its initial value, so each takes part in the comparison."""
    model = UGaitNet(cfg or mcfg(), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            leaf = k.rsplit(".", 1)[-1]
            if leaf == "running_var":
                v.copy_(0.5 + torch.rand(v.shape, generator=g))
            elif leaf == "running_mean" or v.ndim == 1:
                v.add_(0.1 * torch.randn(v.shape, generator=g))
    return model


def clips(seed=0, n=8):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 8, 28, 38, 1, generator=g)


def weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def close(a, b, rel):
    """|a - b| within ``rel`` of b's largest magnitude, everywhere."""
    a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach()
    return bool((a - b).abs().max() <= rel * b.abs().max())


def hooked_taps(model, x, train, key=0):
    """The program's forward outputs and its stage outputs (hooks on the
    stem and on each stage's last block)."""
    branch = model.branches["branch_silhouette"]
    taps, handles = {}, []
    mods = {"stem": branch.stem}
    mods.update({f"stage{i}": getattr(branch, f"stage{i}")[-1]
                 for i in (1, 2, 3, 4)})
    for name, m in mods.items():
        handles.append(m.register_forward_hook(
            lambda mod, a, out, name=name: taps.__setitem__(name, out)))
    try:
        out = model([x], train=train, key=key)
    finally:
        for h in handles:
            h.remove()
    return out, taps


def forward_mismatches(model, x, train):
    """Names of the taps where the program and the reference differ."""
    W = weights(model)
    out, taps = hooked_taps(model, x, train)
    ref = R.forward(MODEL, W, x, train)
    bad = [k for k in taps if not close(taps[k], ref[k], FWD)]
    if not close(out["signature"], ref["embed"].transpose(1, 2), FWD):
        bad.append("embed")
    if not close(out["bnneck"], ref["feature"].transpose(1, 2), FWD):
        bad.append("feature")
    if not close(out["classprob_logits"],
                 BRANCH["logit_scale"] * ref["logits"].transpose(1, 2), FWD):
        bad.append("logits")
    return bad


def step_mismatches(model, x):
    """What differs after one program train step from the reference's:
    losses, gradients, parameters, running statistics."""
    W0 = weights(model)
    mc, tc = mcfg(), tcfg()
    state = TS.init_state(model, tc)
    _, metrics = TS.make_train_step(mc, tc)(
        state, TS.Batch((x,), (torch.ones(len(x)),), LABELS))
    Wr = {k: v.clone() for k, v in W0.items()}
    params = [k for k in Wr if not R.is_buffer(k)]
    for k in params:
        Wr[k].requires_grad_(True)
    total, tri, ce, _ = R.loss(MODEL, TRAIN, Wr, x, LABELS)
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 [Wr[k] for k in params])))
    bad = []
    for name, a, b in (("triplet", metrics["triplet"], tri),
                       ("id_ce", metrics["id_ce"], ce)):
        if not close(a, b, STEP):
            bad.append(name)
    named = dict(model.named_parameters())
    for k, g in grads.items():
        if not close(named[k].grad, g, GRAD):
            bad.append(f"grad:{k}")
    opt = R.SGD(TRAIN["lr"], TRAIN["momentum"], TRAIN["weight_decay"])
    opt.step({k: Wr[k].detach() for k in params}, grads)
    sd = model.state_dict()
    for k in params:
        if not close(sd[k], Wr[k], STEP):
            bad.append(f"param:{k}")
    for k in W0:
        if R.is_buffer(k) and not close(sd[k], Wr[k], STEP):
            bad.append(f"stats:{k}")
    return bad


# -------------------------------------------------------------- agreement

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_taps_match_the_reference(train):
    assert forward_mismatches(net(), clips(), train) == []


def test_a_step_matches_the_reference():
    """Both loss terms, every gradient, every parameter after the SGD
    step, every BatchNorm running statistic."""
    assert step_mismatches(net(), clips(1)) == []


def test_eval_forward_leaves_running_statistics():
    model = net()
    before = weights(model)
    model([clips(2)], train=False)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_remat_refused():
    """Remat's recompute would move the running statistics twice a step:
    a DeepGaitV2 model refuses it, the other branch kinds keep it."""
    with pytest.raises(ValueError, match="remat"):
        net(mcfg(remat=True))
    gaitset = ModelConfig(remat=True)
    assert UGaitNet(gaitset, device="cpu").config.remat


def test_bn_counter_and_spans():
    """25 BatchNorm layers at the published widths and blocks (1 + 2 + 9 +
    9 + 3 + 1); each layer counted once a train forward, none in eval; the
    spans of the stages, the pool and the head."""
    full = mcfg(stage_channels=[64, 128, 256, 512],
                stage_blocks=[1, 4, 4, 1])
    model = UGaitNet(full, device="cpu")
    assert sum(isinstance(m, DG.BatchNorm) for m in model.modules()) == 25
    model = net()
    from torch.profiler import ProfilerActivity, profile
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        model([clips()], train=True, key=7)
        model([clips()], train=False)
    snap = spans.snapshot()
    spans.clear()
    assert snap["counters"] == {"bn.batch_stats": 1 + 2 + 5 + 5 + 3 + 1}
    names = [s["name"] for s in snap["spans"] if s["id"] == 7]
    assert names == ["model.dgv2.stem", "model.dgv2.stage1",
                     "model.dgv2.stage2", "model.dgv2.stage3",
                     "model.dgv2.stage4", "model.dgv2.pool", "head.bnneck"]


# ---------------------------------------------------------- planted faults

def _bn_running_in_training(monkeypatch):
    real = DG.BatchNorm.forward
    monkeypatch.setattr(DG.BatchNorm, "forward",
                        lambda self, x, train: real(self, x, False))


def _shortcut_left_out(monkeypatch):
    real = DG.BasicBlock.forward

    def forward(self, x, train):
        if self is self._dropped:
            y = torch.relu(self.bn1(self.conv1(x), train))
            return torch.relu(self.bn2(self.conv2(y), train))
        return real(self, x, train)
    monkeypatch.setattr(DG.BasicBlock, "forward", forward)
    monkeypatch.setattr(DG.BasicBlock, "_dropped", None, raising=False)
    return lambda model: setattr(
        DG.BasicBlock, "_dropped",
        model.branches["branch_silhouette"].stage3[1])


def _logits_unscaled(monkeypatch):
    real = DG.BNNeck.forward

    def forward(self, sig, train, key=None):
        feat, logits = real(self, sig, train, key)
        return feat, logits / self.scale
    monkeypatch.setattr(DG.BNNeck, "forward", forward)


FAULTS = {"bn_running_in_training": _bn_running_in_training,
          "shortcut_left_out": _shortcut_left_out,
          "logits_unscaled": _logits_unscaled}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(monkeypatch, fault):
    """Each fault fails the forward comparison and the step's."""
    model = net()
    aim = FAULTS[fault](monkeypatch)
    if aim is not None:
        aim(model)
    assert forward_mismatches(model, clips(), True) != []
    assert step_mismatches(model, clips(1)) != []


# ------------------------------------------------------ shared-path guards

GOLDEN = {  # state_dict and module-tree digests at seed 0, before DeepGaitV2
    "gaitset_of_gray": (
        "2c58197ca464042cef818fe4ed0a3376ace0324dfdcd6d911ec60ae99ced43bc",
        "9ca276c5c06464fc57d8a34d0306e69cdec8cfe713ee96ad02549c59bafbb5f3"),
    "cnn3d_of_gray": (
        "4b38f2995ff8159aca9b4b756819470c07a8866c74396359db84268c81538e9a",
        "ec9a813e2ce2c727da9460cc4f49c43bdc4a786034702c091d824b1325dde552"),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_benchmark_configs_build_what_they_built(name):
    with open(os.path.join(REPO, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    model = UGaitNet(bench_model_config(cfg), device="cpu", seed=0)
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(f"{k}{tuple(v.shape)}{v.dtype}".encode())
        h.update(v.numpy().tobytes())
    mods = "\n".join(f"{n}:{type(m).__name__}"
                     for n, m in model.named_modules())
    assert (h.hexdigest(), hashlib.sha256(mods.encode()).hexdigest()) == \
        GOLDEN[name]


def test_hand_wgrad_takes_cnn3d_conv0_and_nothing_of_deepgaitv2(
        monkeypatch):
    """``Conv`` sends a conv to ``conv3d_route.conv3d`` where
    ``conv3d_route.hand_grads`` says so; with the shared rule read on CPU
    tensors (``conv3d_route.fits``) and the input gradient's rule off, as
    on the CPU, the 3D CNN's ``conv0`` of each branch goes there in
    float32 training, and no conv of DeepGaitV2 does, in float32 or bf16 (its convs are padded and
    bias-free, and its 1x1x1 shortcuts would otherwise fit)."""
    monkeypatch.setattr(conv3d_route, "engages", conv3d_route.fits)
    monkeypatch.setattr(CD, "fits", lambda x, w: False)
    taken = []
    real = conv3d_route.conv3d
    monkeypatch.setattr(conv3d_route, "conv3d", lambda x, w, b, s, hand: (
        taken.append(tuple(w.shape)), real(x, w, b, s, hand))[1])
    with open(os.path.join(REPO, "portbench", "configs",
                           "cnn3d_of_gray.json")) as f:
        cnn = UGaitNet(bench_model_config(json.load(f)), device="cpu")
    vols = [torch.randn(1, 25, 60, 60, c) for c in (2, 1)]
    cnn(vols, train=True, key=0)["signature"].sum().backward()
    assert taken == [(64, 2, 3, 5, 5), (64, 1, 3, 5, 5)]
    taken.clear()
    for dtype in ("float32", "bfloat16"):
        model = net(mcfg(compute_dtype=dtype))
        model([clips()], train=True, key=0)["signature"].sum().backward()
    assert taken == []


def test_refused_paths_raise():
    from ugaitnet_tpu_torch.ops.quantize import quantize_model_params
    from ugaitnet_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from ugaitnet_tpu_torch.parallel.tensor import place_tp_model

    class Mesh:
        def group(self, axis):
            return None

    cfg, model = mcfg(), net()
    for path, call in (
            ("sequence parallelism",
             lambda: UGaitNet(mcfg(seq_axis="seq"), device="cpu")),
            ("tensor parallelism", lambda: place_tp_model(model, Mesh())),
            ("pipeline parallelism", lambda: make_pipeline_train_step(
                model, None, cfg, tcfg(), ["cpu", "cpu"])),
            ("global data parallelism", lambda: TS.make_train_step(
                cfg, tcfg(), Mesh(), global_batch=True)),
            ("int8", lambda: quantize_model_params(model, cfg, [clips()]))):
        with pytest.raises(ValueError, match=path):
            call()
    # the per-shard form normalizes each rank's rows: not refused
    TS.make_train_step(cfg, tcfg(), Mesh(), global_batch=False)


def test_keras_export_refused(monkeypatch, tmp_path):
    from ugaitnet_tpu_torch.cli import evaluate, export_model
    model = net()
    monkeypatch.setattr(evaluate, "load_experiment",
                        lambda *a, **k: (model, None, mcfg(), 1))
    with pytest.raises(ValueError, match="Keras export"):
        export_model.main(["--experdir", str(tmp_path), "--out",
                           str(tmp_path / "art"), "--keras-h5",
                           str(tmp_path / "w.h5"), "--keras-template",
                           str(tmp_path / "t.h5"), "--device", "cpu"])


def test_deepgaitv2_is_a_model_of_its_own(tmp_path):
    """One branch and the BNNeck head (none without classes); a config
    file round trip rebuilds its ``DeepGaitV2Config``."""
    from ugaitnet_tpu_torch.core.config import (BranchConfig, dump_json,
                                                load_json)
    two = ModelConfig(branches=mcfg().branches + (BranchConfig(
        kind="gaitset", modality="gray"),))
    for cfg in (two, mcfg(aux_losses=True), mcfg(extra_dense=(32,))):
        with pytest.raises(ValueError, match="deepgaitv2"):
            UGaitNet(cfg, device="cpu")
    model = UGaitNet(mcfg(nclasses=0), device="cpu")
    assert model.bnneck is None and model.classprob is None
    dump_json(str(tmp_path / "c.json"), model=mcfg())
    assert load_json(str(tmp_path / "c.json"))["model"] == mcfg()


# ------------------------------------------------- checkpoint and encode

def test_checkpoint_restores_batchnorm_buffers_bitwise(tmp_path):
    model = net()
    state = TS.init_state(model, tcfg())
    TS.make_train_step(mcfg(), tcfg())(
        state, TS.Batch((clips(),), (torch.ones(8),), LABELS))
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    fresh = TS.init_state(UGaitNet(mcfg(), device="cpu", seed=5), tcfg())
    ckpt.restore_checkpoint(str(tmp_path), 1, fresh)
    want, got = model.state_dict(), fresh.model.state_dict()
    bufs = [k for k in want if R.is_buffer(k)]
    assert len(bufs) == 2 * 17
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_encode_runs_batchnorm_on_running_statistics():
    """``encode_dataset`` codes are the eval forward's signature (embed_1,
    flattened per clip), the reference's eval ``embed``, and leave the
    running statistics as they are."""
    model = net()
    raw = (torch.rand(12, 8, 28, 38, generator=torch.Generator()
                      .manual_seed(4)) < 0.3).to(torch.uint8) * 255
    n = len(raw)
    ds = GaitDataset(name="sil", modalities={"silhouette": ModalityStore(
        "silhouette", raw.numpy())}, labels=np.arange(n) // 3,
        video_ids=np.arange(n), gaits=np.zeros(n, np.int32),
        cams=np.zeros(n, np.int32), set_ids=np.ones(n, np.int32))
    before = weights(model)
    codes, labels, _, _ = encode_dataset(model, ds, ("silhouette",),
                                         typecode=3, batch_size=8)
    x = R.input_batch(raw, None, augmenting=False)
    ref = R.forward(MODEL, weights(model), x, False)["embed"]
    assert codes.shape == (n, 16 * 16)
    assert close(torch.from_numpy(codes),
                 ref.transpose(1, 2).reshape(n, -1), FWD)
    assert labels.tolist() == (np.arange(n) // 3).tolist()
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
