"""Closed-loop training of DeepGaitV2-3D: the step of
``train/train_step.py:make_train_step`` fed by ``GaitPipeline`` ->
``PrefetchLoader`` over ``BalancedGaitSampler``, as ``drivers/train.py``
runs the UGaitNet cells, on one silhouette modality (``traffic_sil.py``),
in bf16 with float32 parameters, SGD with momentum and weight decay.

Set-up builds the one step, model and optimizer that the window drives and
runs its first three steps through the window's own loader: the warm-up
and the steps the reference (``reference/deepgaitv2.py``) follows from the
same weights and BatchNorm buffers, on the same rows, whole batches
(BatchNorm statistics span the batch), after the program's memory is
freed.  Readings (``readings_of``): each step's loss; the first step's
gradients (``.grad`` after step 1) and BatchNorm buffer moves, by norm
and as whole tensors; each parameter's change after three steps; and
the sampler's design (``judge.py:sampler_faults``).  Two readings hold the
pieces after the backbone apart from its bf16 rounding: the program's own
loss functions (``losses_from_outputs``: the triplet kernel and the scaled,
smoothed cosine cross-entropy) on its first step's outputs, value and
gradients, against the reference's on the same tensors
(``loss_fn_readings``); and its SGD updates of the first two steps against
the reference's SGD applied to the program's own gradients
(``update_err``).  ``--readings 1`` adds the controls that set the limits,
each the reference in the program's place: conv and matmul operands in
fp8 e4m3, BatchNorm on its running statistics while training, the
shortcut of block ``stage3.1`` left out, half of each batch, the
cross-entropy without label smoothing, the triplet over the first
``TRIPLET_ROWS`` rows alone, SGD without weight decay, SGD without
momentum; and two witnesses of where the sound readings come from: the
program itself in float32 (TF32 off) on the same three batches
(``witness.fp32_program``), and the reference with every conv's operands
and output rounded to bf16 forward and backward (``witness.bf16``).

A traced run also reduces the device time of the kernels launched inside
each of the program's ``ugn.model.dgv2.*`` ranges, beside each range's
roofline time (``flops_dgv2.py:span_bounds``), for
``metrics/dgv2_fwd_roofline.train.py``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import time
from typing import Dict

import numpy as np
import torch

from portbench import flops, flops_dgv2, traffic, traffic_sil
from portbench.drivers.train import RecordingSampler
from portbench.harness import DEVICE_CATS, set_precision
from portbench.reference import data as RD
from portbench.reference import deepgaitv2 as R
from portbench.reference import judge as J

CHECKED_STEPS = 3
DIVERGENCE_CHECK_EVERY = 25
RANGE_PREFIX = "ugn.model.dgv2."
NO_SHORTCUT = "stage3.1"
# the triplet's rows in a planted fault: the UGaitNet cells' batch, short of
# this cell's 128 (half the batch in a smaller one)
TRIPLET_ROWS = 120


def make_weights(shapes: Dict[str, tuple], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for the program's state_dict shapes, drawn as
    one uniform vector u in [-1, 1) on the device: kernels Glorot-uniform
    (a conv's fans with its receptive field, a per-part matrix (P, I, O)
    fans P I and P O), BatchNorm weight 1 + u / 10 and bias u / 10,
    running mean 0 and variance 1."""
    sizes = [math.prod(s) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(traffic.mix(seed, 7))
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out, pos = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        v = u[pos:pos + n].reshape(shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            v = torch.zeros(shape, device=device)
        elif leaf == "running_var":
            v = torch.ones(shape, device=device)
        elif len(shape) == 1:
            v = 1.0 + v / 10 if leaf == "weight" else v / 10
        elif leaf == "fc_bin":
            p, i, o = shape
            v = v * math.sqrt(6.0 / (p * i + p * o))
        else:
            rf = math.prod(shape[2:])
            v = v * math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))
        out[name] = v
        pos += n
    return out


def model_config(cfg: Dict):
    """The program's ModelConfig for the configuration file's ``model``,
    its one branch a ``DeepGaitV2Config``."""
    from ugaitnet_tpu_torch.core.config import DeepGaitV2Config, ModelConfig
    (b,) = cfg["model"]["branches"]
    return ModelConfig(**dict(cfg["model"], branches=(DeepGaitV2Config(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in b.items()}),)))


def make_dataset(p: Dict, seed: int, device):
    from ugaitnet_tpu_torch.data.schema import GaitDataset, ModalityStore
    arr = traffic_sil.dataset_arrays(p, seed, device)
    mods = {"silhouette": ModalityStore("silhouette", arr["raw_silhouette"])}
    cols = {k: arr[k] for k in ("labels", "video_ids", "gaits", "cams",
                                "set_ids")}
    return GaitDataset(name=p["name"], modalities=mods, **cols), arr


def program_configs(cfg: Dict, p: Dict):
    from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
    t = cfg["train"]
    dcfg = DataConfig(batch_size=p["batch"], expand_level=p["expand"],
                      repetitions=p["repetitions"], augment=p["augment"])
    tcfg = TrainConfig(optimizer=t["optimizer"], lr=t["lr"],
                       momentum=t["momentum"], margin=t["margin"],
                       loss_weights=tuple(t["loss_weights"]),
                       label_smoothing=t["label_smoothing"],
                       triplet_kind=t["triplet_kind"])
    return dcfg, tcfg


def range_device_seconds(path: str, prefix: str) -> Dict[str, list]:
    """{range name: [calls, device seconds of the kernels launched inside
    it]} of the Chrome trace's ranges whose name starts with ``prefix``
    (launches matched to kernels by correlation id, as
    ``harness.reduce_trace`` matches them)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    by_corr = collections.defaultdict(float)
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and corr is not None:
            by_corr[corr] += e["dur"] / 1e6
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[e.get("tid")].append(
                (e["ts"], by_corr.get(e.get("args", {}).get("correlation"),
                                      0.0)))
    sums = {}
    for tid, rows in launches.items():
        rows.sort()
        sums[tid] = ([t for t, _ in rows], list(itertools.accumulate(
            (s for _, s in rows), initial=0.0)))
    out: Dict[str, list] = {}
    for r in events:
        name = str(r.get("name", ""))
        if r.get("cat") != "user_annotation" or not name.startswith(prefix):
            continue
        ts, acc = sums.get(r.get("tid"), ([], [0.0]))
        lo = bisect.bisect_left(ts, r["ts"])
        hi = bisect.bisect_right(ts, r["ts"] + r["dur"])
        calls, secs = out.get(name, [0, 0.0])
        out[name] = [calls + 1, secs + acc[hi] - acc[lo]]
    return out


def run(ctx) -> Dict:
    from ugaitnet_tpu_torch.data.pipeline import GaitPipeline, PrefetchLoader
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    cfg, p, dev, seed = ctx.cfg, ctx.cell["params"], ctx.device, ctx.seed
    mcfg = model_config(cfg)
    ds, arr = make_dataset(p, seed, dev)
    ctx.phase("data set")
    model = UGaitNet(mcfg, device=dev, seed=0)
    W0 = make_weights({k: tuple(v.shape)
                       for k, v in model.state_dict().items()}, seed, dev)
    model.load_state_dict(W0)
    ctx.phase("model")
    dcfg, tcfg = program_configs(cfg, p)
    state = init_state(model, tcfg)
    step = make_train_step(mcfg, tcfg)
    pipe = GaitPipeline(ds, dcfg, ("silhouette",), labmap=ds.label_map(),
                        device=dev)
    sampler = RecordingSampler(BalancedGaitSampler(
        ds.labels, ds.gaits, dcfg.batch_size, dcfg.repetitions,
        seed=seed % 2 ** 32))
    epoch = 0
    batches = iter(PrefetchLoader(pipe, sampler, seed, epoch))

    def next_batch():
        nonlocal batches, epoch
        try:
            return next(batches)
        except StopIteration:
            epoch += 1
            batches = iter(PrefetchLoader(pipe, sampler, seed, epoch))
            return next(batches)

    def train_step(vols, flags, labels):
        nonlocal state
        state, m = step(state, Batch(tuple(vols), tuple(flags), labels))
        return m

    # set-up: the checked steps, which are the warm-up too
    kept = [next_batch() for _ in range(CHECKED_STEPS)]
    prog = checked_steps(model, W0, train_step, kept)
    vols, flags, labels = kept[0]
    prog["loss_fn"] = program_loss_functions(
        prog.pop("out1"), model, Batch(tuple(vols), tuple(flags), labels),
        mcfg, tcfg)
    if not ctx.readings:
        kept = None
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # the window
    spans, tracer = ctx.spans, ctx.tracer
    ctx.mark_setup_done()
    steps, t0 = 0, time.perf_counter()
    while True:
        with spans("input_wait"):
            vols, flags, labels = next_batch()
        with spans("step"):
            m = train_step(vols, flags, labels)
        steps += 1
        if steps % DIVERGENCE_CHECK_EVERY == 0 and not np.isfinite(
                float(m["loss"])):
            raise FloatingPointError(f"non-finite loss at step {steps}")
        elapsed = time.perf_counter() - t0
        tracer.unit_done(elapsed)
        if elapsed >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    batches.close()
    ctx.read_memory_peak()
    ranges = {}
    if ctx.trace:
        tracer.finish()
        if os.path.exists(tracer.path):
            ranges = range_device_seconds(tracer.path, RANGE_PREFIX)
    del state, model, step, pipe, batches, m, vols, flags, labels
    free(dev)
    set_precision(False)
    prog32 = None
    if ctx.readings:
        prog32 = program_float32(mcfg, tcfg, W0, kept, dev)
        del kept
        free(dev)

    # the reference follows the checked steps from the same weights
    ref_batches = reference_batches(arr, sampler.epochs[0][:CHECKED_STEPS],
                                    p, seed, dev)
    mc, tc = cfg["model"], cfg["train"]
    ref = R.follow(mc, tc, W0, ref_batches)
    labels1 = ref_batches[0][1]
    ref["loss_fn"] = reference_loss_functions(prog["loss_fn"], labels1, tc)
    ref["W0"] = {k: W0[k].cpu() for k in prog["grads1"]}
    ref["train_cfg"] = tc
    readings = readings_of(prog, ref)
    readings["sampler_faults"] = J.sampler_faults(
        sampler.epochs, arr["labels"], arr["gaits"], p["batch"],
        p["repetitions"])
    extra = {}
    if ctx.readings:
        half = [(x[: x.shape[0] // 2], y[: y.shape[0] // 2])
                for x, y in ref_batches]
        for name, batches_, controls in (
                ("control.fp8", ref_batches, {"q": R.fp8_operand}),
                ("control.bn_running", ref_batches, {"bn_running": True}),
                ("control.no_shortcut", ref_batches,
                 {"no_shortcut": NO_SHORTCUT}),
                ("control.half_batch", half, {}),
                ("witness.bf16", ref_batches,
                 {"q": R.bf16_value, "q_out": R.bf16_value})):
            extra[name] = readings_of(R.follow(mc, tc, W0, batches_,
                                               **controls), ref)
        # a fault of the loss functions: in the whole follow, and in the
        # loss functions on the program's outputs
        rows = TRIPLET_ROWS if p["batch"] > TRIPLET_ROWS else p["batch"] // 2
        for name, tc_, rows_ in (
                ("control.no_smoothing", dict(tc, label_smoothing=0.0), None),
                ("control.triplet_rows", tc, rows)):
            got = R.follow(mc, tc_, W0, ref_batches, triplet_rows=rows_)
            got["loss_fn"] = reference_loss_functions(prog["loss_fn"],
                                                      labels1, tc_, rows_)
            extra[name] = readings_of(got, ref)
        for name, tc_ in (("control.sgd_no_decay",
                           dict(tc, weight_decay=0.0)),
                          ("control.sgd_no_momentum",
                           dict(tc, momentum=0.0))):
            extra[name] = readings_of(dict(prog, update=sgd_path(
                ref["W0"], prog, tc_)), ref)
        extra["control.frozen"] = readings_of(dict(
            prog, change=dict.fromkeys(prog["change"], 0.0),
            moves1={k: torch.zeros_like(v)
                    for k, v in prog["moves1"].items()}), ref)
        extra["witness.fp32_program"] = readings_of(prog32, ref)
    bounds = flops_dgv2.span_bounds(mc, p["batch"], 2,
                                    flops.PEAKS["bfloat16"])
    return {
        "metrics": {"train_clips_per_s": steps * p["batch"] / window},
        "attempted": steps, "failed": 0,
        "readings": readings, "extra": extra,
        "record": {"kind": "train", "steps": steps, "window_s": window,
                   "flops": steps * p["batch"]
                   * flops_dgv2.train_flops_per_row(mc),
                   "peak_flops": flops.PEAKS["bfloat16"],
                   "dgv2_ranges": ranges,
                   "dgv2_bounds": {"ugn." + k: v for k, v in bounds.items()
                                   if k.startswith("model.dgv2.")},
                   "program_losses": prog["losses"],
                   "reference_losses": ref["losses"]},
    }


def checked_steps(model, W0: Dict[str, torch.Tensor], train_step,
                  batches) -> Dict:
    """The program's readings over ``batches`` from W0: each step's loss;
    the first step's outputs ("out1": the signature and the scaled logits)
    and BatchNorm buffer moves; the gradients ("grads1", "grads2") and the
    parameters after them ("params1", "params2") of the first two steps,
    on the host; the first gradients' norms; each parameter's change after
    the last step."""
    params = dict(model.named_parameters())
    prog = {"losses": []}

    def keep(mod, args, out):
        prog["out1"] = {k: out[k].detach().clone()
                        for k in ("signature", "classprob_logits")}
    hook = model.register_forward_hook(keep)
    for i, b in enumerate(batches):
        prog["losses"].append(train_step(*b)["loss"])
        hook.remove()
        if i < 2:
            prog[f"grads{i + 1}"] = {k: q.grad.to("cpu", copy=True)
                                     for k, q in params.items()}
            prog[f"params{i + 1}"] = {k: q.detach().to("cpu", copy=True)
                                      for k, q in params.items()}
        if i == 0:
            prog["grad_norms"] = {k: float(q.grad.norm())
                                  for k, q in params.items()}
            prog["moves1"] = R.moves(model.state_dict(), W0)
    prog["change"] = R.changes(model.state_dict(), W0)
    prog["losses"] = [float(x) for x in prog["losses"]]
    return prog


def program_loss_functions(out1: Dict[str, torch.Tensor], model, batch,
                           mcfg, tcfg) -> Dict:
    """The program's loss assembly (``train_step.losses_from_outputs``, as
    its step calls it) on the first step's outputs, made leaves: the
    total, and its gradients by the signature and by the scaled logits,
    each from its own loss term; the outputs themselves ride along."""
    from ugaitnet_tpu_torch.train.train_step import losses_from_outputs
    sig = out1["signature"].clone().requires_grad_(True)
    logits = out1["classprob_logits"].clone().requires_grad_(True)
    out = {"signature": sig, "classprob_logits": logits,
           "classprob": torch.softmax(logits.detach(), dim=-1),
           "bnneck": None}
    total = losses_from_outputs(out, model, batch, mcfg, tcfg)[0]
    g_sig, g_logits = torch.autograd.grad(total, [sig, logits])
    return {"outputs": out1, "loss": float(total.detach()),
            "grad_signature": g_sig,
            "grad_logits": g_logits}


def reference_loss_functions(prog_lf: Dict, labels: torch.Tensor,
                             train_cfg: Dict, triplet_rows=None) -> Dict:
    """The reference's two loss terms (``R.triplet``, ``R.cross_entropy``)
    on the program's first-step outputs: the signature (B, P, D) as
    OpenGait's [n, d, p], the scaled logits (B, P, classes) at scale 1;
    ``triplet_rows`` as in ``R.loss``."""
    sig = prog_lf["outputs"]["signature"].clone().requires_grad_(True)
    logits = prog_lf["outputs"]["classprob_logits"].clone().requires_grad_(
        True)
    n = triplet_rows or labels.shape[0]
    wt, wid = train_cfg["loss_weights"]
    total = (wt * R.triplet(sig.permute(0, 2, 1)[:n], labels[:n],
                            train_cfg["margin"])
             + wid * R.cross_entropy(logits.permute(0, 2, 1), labels, 1.0,
                                     train_cfg["label_smoothing"]))
    g_sig, g_logits = torch.autograd.grad(total, [sig, logits])
    return {"loss": float(total.detach()), "grad_signature": g_sig,
            "grad_logits": g_logits}


def loss_fn_readings(prog_lf: Dict, ref_lf: Dict) -> Dict[str, float]:
    """``loss_fn_gap``: the relative gap of the loss functions' totals;
    ``loss_fn_grad_err``: the worse of their gradients' relative errors,
    by the signature (the triplet's) and by the logits (the
    cross-entropy's)."""
    def err(k):
        r = ref_lf[k]
        return float((prog_lf[k] - r).norm() / r.norm().clamp_min(1e-30))
    return {"loss_fn_gap": abs(prog_lf["loss"] - ref_lf["loss"])
            / max(abs(ref_lf["loss"]), 1e-30),
            "loss_fn_grad_err": max(err("grad_signature"),
                                    err("grad_logits"))}


def sgd_path(W0: Dict[str, torch.Tensor], prog: Dict, train_cfg: Dict
             ) -> list:
    """The parameters after each of the first two steps of the reference's
    SGD (``R.SGD``, ``train_cfg``'s lr, momentum and weight decay) fed the
    program's own gradients of those steps, from W0 (on the host)."""
    opt = R.SGD(train_cfg["lr"], train_cfg["momentum"],
                train_cfg["weight_decay"])
    W = {k: W0[k].clone() for k in prog["grads1"]}
    path = []
    for g in (prog["grads1"], prog["grads2"]):
        opt.step(W, g)
        path.append({k: v.clone() for k, v in W.items()})
    return path


def update_err(mine: list, want: list, W0: Dict[str, torch.Tensor]
               ) -> float:
    """The worst parameter's ‖Δp − Δp_ref‖ / ‖Δp_ref‖ over the first two
    steps, Δ from W0 (on the host)."""
    worst = 0.0
    for got, ref in zip(mine, want):
        for k, w in ref.items():
            d = (w - W0[k]).norm().clamp_min(1e-30)
            worst = max(worst, float((got[k] - w).norm() / d))
    return worst


def program_float32(mcfg, tcfg, W0: Dict[str, torch.Tensor], batches,
                    device) -> Dict:
    """``checked_steps`` of the program built in float32 (the caller has
    TF32 off), from W0, over the batches the bf16 program took."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    mcfg = dataclasses.replace(mcfg, compute_dtype="float32")
    model = UGaitNet(mcfg, device=device, seed=0)
    model.load_state_dict(W0)
    state, step = init_state(model, tcfg), make_train_step(mcfg, tcfg)

    def train_step(vols, flags, labels):
        nonlocal state
        state, m = step(state, Batch(tuple(vols), tuple(flags), labels))
        return m
    return checked_steps(model, W0, train_step, batches)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def vector_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                leaves) -> Dict[str, float]:
    """{leaf: ‖prog − ref‖ over the larger of ‖ref‖ and the median leaf's
    ‖ref‖}, of whole tensors (a half batch or a left-out path turns a
    gradient more than it scales its norm)."""
    norms = {k: float(ref[k].norm()) for k in leaves}
    med = statistics.median(norms.values())
    return {k: float((prog[k] - ref[k]).norm()) / max(norms[k], med, 1e-30)
            for k in leaves}


def readings_of(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``judge.train_readings`` (losses, gradient norms and changes by
    norm), and of the first step, from the same weights and rows, by whole
    tensors: ``stats1_err``, the worst BatchNorm buffer's move
    (``vector_gaps``); ``grad_err_median``, the median parameter's gradient
    (leaves whose reference gradient is not nought,
    ``judge.moved_leaves``); ``grad_err_total``, ‖g − g_ref‖ / ‖g_ref‖
    over every parameter at once; where both sides have them,
    ``loss_fn_readings``; where the program's side has its parameters
    after two steps, ``update_err``: those parameters (or a control's SGD
    path, ``prog["update"]``) against ``sgd_path`` fed the same side's
    gradients."""
    out = J.train_readings(prog, ref)
    out["stats1_err"] = max(vector_gaps(prog["moves1"], ref["moves1"],
                                        list(ref["moves1"])).values())
    out["grad_err_median"] = statistics.median(vector_gaps(
        prog["grads1"], ref["grads1"],
        J.moved_leaves(ref["grad_norms"])).values())
    if "loss_fn" in prog and "loss_fn" in ref:
        out.update(loss_fn_readings(prog["loss_fn"], ref["loss_fn"]))
    if "params2" in prog:
        mine = prog.get("update") or [prog["params1"], prog["params2"]]
        out["update_err"] = update_err(
            mine, sgd_path(ref["W0"], prog, ref["train_cfg"]), ref["W0"])
    g, r = prog["grads1"], ref["grads1"]
    out["grad_err_total"] = math.sqrt(
        sum(float((g[k] - r[k]).square().sum()) for k in r)
        / sum(float(r[k].square().sum()) for k in r))
    return out


def reference_batches(arr: Dict, index_batches, p: Dict, seed: int,
                      device) -> list:
    """The checked steps' (x, labels) through the reference input path:
    the rows the sampler picked, from the benchmark's own arrays."""
    ulabels = np.unique(arr["labels"])
    out = []
    for i, idx in enumerate(index_batches):
        raw = torch.from_numpy(arr["raw_silhouette"][idx]).to(device)
        labels = torch.from_numpy(np.searchsorted(
            ulabels, arr["labels"][idx])).to(device)
        out.append((R.input_batch(raw, RD.batch_generator(seed, 0, i),
                                  p["augment"]), labels))
    return out
