"""Closed-loop training: the step of ``train/train_step.py:make_train_step``
fed by ``GaitPipeline`` -> ``PrefetchLoader`` over ``BalancedGaitSampler``,
as ``Trainer._epoch`` runs them, for ``--seconds``.

Set-up builds the one step, model and optimizer that the window drives and
runs its first three steps through the window's own loader; those are the
warm-up and the steps the reference follows: each step's loss, the first
gradient per leaf (from Adam's first moment after one step, m = 0.1 g) and
each leaf's change after three steps.  The reference takes those steps'
rows from the program's sampler, so every batch the sampler drew in the
run is held to the sampler's documented P x K design by itself
(``reference/judge.py:sampler_faults``).  ``train_clips_per_s`` counts the
data set's clips the window's steps consumed (``batch`` a step, before the
modality-dropout expansion) over the window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, traffic
from portbench.harness import build_model, model_config, set_precision
from portbench.reference import data as RD
from portbench.reference import judge as J
from portbench.reference import train as RT

CHECKED_STEPS = 3
DIVERGENCE_CHECK_EVERY = 25          # as Trainer._epoch reads the loss


class RecordingSampler:
    """The program's sampler, with every batch's indices kept, by epoch."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.epochs: List[List[np.ndarray]] = []

    def __len__(self):
        return len(self.sampler)

    def epoch(self):
        kept: List[np.ndarray] = []
        self.epochs.append(kept)
        for idx in self.sampler.epoch():
            kept.append(np.array(idx))
            yield idx


def make_dataset(p: Dict, seed: int, device):
    from ugaitnet_tpu_torch.data.schema import GaitDataset, ModalityStore
    arr = traffic.dataset_arrays(p, seed, device)
    mods = {m: ModalityStore(m, arr[f"raw_{m}"],
                             compress_factor=100.0 if m == "of" else 1.0)
            for m in p["modalities"]}
    cols = {k: arr[k] for k in ("labels", "video_ids", "gaits", "cams",
                                "set_ids")}
    return GaitDataset(name=p["name"], modalities=mods, **cols), arr


def program_configs(cfg: Dict, p: Dict):
    from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
    t = cfg["train"]
    dcfg = DataConfig(batch_size=p["batch"], expand_level=p["expand"],
                      repetitions=p["repetitions"], augment=p["augment"])
    tcfg = TrainConfig(optimizer=t["optimizer"], lr=t["lr"],
                       margin=t["margin"],
                       loss_weights=tuple(t["loss_weights"]),
                       triplet_kind=t["triplet_kind"])
    return dcfg, tcfg


def run(ctx) -> Dict:
    from ugaitnet_tpu_torch.data.pipeline import GaitPipeline, PrefetchLoader
    from ugaitnet_tpu_torch.data.sampler import BalancedGaitSampler
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    cfg, p, dev, seed = ctx.cfg, ctx.cell["params"], ctx.device, ctx.seed
    mcfg = model_config(cfg, ctx.cell.get("overrides"))
    ds, arr = make_dataset(p, seed, dev)
    ctx.phase("data set")
    model, W0 = build_model(mcfg, seed, dev)
    ctx.phase("model")
    dcfg, tcfg = program_configs(cfg, p)
    state = init_state(model, tcfg)
    step = make_train_step(mcfg, tcfg)
    mods = tuple(b.modality for b in mcfg.branches)
    pipe = GaitPipeline(ds, dcfg, mods, labmap=ds.label_map(), device=dev)
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
    names = {id(q): k for k, q in model.named_parameters()}
    prog = {"losses": []}
    for i in range(CHECKED_STEPS):
        prog["losses"].append(train_step(*next_batch())["loss"])
        if i == 0:
            prog["grad_norms"] = {
                names[id(q)]: float(s["exp_avg"].norm()) / 0.1
                for q, s in state.optimizer.state.items()}
    prog["change"] = {k: float((q.detach() - W0[k]).norm())
                      for k, q in model.named_parameters()}
    prog["losses"] = [float(x) for x in prog["losses"]]
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
    del state, model, step, pipe, batches, m, vols, flags, labels
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the checked steps from the same weights
    set_precision(False)
    ref_batches = reference_batches(arr, sampler.epochs[0][:CHECKED_STEPS],
                                    p, mods, seed, dev)
    ref = RT.follow(cfg["model"], cfg["train"], W0, ref_batches)
    readings = J.train_readings(prog, ref)
    readings["sampler_faults"] = J.sampler_faults(
        sampler.epochs, arr["labels"], arr["gaits"], p["batch"],
        p["repetitions"])
    extra = {}
    if ctx.readings:
        half = [tuple(x[: x.shape[0] // 2] if torch.is_tensor(x)
                      else [v[: v.shape[0] // 2] for v in x]
                      for x in b) for b in ref_batches]
        extra["fault.half_batch"] = J.train_readings(
            RT.follow(cfg["model"], cfg["train"], W0, half), ref)
        extra["fault.frozen"] = J.train_readings(
            dict(prog, change={k: 0.0 for k in prog["change"]}), ref)
    rows = p["batch"] * p["expand"]
    return {
        "metrics": {"train_clips_per_s": steps * p["batch"] / window},
        "attempted": steps, "failed": 0,
        "readings": readings, "extra": extra,
        "record": {"kind": "train", "steps": steps, "window_s": window,
                   "flops": steps * rows * flops.train_flops_per_row(
                       cfg["model"]),
                   "peak_flops": flops.PEAKS[
                       "tf32" if ctx.tf32 else "float32"],
                   "program_losses": prog["losses"],
                   "reference_losses": ref["losses"]},
    }


def reference_batches(arr: Dict, index_batches, p: Dict, mods, seed: int,
                      device) -> list:
    """The checked steps' batches through the reference input path: the
    rows the sampler picked, from the benchmark's own arrays."""
    ulabels = np.unique(arr["labels"])
    out = []
    for i, idx in enumerate(index_batches):
        raw = {f"raw_{m}": torch.from_numpy(arr[f"raw_{m}"][idx]).to(device)
               for m in mods}
        raw.update({f"present_{m}": torch.ones(len(idx), device=device)
                    for m in mods})
        raw["labels"] = torch.from_numpy(np.searchsorted(
            ulabels, arr["labels"][idx])).to(device)
        out.append(RD.preprocess(raw, mods, RD.batch_generator(seed, 0, i),
                                 p["augment"], p["expand"]))
    return out
