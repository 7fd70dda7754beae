"""Closed-loop encode: whole passes of ``eval/encode.py:encode_dataset``
over the data set, for ``--seconds`` (the last pass ends the window).

Each pass keeps one of its batches, drawn from the seed, and the reference
encodes those batches after the window: the same clips, the same batch of
``batch`` rows (the last one padded with absent rows), the batch-axis L2 of
the signature over it.  The program's codes are held, row by row, to the
reference's merged codes, the nearer branch where the two lie within
``tie`` of each other (``reference/judge.py:merged_error``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from portbench import flops
from portbench.drivers.train import make_dataset
from portbench.harness import (build_model, conv_ranges, model_config,
                               set_precision)
from portbench.reference import data as RD
from portbench.reference import judge as J
from portbench.reference import model as RM
from portbench.traffic import mix


def run(ctx) -> Dict:
    from ugaitnet_tpu_torch.eval.encode import encode_dataset
    cfg, p, dev, seed = ctx.cfg, ctx.cell["params"], ctx.device, ctx.seed
    mcfg = model_config(cfg, ctx.cell.get("overrides"))
    ds, arr = make_dataset(p, seed, dev)
    ctx.phase("data set")
    model, W = build_model(mcfg, seed, dev)
    ctx.phase("model")
    mods = tuple(b.modality for b in mcfg.branches)
    bs, n = p["batch"], len(ds)
    nbatches = -(-n // bs)

    def encode(indices=None):
        return encode_dataset(model, ds, mods, typecode=p["typecode"],
                              batch_size=bs, indices=indices)[0]

    encode(np.arange(min(n, 2 * bs)))        # warm-up: the pass's shapes
    spans, tracer = ctx.spans, ctx.tracer
    kept = []
    rng = np.random.default_rng(mix(seed, 8))
    ctx.mark_setup_done()
    passes, t0 = 0, time.perf_counter()
    with conv_ranges(model, ctx.trace):
        while True:
            with spans("encode_pass"):
                codes = encode()
            b = int(rng.integers(nbatches))
            kept.append((b, codes[b * bs:(b + 1) * bs].copy()))
            passes += 1
            elapsed = time.perf_counter() - t0
            tracer.unit_done(elapsed)
            if elapsed >= ctx.seconds:
                break
    window = time.perf_counter() - t0
    ctx.read_memory_peak()
    del model, codes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    set_precision(False)
    ref = {}
    for b in sorted({b for b, _ in kept}):
        ref[b] = reference_batch(cfg["model"], W, arr, mods, b, bs, n, dev,
                                 RM.identity)
    if ctx.control == "fp8":
        # the control: the reference in fp8 in the program's place
        fp8 = {}
        for b in ref:
            a, bb, scale = reference_batch(cfg["model"], W, arr, mods, b,
                                           bs, n, dev, RM.fp8_round)
            fp8[b] = RM.merge(cfg["model"]["merge"], a, bb) * scale
        kept = [(b, fp8[b]) for b, _ in kept]
    else:
        kept = [(b, torch.from_numpy(c).to(dev)) for b, c in kept]
    tie = ctx.cell["limits"]["tie"]
    err = max(float(J.merged_error(c, *ref[b], tie).max()) for b, c in kept)
    dtype = mcfg.compute_dtype
    peak = flops.PEAKS[dtype]
    conv = flops.conv3x3_layers(cfg["model"], bs,
                                2 if dtype == "bfloat16" else 4)
    return {
        "metrics": {"encode_clips_per_s": passes * n / window},
        "attempted": passes * n, "failed": 0,
        "readings": {"code_err": err}, "extra": {},
        "record": {"kind": "encode", "passes": passes, "window_s": window,
                   "flops": passes * n * flops.forward_flops_per_clip(
                       cfg["model"]),
                   "peak_flops": peak,
                   "conv3x3": {k: flops.roofline_seconds(o, by, peak)
                               for k, (o, by) in conv.items()},
                   "batches_per_pass": nbatches},
    }


def reference_batch(model_cfg: Dict, W, arr: Dict, mods, b: int, bs: int,
                    n: int, device, q):
    """Batch ``b`` of a pass through the reference: the branch embeddings
    (a, b) and the signature's L2 factor, the batch padded to ``bs`` rows
    with absent ones as the encode pads it."""
    idx = np.arange(b * bs, min((b + 1) * bs, n))
    real = len(idx)
    idx = np.concatenate([idx, np.full(bs - real, idx[-1])])
    valid = torch.zeros(bs, device=device)
    valid[:real] = 1.0
    raw = {f"raw_{m}": torch.from_numpy(arr[f"raw_{m}"][idx]).to(device)
           for m in mods}
    raw.update({f"present_{m}": valid for m in mods})
    raw["labels"] = torch.zeros(bs, device=device)
    vols, flags, _ = RD.preprocess(raw, mods, None, False, 1)
    with torch.no_grad():
        a, bb = RM.branches(model_cfg, W, vols, flags, q)
        scale = RM.l2_scale(RM.merge(model_cfg["merge"], a, bb),
                            model_cfg["l2_mode"])
    return a[:real], bb[:real], scale
