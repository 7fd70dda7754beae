"""Run ``chip_smoke.py``'s phase 13 alone on one CUDA card, with what it
needs from the phases before it made here: phase 12's global batch (phase
3's first augmented batch, B = 120), phase 5's CASIA-B-shaped sets saved
packed, a seed-0 flagship saved as a 'best' checkpoint, and the one-process
evaluate of it that phase 13's ``evaluate --dp 2`` is held to.

    python3 tools/chip_phase13.py

Exits non-zero if a check of phase 13 fails; prints its results as one
JSON line before the total time.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_phase13: no CUDA device")
    from ugaitnet_tpu_torch.cli import evaluate as cli_eval
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.core.config import (DataConfig, TrainConfig,
                                                dump_json)
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.cuda import build
    from ugaitnet_tpu_torch.train.train_step import init_state
    t0 = time.perf_counter()
    build.load("triplet_kernel")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C._p12_setup()
    sets = tempfile.mkdtemp(prefix="chip_phase13_")
    work = os.path.join(sets, "parallel")
    os.makedirs(work)
    vols, flags, labels = preprocess_batch(
        C.raw_batch(40, 8, seed=2), C.MODS, (2, 1), (100.0, 1.0), 2, 3,
        True, DataConfig(), generator=torch.Generator().manual_seed(0))
    torch.save({"volumes": [v.cpu() for v in vols],
                "flags": [f.cpu() for f in flags], "labels": labels.cpu()},
               os.path.join(work, "batch.pt"))
    del vols, flags, labels
    gallery, probes = C.casia_sets()
    gdir, pdir = os.path.join(sets, "gallery"), os.path.join(sets, "probe")
    gallery.save(gdir)
    probes.save(pdir)
    del gallery, probes
    exp = os.path.join(sets, "exp")
    os.makedirs(exp)
    mcfg = C.flagship_cfg()
    dump_json(os.path.join(exp, "config.json"), model=mcfg,
              data=DataConfig(), train=TrainConfig())
    ckpt.save_checkpoint(exp, "best", init_state(UGaitNet(mcfg, seed=0),
                                                 TrainConfig()))
    outfile = os.path.join(sets, "one_process.json")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_eval.main(["--experdir", exp, "--epoch", "best", "--gallery",
                       gdir, "--probes", pdir, "--protocol", "casiab",
                       "--knn", "3", "--bs", "128", "--outfile", outfile])
    with open(outfile) as f:
        one = json.load(f)[os.path.basename(pdir)]
    torch.cuda.empty_cache()
    print(f"inputs made in {time.perf_counter() - t0:.1f} s", flush=True)
    res = C.tp_pp_phase(card, work, exp, gdir, pdir, one)
    print(json.dumps(res))
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
