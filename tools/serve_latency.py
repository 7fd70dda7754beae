"""Time ``SignatureService.identify_raw`` per query bucket on one CUDA card,
for the port in this checkout or in another checkout of the repository,
and profile one bucket-1 call.

    python3 tools/serve_latency.py [--root DIR]

--root: the checkout whose ``ugaitnet_tpu_torch`` is timed (default: the
one holding this script), so two versions can be compared on one card in
one session: run old, new, new, old.

Builds the flagship at full width (two GaitSet branches, sign_max, 74
classes, float32, TF32 off) with weights from seed 0, a 2,200-code random
unit-norm gallery, and random raw int16 OF / uint8 gray query volumes on
the host.  Prints the card (nvidia-smi name and power limit) and one JSON
line: the root, the median host-clock ms of ``identify_raw`` per bucket
over ITERS calls after a warm-up, and the profile of one bucket-1 call
(device busy ms under torch.profiler, its wall ms, and the host ops with
the most self CPU time).  Exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BUCKETS = (1, 8, 32, 128)
GALLERY = 2200
ITERS = 20


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_latency: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
    from ugaitnet_tpu_torch.eval.serving import SignatureService
    from ugaitnet_tpu_torch.models.network import UGaitNet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    cfg = ModelConfig(branches=(BranchConfig(kind="gaitset", modality="of"),
                                BranchConfig(kind="gaitset", modality="gray")),
                      merge="sign_max", nclasses=74)
    svc = SignatureService(UGaitNet(cfg, seed=0), ("of", "gray"), knn=3,
                           buckets=BUCKETS)
    rng = np.random.RandomState(0)
    codes = rng.randn(GALLERY, 62 * 256).astype(np.float32)
    codes /= np.linalg.norm(codes, axis=1, keepdims=True)
    svc.set_gallery(codes, np.arange(GALLERY) % 50)
    svc.warmup()
    feeds = {b: {"raw_of": rng.randint(-3000, 3000, (b, 50, 60, 60)
                                       ).astype(np.int16),
                 "raw_gray": rng.randint(0, 255, (b, 25, 60, 60)
                                         ).astype(np.uint8)}
             for b in BUCKETS}

    ms = {}
    for b in BUCKETS:
        svc.identify_raw(feeds[b])
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            labels, _ = svc.identify_raw(feeds[b])
            times.append((time.perf_counter() - t0) * 1e3)
        if len(labels) != b:
            sys.exit(f"serve_latency: {len(labels)} labels for {b} queries")
        ms[b] = float(np.median(times))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.identify_raw(feeds[1])
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    top = [(a.key, a.count, round(a.self_cpu_time_total / 1e3, 4))
           for a in host[:8]]
    print(json.dumps({"root": root, "card": card,
                      "identify_raw_ms_median": ms, "iters": ITERS,
                      "bucket1_profile": {"wall_ms": wall,
                                          "device_busy_ms": busy,
                                          "top_self_cpu_ms": top}}))


if __name__ == "__main__":
    main()
