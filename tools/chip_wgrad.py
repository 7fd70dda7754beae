"""The 3D CNN's weight gradients on the card: which layer runs in which
kernel.

    python3 tools/chip_wgrad.py [--seed N] [--seconds S] [--out FILE]

Runs the ``cnn3d.train`` cell (``portbench/run.py``'s ``execute``,
untraced) with four of its window's steps under ``torch.profiler`` with
``record_shapes``: every kernel launched inside a convolution op (or the
hand path's ``_Conv3dBackward``), summed by (op, input shapes, kernel), so
each layer's forward, input gradient and weight gradient are named with
their kernels; and the shapes and strides the hand kernel was handed.
Prints one JSON line; ``--out`` writes it too.  The hand kernel alone,
against float64 and beside cuDNN's weight gradient at the cell's shapes,
is ``chip_smoke.py`` phase 1e.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "portbench", "tests")]

import torch  # noqa: E402

PROFILED = range(6, 10)         # the window's steps under the profiler


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return {"card": torch.cuda.get_device_name(0),
            "nvidia_smi": q.stdout.strip()}


def attribute(seed: int, seconds: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from conftest import load
    from portbench import run
    from ugaitnet_tpu_torch.train import train_step as TS

    made = TS.make_train_step
    profs = []

    def make(*a, **k):
        step = made(*a, **k)
        calls = [0]

        def profiled(state, batch):
            calls[0] += 1
            # the three checked steps come first, then the window
            if calls[0] - 3 not in PROFILED:
                return step(state, batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=True) as p:
                out = step(state, batch)
                torch.cuda.synchronize()
            profs.append(p)
            return out
        return profiled

    from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW
    wgrad = CW.conv3d_wgrad
    layouts = set()

    def recorded(x, gy, kernel, stride):
        layouts.add((tuple(x.shape), x.stride(), tuple(gy.shape), gy.stride()))
        return wgrad(x, gy, kernel, stride)

    TS.make_train_step, CW.conv3d_wgrad = make, recorded
    c = load("workloads", "cnn3d.train.json")
    cfg = load("configs", f"{c['config']}.json")
    res = run.execute(c, cfg, seed, seconds, False)
    TS.make_train_step, CW.conv3d_wgrad = made, wgrad
    by = collections.defaultdict(float)
    total = collections.defaultdict(float)
    for p in profs:
        for ev in p.events():
            for k in ev.kernels:
                total[k.name] += k.duration
                op = ev
                while op is not None and "convolution" not in op.name \
                        and "Conv3d" not in op.name:
                    op = op.cpu_parent
                if op is not None:
                    by[(op.name, str(op.input_shapes), k.name)] += k.duration
    n = len(profs)
    rows = sorted(({"op": o, "shapes": s, "kernel": k, "ms_per_step":
                    us / 1e3 / n} for (o, s, k), us in by.items()),
                  key=lambda r: -r["ms_per_step"])
    busy = sum(total.values()) / 1e3 / n
    return {"correct": res["correct"], "checks": res["checks"],
            "hand_wgrad_layouts": sorted(layouts),
            "steps_profiled": n, "busy_ms_per_step": busy,
            "conv_kernels": rows,
            "top_kernels": sorted(((k, v / 1e3 / n) for k, v in
                                   total.items()), key=lambda r: -r[1])[:12]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("chip_wgrad")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_wgrad: no CUDA device", file=sys.stderr)
        return 2
    from portbench.run import cache_env
    cache_env(ROOT)
    torch.set_num_threads(4)
    out = attribute(args.seed, args.seconds)
    out.update(card())
    line = json.dumps(out, default=str)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
