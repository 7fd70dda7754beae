"""Hyperparameter grid sweeps.

Port of ``ugaitnet_tpu/cli/sweep.py`` over the port's ``cli/train.py``
(flags after ``--`` go to every run, ``--device`` among them).

Equivalent of the reference's TensorBoard HParams tuning grid
((reference) mains/mj_trainUWYHGaitNet_DataGen_CasiaB.py:715-753): run
the training CLI over a cartesian grid of flag values, one experiment dir
per point, and summarize final metrics.

Example:
  python -m ugaitnet_tpu_torch.cli.sweep --grid lr=1e-4,3e-4 \
      margin=0.2,0.3 -- --synthetic --nclasses 4 --epochs 2 --bs 8 \
      --device cpu
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict, List


def parse_grid(specs: List[str]) -> Dict[str, List[str]]:
    grid = {}
    for spec in specs:
        name, _, values = spec.partition("=")
        if not values:
            raise SystemExit(f"bad grid spec: {spec} (want name=v1,v2)")
        grid[name] = values.split(",")
    return grid


def main(argv=None):
    """Run the grid; returns one record per point: {"point", "experdir",
    "final_metrics"}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, passthrough = argv[:split], argv[split + 1:]
    else:
        own, passthrough = argv, []

    p = argparse.ArgumentParser("ugaitnet-torch-sweep")
    p.add_argument("--grid", nargs="+", required=True,
                   help="name=v1,v2 specs; names are train CLI flags")
    p.add_argument("--hparams-dir", type=str, default="",
                   help="write TensorBoard HParams-plugin records for the "
                        "grid here (the reference's hp.hparams tuning "
                        "output, mains/..._CasiaB.py:715-753); empty = off")
    args = p.parse_args(own)
    grid = parse_grid(args.grid)

    import time

    from ugaitnet_tpu_torch.cli import train as train_cli
    from ugaitnet_tpu_torch.obsv.logger import read_metrics

    names = list(grid.keys())
    results = []
    for combo in itertools.product(*(grid[n] for n in names)):
        flags = list(passthrough)
        fix_parts = []
        for n, v in zip(names, combo):
            flags += [f"--{n}", v]
            fix_parts.append(f"{n}{v}")
        fix = "-".join(fix_parts)
        flags += ["--experfix", f"sweep_{fix}"]
        print(f"=== sweep point: {dict(zip(names, combo))}", flush=True)
        t0 = time.time()
        experdir = train_cli.main(flags)
        point = {"point": dict(zip(names, combo)), "experdir": experdir}
        # metrics.jsonl is append-mode across reruns of the same config:
        # keep only records written by THIS run
        final = {}
        for r in read_metrics(experdir):
            if r.get("time", 0) >= t0:
                final.update({k: v for k, v in r.items()
                              if k not in ("step", "time")})
        point["final_metrics"] = final
        results.append(point)
        if args.hparams_dir:
            _log_hparams(args.hparams_dir, len(results) - 1,
                         point["point"], final)

    print(json.dumps(results, indent=2))
    return results


def _log_hparams(base_dir: str, trial: int, hparams: Dict[str, str],
                 metrics: Dict[str, float]) -> None:
    """One TensorBoard HParams-plugin record per grid point
    (torch.utils.tensorboard emits the hparams summary protos the HParams
    dashboard reads — the reference writes the same plugin data via
    tensorboard.plugins.hparams, mains/..._CasiaB.py:731-753)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception as e:   # torch should exist; never kill the sweep
        print(f"! hparams logging unavailable: {e}", flush=True)
        return
    import os

    def num(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)

    w = SummaryWriter(log_dir=os.path.join(base_dir, f"run-{trial}"))
    w.add_hparams({k: num(v) for k, v in hparams.items()},
                  {f"final/{k}": float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))},
                  run_name=".")
    w.close()


if __name__ == "__main__":
    main()
