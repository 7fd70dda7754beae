"""The program's spans and counters (``ugaitnet_tpu_torch/obsv/spans.py``)
on the card: what they cost, how well the encode spans account for a
pass, and where the encode cell's slow passes lose their time.

    python3 tools/chip_spans.py cost
    python3 tools/chip_spans.py account <cell> --seed N --seconds S
    python3 tools/chip_spans.py episodes --seed N --seconds S

``cost``: microseconds a call of ``span`` (enter and exit), ``add``,
``count`` and ``count_pageable`` with no profiler running, and under a
``torch.profiler`` of the CPU and the card.  ``account``: one traced run
of a benchmark cell (``portbench/run.py``'s ``execute`` with ``--trace
1``): its per-layer readings, the registry's totals by name, and in the
encode cell the traced pass's host time (the harness's "pb.encode_pass"
range) against its spans.  ``episodes``: the encode cell untraced, with
the registry recording every pass (its switch replaced in this process
only): each pass's host time and its spans' totals, and the slow passes
(over 1.1 x the median) against the others.  ``--tiny --device cpu``
rehearses ``episodes`` on the CPU at the benchmark tests' tiny widths.
Prints one JSON line; ``--out`` writes it too.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "portbench", "tests")]

import torch  # noqa: E402

from ugaitnet_tpu_torch.obsv import spans  # noqa: E402

PARTS = ("input.gather", "encode.launch", "encode.readback",
         "encode.collect")


def per_call_us(fn, n: int) -> float:
    t = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t) / n * 1e6


def cost(n: int) -> dict:
    dev = torch.device("cuda")
    src = torch.zeros(4)

    def one_span(i):
        with spans.span("cost", i):
            pass

    calls = {"span": one_span,
             "add": lambda i: spans.add("cost", 0, 1, i),
             "count": lambda i: spans.count("cost"),
             "count_pageable": lambda i: spans.count_pageable("cost", src,
                                                              dev),
             "empty loop": lambda i: None}
    out = {"off_us": {k: per_call_us(f, n) for k, f in calls.items()}}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_us"] = {k: per_call_us(f, n // 10) for k, f in calls.items()}
    spans.clear()
    return out


def totals(snap: dict) -> dict:
    """{name: [count, ms]} of the registry's spans."""
    out = {}
    for s in snap["spans"]:
        c, ms = out.get(s["name"], (0, 0.0))
        out[s["name"]] = (c + 1, ms + (s["end_ns"] - s["start_ns"]) / 1e6)
    return out


def load_cell(name: str, tiny: bool):
    from conftest import load, tiny_cell, tiny_config
    if tiny:
        c = tiny_cell(name)
        return c, tiny_config(c["config"])
    c = load("workloads", f"{name}.json")
    return c, load("configs", f"{c['config']}.json")


def account(name: str, seed: int, seconds: float, device: str,
            tiny: bool) -> dict:
    from portbench import harness, run
    passes = []
    reduce = harness.reduce_trace

    def keep_passes(path):
        with open(path) as f:
            trace = json.load(f)
        base = int(trace["baseTimeNanoseconds"])
        passes.extend((base + 1e3 * e["ts"], base + 1e3 * (e["ts"] + e["dur"]))
                      for e in trace["traceEvents"]
                      if e.get("name") == "pb.encode_pass"
                      and e.get("cat") == "user_annotation")
        return reduce(path)

    harness.reduce_trace = keep_passes
    spans.clear()
    c, cfg = load_cell(name, tiny)
    res = run.execute(c, cfg, seed, seconds, True, device=device)
    snap = spans.snapshot()
    out = {"correct": res["correct"], "metrics": res["metrics"],
           "device": res["device"], "spans": totals(snap),
           "counters": snap["counters"], "dropped": snap["dropped"]}
    if passes:
        # the pass's host time outside its spans: before the first, between
        # them, after the last (the trace's clock is the registry's)
        ((t0, t1),) = passes
        parts = sorted((s["start_ns"], s["end_ns"]) for s in snap["spans"]
                       if s["name"] in PARTS)
        inside = sum(e - s for s, e in parts)
        out["pass_ms"] = (t1 - t0) / 1e6
        out["spans_ms"] = inside / 1e6
        out["accounted"] = inside / (t1 - t0)
        out["outside_ms"] = {
            "before": (parts[0][0] - t0) / 1e6,
            "between": (parts[-1][1] - parts[0][0] - inside) / 1e6,
            "after": (t1 - parts[-1][1]) / 1e6}
    return out


def episodes(seed: int, seconds: float, device: str, tiny: bool) -> dict:
    from portbench import run
    spans.clear()
    spans._enabled = lambda: True         # every pass, with no profiler
    c, cfg = load_cell("gaitset.encode_bf16", tiny)
    res = run.execute(c, cfg, seed, seconds, False, device=device)
    spans._enabled = torch.autograd._profiler_enabled
    by_pass = {}
    for s in spans.snapshot()["spans"]:
        if s["name"] in PARTS:
            npass = s["id"] if s["name"] == "encode.collect" else s["id"][0]
            row = by_pass.setdefault(npass, dict.fromkeys(PARTS, 0.0))
            row[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e6
    rows = [by_pass[k] for k in sorted(by_pass)]
    # the warm-up's pass is the first the registry holds
    host = [1e3 * x for x in res["record"]["spans"]["encode_pass"]]
    rows = rows[len(rows) - len(host):]
    for r, ms in zip(rows, host):
        r["pass_ms"] = ms
    med = statistics.median(host)
    slow = [r for r in rows if r["pass_ms"] > 1.1 * med]
    rest = [r for r in rows if r["pass_ms"] <= 1.1 * med]

    def mean(rs):
        return {k: statistics.fmean(r[k] for r in rs) for k in rs[0]} \
            if rs else {}
    return {"correct": res["correct"], "device": res["device"],
            "passes": len(rows), "median_pass_ms": med,
            "slow_passes": len(slow), "slow_mean": mean(slow),
            "rest_mean": mean(rest), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("chip_spans")
    ap.add_argument("what", choices=("cost", "account", "episodes"))
    ap.add_argument("cell", nargs="?")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--calls", type=int, default=200_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_spans: no CUDA device", file=sys.stderr)
        return 2
    from portbench.run import cache_env
    cache_env(ROOT)
    torch.set_num_threads(4)
    if args.what == "cost":
        out = cost(args.calls)
    elif args.what == "account":
        out = account(args.cell, args.seed, args.seconds, args.device,
                      args.tiny)
    else:
        out = episodes(args.seed, args.seconds, args.device, args.tiny)
    out["what"] = args.what
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
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
