"""What every driver shares: the model the configuration names, host-clock
spans, the profiled slice of a traced run and its reduction to device
busy time, idle gaps and per-range device time.

Spans and ranges are recorded here, around the benchmark's own calls into
the program; nothing inside the program is instrumented.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import time
from typing import Dict, List, Optional

import torch

from portbench.weights import make_weights

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def model_config(cfg: Dict, overrides: Optional[Dict] = None):
    """The program's ModelConfig for a configuration file's ``model``,
    with a cell's overrides."""
    from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
    m = dict(cfg["model"], **(overrides or {}))
    branches = tuple(BranchConfig(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in b.items()})
                     for b in m["branches"])
    return ModelConfig(**dict(m, branches=branches))


def set_precision(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def build_model(mcfg, seed: int, device):
    """The program's UGaitNet with the benchmark's weights for ``seed``:
    (model, the weights as handed to it)."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    model = UGaitNet(mcfg, device=device, seed=0)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    W = make_weights(shapes, seed, device)
    model.load_state_dict(W)
    return model, W


class Spans:
    """Host-clock durations by name; each also a profiler range ("pb.<name>")
    when the run is traced."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.times: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.autograd.profiler.record_function(f"pb.{name}")
              if self.traced else contextlib.nullcontext())
        with rf:
            t = time.perf_counter()
            try:
                yield
            finally:
                self.times[name].append(time.perf_counter() - t)


class Tracer:
    """torch.profiler over a bounded slice of the window: ``active`` units
    after one warm-up unit (the profiler drops events of its first traced
    step), starting once ``start_s`` of the window has passed.  Call
    ``unit_done(elapsed)`` after each unit; the last traced unit ends in a
    synchronize, so the slice holds all of its device work."""

    def __init__(self, enabled: bool, active: int, start_s: float,
                 path: str):
        self.enabled, self.active, self.start_s = enabled, active, start_s
        self.path = path
        self.prof = None
        self.units = 0
        self.done = False

    def unit_done(self, elapsed: float) -> None:
        if not self.enabled or self.done:
            return
        if self.prof is None:
            if elapsed < self.start_s:
                return
            from torch.profiler import ProfilerActivity, profile, schedule
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=self.active,
                                  repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(self.path))
            self.prof.start()
            return
        self.units += 1
        last = self.units == 1 + self.active
        if last and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.step()
        if last:
            self.finish()

    def finish(self) -> None:
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True


@contextlib.contextmanager
def conv_ranges(model, enabled: bool):
    """A profiler range "pb.conv3x3.<modality>.<conv>" around every 3x3
    GaitSet conv of ``model`` while the block runs (forward hooks)."""
    if not enabled:
        yield
        return
    handles = []
    for bname, branch in model.branches.items():
        mod = bname[len("branch_"):]
        for name, sub in branch.named_children():
            w = getattr(sub, "weight", None)
            if w is None or w.ndim != 4 or w.shape[-1] != 3:
                continue
            tag = f"pb.conv3x3.{mod}.{name}"

            def pre(m, args, tag=tag):
                m._pb_range = torch.autograd.profiler.record_function(tag)
                m._pb_range.__enter__()

            def post(m, args, out):
                m._pb_range.__exit__(None, None, None)

            handles += [sub.register_forward_pre_hook(pre),
                        sub.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path: str) -> Dict:
    """The profiled slice of a Chrome trace (``export_chrome_trace``):

    * ``window_s``: from the first "pb." range to the end of the last
      "pb." range or device event, whichever is later;
    * ``busy_s``: the union of kernel, memcpy and memset intervals in it;
    * ``device_ops``: seconds per kernel name, the ten largest;
    * ``idle_by_range``: the device's idle seconds inside the window by
      the innermost "pb." range the host was in during each piece of a
      gap; ``idle_gaps``: its ten largest entries;
    * ``ranges``: {range name: (calls, device seconds of the kernels
      launched inside it)} for the "pb." ranges.
    """
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    pb = [e for e in events if e.get("cat") == "user_annotation"
          and str(e.get("name", "")).startswith("pb.")]
    if not pb:
        return {}
    t0 = min(e["ts"] for e in pb)
    t1 = max([e["ts"] + e["dur"] for e in pb]
             + [e["ts"] + e["dur"] for e in dev])
    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                  for e in dev if e["ts"] + e["dur"] > t0 and e["ts"] < t1)
    ops = collections.Counter()
    for e in dev:
        if e.get("cat") == "kernel":
            ops[e["name"]] += e["dur"] / 1e6
    gaps = collections.Counter()
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        # each piece of the gap goes to the innermost range the host was in
        cuts = sorted({s, e} | {x for r in pb for x in (r["ts"],
                                                        r["ts"] + r["dur"])
                                if s < x < e})
        for a, b in zip(cuts, cuts[1:]):
            inside = [r for r in pb if r["ts"] <= a < r["ts"] + r["dur"]]
            name = (max(inside, key=lambda r: r["ts"])["name"] if inside
                    else "no pb. range")
            gaps[name] += (b - a) / 1e6
    # kernels launched from inside each range, matched by correlation id
    by_corr = collections.defaultdict(float)
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"] / 1e6
    # per thread: launch times and the device seconds each launched, with
    # running sums, so a range's total is a difference of two sums
    per_tid = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            per_tid[e.get("tid")].append(
                (e["ts"], by_corr.get(e.get("args", {}).get("correlation"),
                                      0.0)))
    sums = {}
    for tid, rows in per_tid.items():
        rows.sort()
        sums[tid] = ([t for t, _ in rows],
                     list(itertools.accumulate((s for _, s in rows),
                                               initial=0.0)))
    ranges = {}
    for r in pb:
        ts, acc = sums.get(r.get("tid"), ([], [0.0]))
        lo = bisect.bisect_left(ts, r["ts"])
        hi = bisect.bisect_right(ts, r["ts"] + r["dur"])
        calls, total = ranges.get(r["name"], (0, 0.0))
        ranges[r["name"]] = (calls + 1, total + acc[hi] - acc[lo])
    return {"window_s": (t1 - t0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_ops": [[n, s] for n, s in ops.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
            "idle_by_range": dict(gaps),
            "ranges": ranges}


def read_trace(tracer: Tracer) -> Dict:
    """Stop the tracer, reduce its trace and delete the file."""
    tracer.finish()
    if not os.path.exists(tracer.path):
        return {}
    try:
        return reduce_trace(tracer.path)
    finally:
        os.unlink(tracer.path)
