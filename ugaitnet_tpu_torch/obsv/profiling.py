"""Per-op time summaries from ``torch.profiler`` traces.

Port of ``ugaitnet_tpu/obsv/profiling.py``, which reads the JAX profiler's
xplane.  Here the trace is the Chrome trace that ``obsv/logger.py:profile``
writes (``<logdir>/trace.json``, ``torch.profiler``'s
``export_chrome_trace``), and the time per event name is summed:

  * ``device_substr="cuda"``: the card's ``kernel`` events only.  The
    ``gpu_memcpy`` / ``gpu_memset`` spans run beside kernels and are left
    out, as the JAX reader leaves out the async op line whose copy spans
    overlap compute;
  * ``device_substr="cpu"``: the host's ``cpu_op`` events (aten ops, which
    nest: an op's time includes its children's).

Usage:
    with profile("/tmp/trace"):
        for _ in range(3):
            step(state, batch)
    print_op_profile("/tmp/trace", iters=3)
"""

from __future__ import annotations

import collections
import json
import os
from typing import List, NamedTuple

# the trace categories each device_substr reads
_CATEGORIES = {"cuda": ("kernel",), "cpu": ("cpu_op",)}


class OpTime(NamedTuple):
    ms_per_iter: float
    count: int
    name: str


def _trace_path(path_or_dir: str) -> str:
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no trace.json at {path_or_dir}")
    return path


def summarize_trace(path_or_dir: str, iters: int = 1,
                    device_substr: str = "cuda") -> List[OpTime]:
    """Time per event name from a trace dir or trace.json, sorted by total
    time: ms divided by ``iters`` (the identical steps the trace holds),
    and the number of events over the whole trace."""
    cats = _CATEGORIES.get(device_substr.lower())
    if cats is None:
        raise ValueError(f"device_substr must be one of "
                         f"{sorted(_CATEGORIES)}, got {device_substr!r}")
    with open(_trace_path(path_or_dir)) as f:
        events = json.load(f).get("traceEvents", [])
    total: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in cats:
            continue
        total[ev["name"]] += float(ev.get("dur", 0.0))     # microseconds
        count[ev["name"]] += 1
    rows = [OpTime(us / 1e3 / iters, count[name], name)
            for name, us in total.items()]
    rows.sort(key=lambda r: -r.ms_per_iter)
    return rows


def print_op_profile(path_or_dir: str, iters: int = 1, top: int = 40,
                     width: int = 110, device_substr: str = "cuda") -> None:
    for r in summarize_trace(path_or_dir, iters, device_substr)[:top]:
        print(f"  {r.ms_per_iter:8.3f} ms/iter  x{r.count:3d}  "
              f"{r.name[:width]}")
