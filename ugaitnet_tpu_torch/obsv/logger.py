"""Observability: scalar metrics, embedding exports, profiling.

Port of ``ugaitnet_tpu/obsv/logger.py``, in the same ``metrics.jsonl``
format, so one reader serves both packages:

  * an always-on JSONL metrics stream (metrics.jsonl per experiment dir);
  * optional TensorBoard scalars via torch.utils.tensorboard when
    importable;
  * embedding projector export: codes + labels as .npy/.tsv in the TB
    projector layout, with a sprite sheet when thumbnails are given;
  * ``profile(logdir)``: a ``torch.profiler`` trace around a block (the
    profile_batch analogue), written as a Chrome trace with the program's
    spans (``obsv/spans.py``) in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Sequence

import numpy as np


class MetricsLogger:
    def __init__(self, experdir: str, use_tensorboard: bool = False):
        os.makedirs(experdir, exist_ok=True)
        self.experdir = experdir
        self.path = os.path.join(experdir, "metrics.jsonl")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=os.path.join(experdir, "tb"))
            except ImportError:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        rec = {}
        for k, v in metrics.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            # nan/inf would serialize as literal NaN/Infinity, which is
            # invalid JSON; an undefined metric (e.g. a val EER) is null
            rec[prefix + k] = f if np.isfinite(f) else None
        # bookkeeping fields win: a metric literally named "time"/"step"
        # must not overwrite the record timestamp/step
        rec["step"] = int(step)
        rec["time"] = time.time()
        # one append per record: a crash leaves at most a torn last line,
        # which read_metrics skips
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and v is not None:
                    self._tb.add_scalar(k, v, step)

    def export_embeddings(self, step: int, codes: np.ndarray,
                          labels: Sequence, tag: str = "signatures",
                          images: Sequence = None) -> str:
        """Projector-style export: codes .npy + labels .tsv per step, plus a
        sprite sheet when per-sample thumbnails are given.  The sprite needs
        PIL; without it the sheet is left out."""
        d = os.path.join(self.experdir, "projector", f"{tag}_{step:05d}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "codes.npy"), np.asarray(codes))
        with open(os.path.join(d, "metadata.tsv"), "w") as f:
            for l in labels:
                f.write(f"{l}\n")
        if images is not None and len(images) == len(codes):
            try:
                from ugaitnet_tpu_torch.utils.net_utils import save_sprite
                save_sprite(images, os.path.join(d, "sprite.png"),
                            max_size=2048)
            except ImportError:
                pass
        if self._tb is not None:
            self._tb.add_embedding(np.asarray(codes), metadata=list(labels),
                                   tag=tag, global_step=step)
        return d

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile(logdir: str, enabled: bool = True):
    """``torch.profiler`` trace (CPU, and CUDA when a card is present) around
    a block, written to ``<logdir>/trace.json`` for chrome://tracing.  The
    spans the block recorded (``obsv/spans.py``) are added to it as events
    of category ``ugn_span`` on the trace's clock, the prefetch producer's
    gathers among them, which the profiler does not see."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity
    from ugaitnet_tpu_torch.obsv import spans
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    since = spans.mark()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] = trace.get("traceEvents", []) + spans.chrome_events(
        since, int(trace["baseTimeNanoseconds"]), os.getpid())
    with open(path, "w") as f:
        json.dump(trace, f)


def read_metrics(experdir: str) -> list:
    path = os.path.join(experdir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail from a crash mid-write
    return out
