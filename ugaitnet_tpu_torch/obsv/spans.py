"""Spans and counters of the program's own layers, kept in memory.

Recording is on exactly while ``torch.profiler`` records on the calling
thread (``torch.autograd._profiler_enabled()``, which is thread-local and
False in a profiler schedule's wait and warm-up steps).  There is no other
switch: with no profiler running, a span or a counter costs that one check.

  * ``span(name, id)``: a block, timed with ``time.time_ns()`` (the clock
    of the Chrome trace the profiler exports: its ``ts`` is
    ``(time_ns - baseTimeNanoseconds) / 1000``), with its parent (the
    enclosing span on the same thread) and an identifier shared by one
    request: ``(epoch, batch index)`` on the input path, ``(pass, batch)``
    in the encode loop, the step count in the train step.  It also opens
    the profiler range ``ugn.<name>``, beside the kernels it launches;
  * ``add(name, start_ns, end_ns, id)``: a span timed on another thread
    (the prefetch producer's gathers, where the profiler does not record),
    recorded by the thread that consumes its result;
  * ``count(name, n)`` and ``count_pageable(name, src, device)``: counters.

Everything is kept until ``clear()``, at most ``CAP`` spans; later ones
are counted in ``dropped``.  ``snapshot()`` reads it; ``chrome_events``
gives the spans recorded since a ``mark()`` as Chrome trace events.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Hashable, List, NamedTuple, Optional

import torch

CAP = 1 << 16
PREFIX = "ugn."

_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: Optional[Hashable]
    parent: Optional[str]
    tid: int


_lock = threading.Lock()
_spans: List[Span] = []
_counters: Dict[str, int] = collections.Counter()
_dropped = 0
_stack = threading.local()


def _record(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAP:
            _spans.append(s)
        else:
            _dropped += 1


class _Open:
    """A span being timed.  The clock reads enclose the profiler range, so
    the span holds what the range costs and spans that follow each other
    leave no time between them."""

    __slots__ = ("name", "id", "range", "start")

    def __init__(self, name: str, id: Optional[Hashable]):
        self.name, self.id = name, id

    def __enter__(self):
        self.start = time.time_ns()
        stack = getattr(_stack, "names", None)
        if stack is None:
            stack = _stack.names = []
        stack.append(self.name)
        self.range = torch.autograd.profiler.record_function(
            PREFIX + self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        stack = _stack.names
        stack.pop()
        _record(Span(self.name, self.start, time.time_ns(), self.id,
                     stack[-1] if stack else None, threading.get_native_id()))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, id: Optional[Hashable] = None):
    """A context manager recording the block as span ``name``; with no
    profiler recording on this thread, one that does nothing."""
    return _Open(name, id) if _enabled() else _OFF


def add(name: str, start_ns: int, end_ns: int,
        id: Optional[Hashable] = None, tid: Optional[int] = None) -> None:
    """Record a span timed elsewhere (``time.time_ns()`` stamps; ``tid``
    the native id of the thread that ran it, this one by default)."""
    if _enabled():
        _record(Span(name, start_ns, end_ns, id, None,
                     threading.get_native_id() if tid is None else tid))


def count(name: str, n: int = 1) -> None:
    if _enabled():
        with _lock:
            _counters[name] += n


def holds_host(src: torch.Tensor, device: torch.device) -> bool:
    """Whether moving ``src`` to ``device`` holds the host until the card
    has drained the stream: a CPU tensor that is not page-locked, going to
    a CUDA device."""
    return (device.type == "cuda" and src.device.type == "cpu"
            and not src.is_pinned())


def count_pageable(name: str, src: torch.Tensor,
                   device: torch.device) -> None:
    """``count(name)`` when moving ``src`` to ``device`` holds the host."""
    if _enabled() and holds_host(src, device):
        count(name)


def snapshot() -> Dict:
    """{"spans": [Span as a dict, in the order they ended], "counters":
    {name: n}, "dropped": spans not kept past CAP}."""
    with _lock:
        return {"spans": [s._asdict() for s in _spans],
                "counters": dict(_counters), "dropped": _dropped}


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0


def mark() -> int:
    """The registry's position, for ``chrome_events``."""
    with _lock:
        return len(_spans)


def chrome_events(since: int, base_ns: int, pid: int) -> List[Dict]:
    """The spans recorded since ``mark()`` returned ``since`` (and no
    ``clear()`` came between), as Chrome trace events on a trace whose
    ``baseTimeNanoseconds`` is ``base_ns``."""
    with _lock:
        spans = _spans[since:]
    return [{"ph": "X", "cat": "ugn_span", "name": PREFIX + s.name,
             "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.tid,
             "args": {"id": repr(s.id), "parent": s.parent}}
            for s in spans]
