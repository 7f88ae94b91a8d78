"""Spans, counters and traces of the program (the counterpart of
gsplat_tpu/utils/profiling.py's trace and annotations).

Tracing is on while a ``torch.profiler`` session runs in the process: a
benchmark's traced stretch, train_static's ``--profile_iterations``, or an
operator's own session. There is no other switch.

- ``span(name)``: a context manager around one stage of the work. Off, it
  costs one flag check and records nothing. On, it enters
  ``torch.profiler.record_function(name)``, so the stage shows in an
  exported trace beside its kernels, and appends a ``Span`` to an
  in-memory buffer: name, start and end in ``time.time_ns()`` (the clock
  Kineto gives its events in), the enclosing span's name (None for a
  root) and the id of its root, which every span under one root shares
  (one served frame, one training step).
- ``count(name, n)``: adds ``n`` to a counter, only while tracing is on.
- ``spans()`` / ``counters()`` read the buffers; ``reset()`` empties them.
- ``Trace`` / ``trace(logdir)``: a profiler session that writes a Chrome
  trace (``<logdir>/trace.json``), then empties the buffers.

Spans nest on one stack for the process: the program opens them from one
thread at a time (autograd's device thread runs a backward while the
caller waits in ``torch.autograd.grad``, so the backward's spans nest
under the caller's).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    id: int


_SPANS: list = []
_COUNTERS: dict = {}
_OPEN: list = []                 # the open spans, innermost last
_ROOTS = itertools.count()
_LOCK = threading.Lock()


def enabled() -> bool:
    """True while a ``torch.profiler`` session runs in this process (the
    flag ``record_function``'s own fast path reads)."""
    return _autograd_profiler._is_profiler_enabled


_OFF = contextlib.nullcontext()


class _On:
    __slots__ = ("name", "start", "parent", "root", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.time_ns()
        with _LOCK:
            if _OPEN:
                self.parent, self.root = _OPEN[-1].name, _OPEN[-1].root
            else:
                self.parent, self.root = None, next(_ROOTS)
            _OPEN.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = time.time_ns()
        with _LOCK:
            _OPEN.remove(self)
            _SPANS.append(Span(self.name, self.start, end, self.parent,
                               self.root))
        return False


def span(name: str):
    """A named stage of the work (see the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on."""
    if _autograd_profiler._is_profiler_enabled:
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def spans() -> list:
    """The recorded spans, in the order they ended."""
    with _LOCK:
        return list(_SPANS)


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Empties the span buffer and the counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Trace:
    """A torch.profiler session that writes ``<logdir>/trace.json`` when it
    stops. ``start``/``stop`` for a trace over loop iterations; ``trace``
    wraps a block."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = os.path.join(logdir, "trace.json")
        self.prof = None

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        reset()
        return self.path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an op- and kernel-level trace of the block into
    ``logdir``; yields the Trace (its ``prof`` holds the events)."""
    t = Trace(logdir)
    t.start()
    try:
        yield t
    finally:
        t.stop()
