"""Step timing and tracing (port of gsplat_tpu/utils/profiling.py).

The reference measures per-iteration wall time with paired CUDA events
(train_static.py:53-54,104) and logs ``iter_time``. Here:

- ``StepTimer``: a host-side EMA step timer that waits for the device
  (``torch.cuda.synchronize``) before reading the clock, as JAX's waits
  with block_until_ready;
- ``trace(logdir)``: a ``torch.profiler`` session over the block that
  writes a Chrome trace (``trace.json``) into ``logdir``, with the CUDA
  activity when the process has a card;
- ``annotate(name)``: a named host-side region in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _sync(result) -> None:
    tensors = []
    if isinstance(result, torch.Tensor):
        tensors = [result]
    elif isinstance(result, (tuple, list)):
        tensors = [t for t in result if isinstance(t, torch.Tensor)]
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """EMA per-step timer; call .tick(result) once per step."""

    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self.ema_ms: Optional[float] = None
        self._last = time.perf_counter()

    def tick(self, result=None) -> float:
        if result is not None:
            _sync(result)
        now = time.perf_counter()
        dt_ms = (now - self._last) * 1000.0
        self._last = now
        self.ema_ms = (dt_ms if self.ema_ms is None
                       else self._ema_coef * self.ema_ms
                       + (1 - self._ema_coef) * dt_ms)
        return dt_ms


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


def annotate(name: str):
    """Named host-side region that shows up in captured traces."""
    return torch.profiler.record_function(name)
