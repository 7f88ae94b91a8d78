"""The benchmark's own host spans: (name, start, end) in
``time.time_ns()``, kept only in a traced run, where ``trace.Summary``
names the device's idle gaps by them."""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self, on: bool):
        self.on = on
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))
