"""Background camera prefetching for the sliding-window data path (a
copy of gsplat_tpu/data/prefetch.py, which imports no JAX; the port keeps
its own).

The reference loads every frame's images synchronously inside the training
loop (scene/__init__.py:232-273 ``_activate`` -> ``LazyCamera.load`` ->
PIL decode + resize), so each window advance stalls training for a full
frame of disk IO + JPEG/PNG decode. Here the decode runs on a small
thread pool instead (PIL releases the GIL during decode/resize, so workers
genuinely overlap the device step):

- ``CameraPrefetcher.schedule(key, cams)`` submits loads for every
  not-yet-loaded camera under an opaque key (one key per (split, frame)).
- ``CameraPrefetcher.wait(key)`` blocks until that key's loads finish —
  called by the consumer right before it needs the frame, and by the LRU
  eviction path before unloading (an unload racing a half-done load would
  leak the freshly decoded image).

``DynamicScene`` wires this up behind ``prefetch_workers``: the trainers
call ``prefetch_train_frames`` with the frames the NEXT iterations will
sample while the current device step runs.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Hashable, Iterable, List


class CameraPrefetcher:
    """Thread-pool loader for ``LazyCamera``-like objects (anything with
    idempotent ``load()`` and ``loaded``)."""

    def __init__(self, max_workers: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="cam-prefetch")
        self._pending: Dict[Hashable, List[Future]] = {}
        self._lock = threading.Lock()

    def schedule(self, key: Hashable, cams: Iterable) -> int:
        """Submit loads for the not-yet-loaded cameras under ``key``.
        Re-scheduling a key whose loads are still pending is a no-op.
        Returns the number of submitted loads."""
        with self._lock:
            if key in self._pending:
                return 0
            futs = [self._pool.submit(c.load) for c in cams if not c.loaded]
            if not futs:
                return 0
            self._pending[key] = futs
            return len(futs)

    def wait(self, key: Hashable) -> None:
        """Block until ``key``'s scheduled loads are done (no-op if the
        key was never scheduled or already drained). Worker exceptions
        propagate here, on the consumer thread."""
        with self._lock:
            futs = self._pending.pop(key, None)
        for f in futs or ():
            f.result()

    def drain(self) -> None:
        """Wait for every outstanding load (used before bulk unloads)."""
        with self._lock:
            keys = list(self._pending)
        for k in keys:
            self.wait(k)

    def shutdown(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)
