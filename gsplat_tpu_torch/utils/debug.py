"""Failure snapshot dumps (port of gsplat_tpu/utils/debug.py).

The trainer checks the fetched loss every 10 iterations and, on the first
non-finite value, pickles the full optimisation state (parameters, Adam
moments, camera, iteration) as numpy to ``snapshot_fw.dump`` in the model
directory before aborting: the analogue of the reference rasterizer's
debug snapshot (diff_gaussian_rasterization/__init__.py:83-90).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _to_host(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def dump_snapshot(model_path: str, name: str = "snapshot_fw.dump",
                  **trees) -> str:
    """Pickle host copies of the given trees; returns the path."""
    os.makedirs(model_path or ".", exist_ok=True)
    path = os.path.join(model_path or ".", name)
    with open(path, "wb") as f:
        pickle.dump({k: _to_host(v) for k, v in trees.items()}, f)
    return path


def check_finite_loss(loss: float, iteration: int, model_path: str,
                      **trees) -> None:
    """Abort on a non-finite loss, dumping a reproducer snapshot."""
    if np.isfinite(loss):
        return
    path = dump_snapshot(model_path, iteration=iteration, loss=loss, **trees)
    raise RuntimeError(
        f"non-finite loss ({loss}) at iteration {iteration}; training "
        f"state snapshot dumped to {path} — rerun with --detect_anomaly "
        f"to localize the op, and please forward the snapshot in bug "
        f"reports")
