"""Offline render helpers (port of gsplat_tpu/eval/render.py: ``save_png``
only; the render-sets entry point comes with a later slice of the port)."""

from __future__ import annotations

import os

import numpy as np


def save_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] float image in [0, 1] as an 8-bit PNG."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
                    ).save(path)
