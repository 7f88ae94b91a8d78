"""PyTorch/CUDA port of gsplat_tpu for NVIDIA Hopper.

The JAX package ``gsplat_tpu`` stays the reference; this package mirrors
its layout module for module (``core/``, ``raster/``, ``model/``,
``data/``, ``viewer/``, ``renderer.py``). It imports torch and numpy only.

Entry points take a ``device`` and default to ``"cuda"``; they raise when
no GPU is present instead of moving to the CPU. The CPU is used only when
the caller asks for it (the tests do), and then every kernel wrapper runs
its plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def get_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device``; raise if CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gsplat_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return device
