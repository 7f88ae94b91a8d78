"""Build and load the hand-written CUDA kernels in ``gsplat_tpu_torch/csrc``.

All sources go to one ``torch.utils.cpp_extension.load`` call at first use,
for sm_90a. Only ``binding.cpp`` includes PyTorch's headers (compiled by the
host compiler); the ``.cu`` files (and ``tile_common.cuh``, which the render
and blend kernels include) have a plain C interface, so nvcc builds them in
seconds. The build lands in ``build/torch_kernels`` at the root of
the checkout (listed in .gitignore); ``load`` reuses it while the sources
are unchanged.
"""

from __future__ import annotations

import functools
import os
import pathlib

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("binding.cpp", "scan_kernels.cu", "render_kernel.cu",
           "blend_kernels.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")


@functools.cache
def load():
    """The compiled extension module (built on the first call)."""
    from torch.utils.cpp_extension import load as load_ext

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load_ext(
        name="gsplat_tpu_torch_kernels",
        sources=[str(CSRC / s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O3"],
        extra_cuda_cflags=list(CUDA_FLAGS))
