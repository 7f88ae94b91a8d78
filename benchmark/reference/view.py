"""Plain PyTorch reference of a served frame: the bytes a viewer receives
for one camera, from the Gaussians' raw parameters.

The served path casts the whole per-Gaussian feature row (pixel mean x
and y, conic, opacity, colour) to bfloat16 before compositing, so a mean
at x in [1024, 2048) lands on a grid of 8 pixels (a documented behaviour
of the reference renderer that the program reproduces on purpose); every
contribution composites, over a black background; the image is rounded
to bfloat16, clipped to [0, 1] and sent as (x * 255 + 0.5) truncated to
uint8, RGB, row-major.
"""

from __future__ import annotations

import torch

from . import raster
from .train import activated


def frame_bytes(p, cam, sh_degree: int, tile, dtype=torch.float32,
                work=None):
    """uint8 [H, W, 3] of camera ``cam`` from raw leaves ``p``. ``dtype``
    is the arithmetic (float32; a lower type for the control); the
    feature stream is bfloat16."""
    with torch.no_grad():
        means, scales, quats, opa, shs = (x.to(dtype) for x in activated(
            {k: v.float() for k, v in p.items()}))
        proj = raster.preprocess(means, scales, quats, opa, shs, cam,
                                 sh_degree)
        pairs = raster.bin_pairs(proj, cam.width, cam.height, *tile)
        table = raster.features(proj).to(torch.bfloat16).to(dtype)
        img, _ = raster.composite(table, pairs, cam.width, cam.height, *tile,
                                  stop=False, budget=1 << 13, work=work)
        img = img.to(torch.bfloat16).float().clamp(0.0, 1.0)
        if work is not None:
            work["pairs"] = work.get("pairs", 0) + int(pairs.gauss.shape[0])
        return (img * 255.0 + 0.5).to(torch.uint8).permute(1, 2, 0)
