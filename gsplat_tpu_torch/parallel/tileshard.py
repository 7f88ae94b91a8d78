"""Image-band sharded rendering (port of gsplat_tpu/parallel/tileshard.py).

Each rank renders one horizontal band of the frame against the full,
replicated parameter set (``rasterize(band_h=, band_y0=)``), and the bands
are all-gathered into the frame: no compositing collective, since the
bands are disjoint pixels. A Gaussian is binned on a rank only if its
rect meets that rank's band, so the per-rank work shrinks in pixels and in
duplicates. Every band pixel is computed by one rank in the single-device
compositing order, so the frame matches the single-device render up to the
rounding of one pixel-space translation.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.mesh import Mesh
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize


def band_height(height: int, n_dev: int, tile_y: int) -> int:
    """Rows per rank: equal bands padded up to whole tile rows (the last
    band's pad rows are rendered and cropped)."""
    rows = -(-height // n_dev)
    return -(-rows // tile_y) * tile_y


def _band(mesh: Mesh, settings, sh_degree, axis, means, scales, quats, opa,
          shs, alive, camera: CameraParams, bg):
    n_dev = mesh.shape[axis]
    hb = band_height(camera.height, n_dev, settings.tile_y)
    d = mesh.axis_index(axis)
    return rasterize(means, scales, quats, opa, shs, camera, sh_degree, bg,
                     settings, alive=alive, band_h=hb,
                     band_y0=float(d * hb)), hb


def make_tileshard_render(mesh: Mesh, settings: RasterizeSettings,
                          sh_degree: int, axis: str = "sp"):
    """render(means3d, scales, quats, opacities, shs, alive, camera, bg)
    -> the [H, W, 3] frame on every rank; all inputs replicated.
    ``settings.k_dup`` is the per-band duplicate budget."""
    settings = dataclasses.replace(settings, layout="chw")

    @torch.no_grad()
    def render(means, scales, quats, opa, shs, alive, camera, bg):
        out, hb = _band(mesh, settings, sh_degree, axis, means, scales,
                        quats, opa, shs, alive, camera, bg)
        # [3, hb, W] bands -> [n * 3, hb, W] in band order
        bands = mesh_lib.all_gather(out.image.contiguous(), mesh, axis)
        n, w = mesh.shape[axis], camera.width
        img = bands.view(n, 3, hb, w).permute(1, 0, 2, 3).reshape(3, -1, w)
        return img[:, :camera.height].permute(1, 2, 0)

    return render


def tileshard_num_dup(mesh: Mesh, settings: RasterizeSettings,
                      sh_degree: int, axis: str = "sp"):
    """The per-band duplicate count (max over bands), for sizing the
    per-band ``k_dup`` before building the render."""
    settings = dataclasses.replace(settings, layout="chw")

    @torch.no_grad()
    def probe(means, scales, quats, opa, shs, alive, camera, bg):
        out, _ = _band(mesh, settings, sh_degree, axis, means, scales,
                       quats, opa, shs, alive, camera, bg)
        return mesh_lib.pmax(out.num_dup.reshape(1), mesh, axis)[0]

    return probe
