"""Per-Gaussian preprocessing: cull, project, conic, radius, SH color
(port of gsplat_tpu/raster/project.py, forward only).

Numerics as in the reference preprocessCUDA (forward.cu:156-256):
near cull at z <= 0.2, perspective divide guarded by +1e-7, EWA cov2d
with the +0.3 low-pass, radius = ceil(3 * sqrt(lambda1)) with the
eigenvalue discriminant clamped at 0.1, ndc2pix pixel mapping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.core import covariance as cov
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.camera import CameraParams, ndc_to_pix


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all [P, ...])."""

    xy: torch.Tensor        # [P, 2] pixel-space mean
    depth: torch.Tensor     # [P] camera-space z (+inf when culled)
    conic: torch.Tensor     # [P, 3] inverse 2D covariance (a, b, c)
    rgb: torch.Tensor       # [P, 3] view-dependent color (clamped >= 0)
    opacity: torch.Tensor   # [P] activated opacity
    radius: torch.Tensor    # [P] int32 screen radius (0 => culled)
    visible: torch.Tensor   # [P] bool


def preprocess(means3d, scales, quats, opacities, shs,
               camera: CameraParams, sh_degree: int, *,
               colors_precomp=None, cov3d_precomp=None,
               scale_modifier: float = 1.0, alive=None) -> Preprocessed:
    """Vectorized preprocess. Culled or dead Gaussians get radius 0 and
    depth +inf."""
    view = camera.view
    depth = (view[2, 0] * means3d[:, 0] + view[2, 1] * means3d[:, 1]
             + view[2, 2] * means3d[:, 2] + view[2, 3])
    visible = depth > 0.2
    if alive is not None:
        visible = visible & alive

    fp = camera.full_proj
    hx, hy, hw = (fp[i, 0] * means3d[:, 0] + fp[i, 1] * means3d[:, 1]
                  + fp[i, 2] * means3d[:, 2] + fp[i, 3] for i in (0, 1, 3))
    p_w = 1.0 / (hw + 1e-7)
    x_pix = ndc_to_pix(hx * p_w, camera.width)
    y_pix = ndc_to_pix(hy * p_w, camera.height)
    xy = torch.stack([x_pix, y_pix], dim=-1)

    if cov3d_precomp is not None:
        cov6 = cov3d_precomp
    else:
        cov6 = cov.covariance_6(scales, quats, scale_modifier)
    a, b, c = cov.project_cov2d(
        means3d, cov6, view, camera.focal_x, camera.focal_y,
        camera.tan_fovx, camera.tan_fovy)

    det = a * c - b * b
    visible = visible & (det != 0.0)
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    radius = torch.where(visible, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        rgb = sh_lib.sh_to_rgb(sh_degree, shs, means3d, camera.cam_pos)

    depth = torch.where(visible, depth, torch.full_like(depth, float("inf")))
    return Preprocessed(xy=xy, depth=depth, conic=conic, rgb=rgb,
                        opacity=opacities, radius=radius, visible=visible)


def tile_rect(xy, radius, tile_x: int, tile_y: int, grid_x: int,
              grid_y: int):
    """Tile bounding rect per Gaussian (auxiliary.h:46-56 getRect):
    (min_x, min_y, max_x, max_y) int32, max exclusive, clamped to the
    grid."""
    x, y = xy[..., 0], xy[..., 1]
    r = radius.to(x.dtype)

    def cell(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n).to(torch.int32)

    return (cell(x - r, tile_x, grid_x), cell(y - r, tile_y, grid_y),
            cell(x + r + tile_x - 1, tile_x, grid_x),
            cell(y + r + tile_y - 1, tile_y, grid_y))
