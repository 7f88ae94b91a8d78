"""Rasterization API, inference path (port of gsplat_tpu/raster/rasterize.py).

preprocess -> bin_gaussians (depth sort, owner expansion, chunk padding)
-> one row gather of the depth-ordered feature table per slot
(``_slot_features``) -> the inference tile render -> tile assembly into a
[3, H, W] bf16 image. The differentiable training path (``inference=False``)
belongs to the training slice.

Known reference behaviour, reproduced on purpose: ``_slot_features`` casts
the whole feature table to bf16 before the gather, including the GLOBAL
pixel means x and y, so x in [1024, 2048) lands on a grid of 8 px
(gsplat_tpu/raster/rasterize.py:246-248).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.raster import binning as binning_lib
from gsplat_tpu_torch.raster import project as project_lib
from gsplat_tpu_torch.raster import tile_kernel


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Static rasterizer configuration. ``k_dup`` is the Gaussian x tile
    duplicate budget; overflow is reported through ``num_dup``.
    ``super_chunks`` is kept so the slot count is aligned as in JAX
    (sentinel chunks pad the total to a multiple of it)."""

    k_dup: int
    tile_x: int = 32
    tile_y: int = 16
    chunk: int = 128
    super_chunks: int = 8
    inference: bool = False


class RasterizeOutput(NamedTuple):
    image: torch.Tensor      # [3, H, W] bf16 composited over the background
    radii: torch.Tensor      # [P] int32 (0 => culled)
    is_used: torch.Tensor    # [P] bool, tile-granular on the inference path
    num_dup: torch.Tensor    # [] int32 true duplicate count (<= k_dup)
    final_t: torch.Tensor    # [H, W] zeros on the inference path
    used_tile: torch.Tensor  # [P] bool, >= 1 surviving duplicate


def mark_visible(means3d, camera: CameraParams):
    """[P] bool: view-space depth beyond the 0.2 near plane
    (rasterizer_impl.cu:54-66)."""
    view = camera.view
    depth = (means3d[:, 0] * view[2, 0] + means3d[:, 1] * view[2, 1]
             + means3d[:, 2] * view[2, 2]) + view[2, 3]
    return depth > 0.2


def _feat_columns(proc) -> torch.Tensor:
    """[P, 9] raw kernel feature rows (x, y, a, b, c, opa, rgb) in original
    Gaussian order."""
    return torch.stack([
        proc.xy[:, 0], proc.xy[:, 1],
        proc.conic[:, 0], proc.conic[:, 1], proc.conic[:, 2],
        proc.opacity, proc.rgb[:, 0], proc.rgb[:, 1], proc.rgb[:, 2],
    ], dim=1)


def _slot_features(table, gid, dtype=torch.float32) -> torch.Tensor:
    """[9, K_slots] feature stream from the depth-ordered [P, 9] table.
    The table is cast to ``dtype`` BEFORE the gather, as in JAX (see the
    module docstring); padding slots (gid == P) hit an appended zero row,
    so their alpha is 0."""
    table = torch.cat([table.to(dtype),
                       torch.zeros(1, 9, dtype=dtype, device=table.device)])
    return table.t().contiguous().index_select(1, gid.long())


def rasterize(means3d, scales, quats, opacities, shs, camera: CameraParams,
              sh_degree: int, bg, settings: RasterizeSettings, *,
              colors_precomp=None, cov3d_precomp=None,
              scale_modifier: float = 1.0, alive=None) -> RasterizeOutput:
    """Render Gaussians through the inference pipeline."""
    s = settings
    if not s.inference:
        raise NotImplementedError(
            "gsplat_tpu_torch renders only with inference=True; the "
            "differentiable training rasterizer (tile_kernel._fwd_kernel / "
            "_bwd_kernel) comes with the training slice of the port")
    height, width = camera.height, camera.width
    grid_x = -(-width // s.tile_x)
    grid_y = -(-height // s.tile_y)
    num_tiles = grid_x * grid_y
    n_pix = s.tile_x * s.tile_y

    proc = project_lib.preprocess(
        means3d, scales, quats, opacities, shs, camera, sh_degree,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
        scale_modifier=scale_modifier, alive=alive)
    binn = binning_lib.bin_gaussians(
        proc, tile_x=s.tile_x, tile_y=s.tile_y, grid_x=grid_x,
        grid_y=grid_y, k_dup=s.k_dup, chunk=s.chunk, align=s.super_chunks,
        feat_table=_feat_columns(proc))
    feat = _slot_features(binn.feat_table, binn.gid, dtype=torch.bfloat16)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)
    c_img = tile_kernel.render_forward(
        feat, binn.chunk_meta, bg, num_tiles, n_pix, s.tile_x, s.tile_y,
        grid_x, s.chunk)
    image = assemble_tiles(c_img, grid_x, grid_y, s.tile_x, s.tile_y,
                           width, height)
    final_t = torch.zeros(height, width, dtype=torch.float32,
                          device=means3d.device)
    return RasterizeOutput(image=image, radii=binn.radius,
                           is_used=binn.used, num_dup=binn.num_dup,
                           final_t=final_t, used_tile=binn.used)


def assemble_tiles(img_t, grid_x: int, grid_y: int, tile_x: int,
                   tile_y: int, width: int, height: int) -> torch.Tensor:
    """Channel-major tile buffers [T, ch, n_pix] -> [ch, H, W]."""
    ch = img_t.shape[1]
    img = img_t.reshape(grid_y, grid_x, ch, tile_y, tile_x)
    img = img.permute(2, 0, 3, 1, 4)
    img = img.reshape(ch, grid_y * tile_y, grid_x * tile_x)
    return img[:, :height, :width]
