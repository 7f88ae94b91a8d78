"""Rasterization API (port of gsplat_tpu/raster/rasterize.py).

preprocess -> bin_gaussians (depth sort, owner expansion, chunk padding)
-> one row gather of the depth-ordered feature table per slot
(``_slot_features``) -> a tile blend -> tile assembly. Two paths:

- ``inference=True``: a bf16 feature stream, the inference render with the
  background composited in-kernel, a [3, H, W] bf16 image; not
  differentiable.
- ``inference=False`` (training): a float32 stream, ``tile_kernel.tile_blend``
  (blend forward and backward kernels), the background added outside, an
  [H, W, 3] (``layout="hwc"``) or [3, H, W] (``"chw"``) float32 image, the
  final transmittance and the pixel-granular ``is_used``. Gradients reach
  means3d, scales, quats, opacities and shs (or the precomputed colors and
  covariances) through autograd of preprocess; the per-Gaussian reduction
  of the per-slot gradients is the backward of ``_slot_features``.

Known reference behaviour, reproduced on purpose: ``_slot_features`` casts
the whole feature table to bf16 before the gather on the inference path,
including the GLOBAL pixel means x and y, so x in [1024, 2048) lands on a
grid of 8 px (gsplat_tpu/raster/rasterize.py:246-248).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.raster import binning as binning_lib
from gsplat_tpu_torch.raster import project as project_lib
from gsplat_tpu_torch.raster import scan_kernel, tile_kernel


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Static rasterizer configuration. ``k_dup`` is the Gaussian x tile
    duplicate budget; overflow is reported through ``num_dup``.
    ``super_chunks`` is kept so the slot count is aligned as in JAX
    (sentinel chunks pad the total to a multiple of it). ``layout`` is the
    training image's: "hwc" [H, W, 3] or "chw" [3, H, W]."""

    k_dup: int
    tile_x: int = 32
    tile_y: int = 16
    chunk: int = 128
    super_chunks: int = 8
    inference: bool = False
    layout: str = "hwc"


class RasterizeOutput(NamedTuple):
    image: torch.Tensor      # training: [H, W, 3] ("hwc") or [3, H, W]
                             # ("chw") f32 over the background; inference:
                             # [3, H, W] bf16
    radii: torch.Tensor      # [P] int32 (0 => culled)
    is_used: torch.Tensor    # [P] bool: composited into >= 1 pixel
                             # (forward.cu:364); tile-granular (used_tile)
                             # on the inference path
    num_dup: torch.Tensor    # [] int32 true duplicate count (<= k_dup)
    final_t: torch.Tensor    # [H, W] final T (zeros on the inference path)
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


# The per-Gaussian reduction of the per-slot gradients takes the sort +
# compensated cumsum + boundary differences (``_segsum_reduce``) once
# either side is big, else one scatter-add. The thresholds are JAX's,
# measured on a TPU (rasterize.py:100-111); the card's own crossover is
# not measured yet.
_SEGSUM_MIN_SLOTS = 1 << 20
_SCATTER_MAX_ROWS = 250_000


def _segsum_reduce(dfeat, gid, seg_bounds, p1: int):
    """dtable [p1, 9]: row r sums the dfeat columns with gid == r, by one
    sort of gid, a gather of the columns in that order, ``multi_cumsum``
    and differences at the segment bounds (``seg_bounds`` [p1], the first
    sorted slot of each row). Always float32: JAX's bf16 payload packing
    above 2^21 slots (a device of the TPU's sort) is not ported."""
    k = gid.shape[0]
    perm = torch.sort(gid, stable=True).indices
    cs = scan_kernel.multi_cumsum(dfeat.index_select(1, perm).contiguous())
    ct = torch.cat([torch.zeros(dfeat.shape[0], 1, dtype=cs.dtype,
                                device=cs.device), cs], dim=1)  # [9, K+1]
    bounds = torch.cat([seg_bounds.long(), torch.full(
        (1,), k, dtype=torch.long, device=gid.device)])
    ctb = ct.index_select(1, bounds)                             # [9, p1+1]
    return (ctb[:, 1:] - ctb[:, :-1]).t()


def _scatter_reduce(dfeat, gid, p1: int):
    """dtable [p1, 9] by one ``index_add_``. The padding slots (gid ==
    p1 - 1, zero gradient) each go to a spare row of their own past the
    table, because a card serialises atomic adds to one address."""
    k = gid.shape[0]
    pad = gid == p1 - 1
    idx = torch.where(pad, p1 + torch.arange(k, device=gid.device),
                      gid.long())
    out = torch.zeros(p1 + k, dfeat.shape[0], dtype=dfeat.dtype,
                      device=dfeat.device)
    out.index_add_(0, idx, dfeat.t())
    return out[:p1]


class _GatherRowsT(torch.autograd.Function):
    """``table[gid].T`` whose backward is the per-Gaussian reduction
    (JAX's ``_gather_rows_t``), picked statically by size."""

    @staticmethod
    def forward(ctx, table, gid, seg_bounds):
        ctx.save_for_backward(gid, seg_bounds)
        ctx.p1 = table.shape[0]
        return table.t().contiguous().index_select(1, gid.long())

    @staticmethod
    def backward(ctx, dfeat):
        gid, seg_bounds = ctx.saved_tensors
        p1 = ctx.p1
        dfeat = dfeat.contiguous()
        if gid.shape[0] >= _SEGSUM_MIN_SLOTS or p1 > _SCATTER_MAX_ROWS:
            dtable = _segsum_reduce(dfeat, gid, seg_bounds, p1)
        else:
            dtable = _scatter_reduce(dfeat, gid, p1)
        return dtable, None, None


def _slot_features(table, gid, dtype=torch.float32,
                   seg_bounds=None) -> torch.Tensor:
    """[9, K_slots] feature stream from the depth-ordered [P, 9] table.
    The table is cast to ``dtype`` BEFORE the gather, as in JAX (see the
    module docstring); padding slots (gid == P) hit an appended zero row,
    so their alpha is 0. With ``seg_bounds`` (``Binning.seg_bounds``) the
    gather is differentiable (``_GatherRowsT``)."""
    table = torch.cat([table.to(dtype),
                       torch.zeros(1, 9, dtype=dtype, device=table.device)])
    if seg_bounds is None:
        return table.t().contiguous().index_select(1, gid.long())
    return _GatherRowsT.apply(table, gid, seg_bounds)


def rasterize(means3d, scales, quats, opacities, shs, camera: CameraParams,
              sh_degree: int, bg, settings: RasterizeSettings, *,
              colors_precomp=None, cov3d_precomp=None,
              scale_modifier: float = 1.0, alive=None) -> RasterizeOutput:
    """Render Gaussians; differentiable unless ``settings.inference``."""
    s = settings
    height, width = camera.height, camera.width
    grid_x = -(-width // s.tile_x)
    grid_y = -(-height // s.tile_y)
    num_tiles = grid_x * grid_y
    n_pix = s.tile_x * s.tile_y

    proc = project_lib.preprocess(
        means3d, scales, quats, opacities, shs, camera, sh_degree,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
        scale_modifier=scale_modifier, alive=alive)
    # binning is integer bookkeeping: no gradient, except through the
    # feature table it reorders into depth-rank space
    proc_ng = project_lib.Preprocessed(*(t.detach() for t in proc))
    binn = binning_lib.bin_gaussians(
        proc_ng, tile_x=s.tile_x, tile_y=s.tile_y, grid_x=grid_x,
        grid_y=grid_y, k_dup=s.k_dup, chunk=s.chunk, align=s.super_chunks,
        feat_table=_feat_columns(proc))
    bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)

    if s.inference:
        feat = _slot_features(binn.feat_table, binn.gid,
                              dtype=torch.bfloat16)
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

    feat = _slot_features(binn.feat_table, binn.gid,
                          seg_bounds=binn.seg_bounds)
    c_img, t_img, used_slot = tile_kernel.tile_blend(
        feat, binn.chunk_meta, num_tiles, n_pix, s.tile_x, s.tile_y, grid_x,
        s.chunk)

    # pixel-granular is_used (forward.cu:364): any slot of the Gaussian
    # composited a pixel. Slots that did not (padding among them) write to
    # one spare cell with plain stores, which all carry the same value.
    p = binn.order.shape[0]
    hit = used_slot > 0
    used_rank = torch.zeros(p + 2, dtype=torch.bool, device=means3d.device)
    used_rank.index_put_((torch.where(hit, binn.gid.long(),
                                      torch.full_like(binn.gid, p + 1,
                                                      dtype=torch.long)),),
                         hit)
    is_used = used_rank[binn.inv_order.long()]

    color = assemble_tiles(c_img, grid_x, grid_y, s.tile_x, s.tile_y, width,
                           height)
    final_t = assemble_tiles(t_img, grid_x, grid_y, s.tile_x, s.tile_y,
                             width, height)[0]
    image = color + final_t[None] * bg[:, None, None]
    if s.layout == "hwc":
        image = image.permute(1, 2, 0)
    elif s.layout != "chw":
        raise ValueError(f"layout must be 'hwc' or 'chw', got {s.layout!r}")
    return RasterizeOutput(image=image, radii=binn.radius, is_used=is_used,
                           num_dup=binn.num_dup, final_t=final_t,
                           used_tile=binn.used)


def assemble_tiles(img_t, grid_x: int, grid_y: int, tile_x: int,
                   tile_y: int, width: int, height: int) -> torch.Tensor:
    """Channel-major tile buffers [T, ch, n_pix] -> [ch, H, W]."""
    ch = img_t.shape[1]
    img = img_t.reshape(grid_y, grid_x, ch, tile_y, tile_x)
    img = img.permute(2, 0, 3, 1, 4)
    img = img.reshape(ch, grid_y * tile_y, grid_x * tile_x)
    return img[:, :height, :width]
