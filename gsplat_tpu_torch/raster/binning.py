"""Depth-ordered tile binning with a static slot budget (port of
gsplat_tpu/raster/binning.py, forward only).

Same bookkeeping as the JAX module, so both produce bit-equal slot lists
from the same ``Preprocessed``:

- binning rects are the reference 3-sigma circle rect intersected with the
  AABB of the alpha >= 1/255 conic ellipse;
- rect fields (min_x, min_y, w, h) ride one int32, reordered by a depth
  sort on (depth, index) — ``torch.sort(stable=True)`` gives the index as
  the secondary key, so the order is deterministic (the JAX sort is not
  stable; only the active prefix of ``order`` is comparable);
- slot -> owning Gaussian via one of two expansion kernels picked
  statically: the scatter-max of range markers + ``expand_scan`` when
  ``2 * k_dup >= 7 * P``, else ``merge_expand``;
- per-tile counts are an exact integer 2-D difference-array count (the
  TPU's 0/1 coverage matmul has no counterpart on the card);
- one int64 sort of (tile << rank_bits | depth rank) orders the slots;
  each non-empty tile's list is padded to a chunk multiple, and sentinel
  chunks (tile id == num_tiles) align the total to ``align`` chunks;
- ``chunk_meta`` packs ``tile << 2 | first << 1 | last`` per chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.raster.project import Preprocessed, tile_rect
from gsplat_tpu_torch.raster.scan_kernel import expand_scan, merge_expand

_I32 = torch.int32


class Binning(NamedTuple):
    gid: torch.Tensor          # [K_slots] int32 depth-rank id per slot; P = pad
    order: torch.Tensor        # [P] int32 depth rank -> original id
    inv_order: torch.Tensor    # [P] int32 original id -> depth rank
    tile_of_slot: torch.Tensor  # [K_slots] int32 tile id (clamped)
    chunk_meta: torch.Tensor   # [K_slots/chunk] int32 tile<<2|first<<1|last
    tile_len: torch.Tensor     # [T] int32 rect duplicates per tile
    num_dup: torch.Tensor      # [] int32 true duplicate count
    radius: torch.Tensor       # [P] int32, empty-rect Gaussians zeroed
    used: torch.Tensor         # [P] bool, >= 1 surviving duplicate
    seg_bounds: torch.Tensor   # [P+1] int32 segment starts in slot order
    feat_table: Optional[torch.Tensor] = None  # [P, F] in depth-rank order


def num_slots(k_dup: int, num_tiles: int, chunk: int) -> int:
    """Static padded slot count: budget + one pad chunk per tile."""
    return (-(-k_dup // chunk)) * chunk + num_tiles * chunk


def _tile_histogram(min_x, min_y, max_x, max_y, active, grid_x, grid_y):
    """Exact per-tile rect-coverage counts: +1/-1 at the four rect corners
    of a (grid_y+1, grid_x+1) difference grid, then 2-D prefix sums.
    Inactive rows add nothing; each goes to a scratch cell of its own past
    the grid, because a card serialises atomic adds to one address (the
    padding rows of a 1M-capacity state sent to a single cell cost
    2.7 ms/frame on an H100)."""
    dev = min_x.device
    w1 = grid_x + 1
    cells = (grid_y + 1) * w1
    diff = torch.zeros(cells + min_x.shape[0], dtype=_I32, device=dev)
    spare = cells + torch.arange(min_x.shape[0], device=dev)
    idx = torch.cat([torch.where(active, (ys * w1 + xs).long(), spare)
                     for ys, xs in ((min_y, min_x), (min_y, max_x),
                                    (max_y, min_x), (max_y, max_x))])
    one = active.to(_I32)
    diff.index_add_(0, idx, torch.cat([one, -one, -one, one]))
    grid = diff[:cells].view(grid_y + 1, w1).cumsum(0, dtype=_I32).cumsum(
        1, dtype=_I32)
    return grid[:grid_y, :grid_x].reshape(-1)


def bin_gaussians(proc: Preprocessed, *, tile_x: int, tile_y: int,
                  grid_x: int, grid_y: int, k_dup: int, chunk: int = 128,
                  align: int = 1, feat_table=None) -> Binning:
    """Expand visible Gaussians into depth-sorted, chunk-padded per-tile
    slot lists; ``feat_table`` [P, F] rows are returned in depth-rank
    order as ``Binning.feat_table``."""
    p = proc.xy.shape[0]
    dev = proc.xy.device
    num_tiles = grid_x * grid_y

    # rect = reference circle rect ∩ conservative alpha-ellipse AABB rect
    rmin_x, rmin_y, rmax_x, rmax_y = tile_rect(
        proc.xy, proc.radius, tile_x, tile_y, grid_x, grid_y)
    conic = proc.conic
    det_con = conic[:, 0] * conic[:, 2] - conic[:, 1] ** 2
    det_safe = torch.clamp(det_con, min=1e-24)
    sigma_xx = conic[:, 2] / det_safe
    sigma_yy = conic[:, 0] / det_safe
    r_a2 = 2.0 * torch.log(torch.clamp(255.0 * proc.opacity, min=1e-12))
    r_a2 = torch.clamp(r_a2, min=0.0)
    ex = torch.sqrt(r_a2 * torch.clamp(sigma_xx, min=0.0))
    ey = torch.sqrt(r_a2 * torch.clamp(sigma_yy, min=0.0))
    gx_, gy_ = proc.xy[:, 0], proc.xy[:, 1]

    def cell(v, n):
        return torch.clamp(v, 0, n).to(_I32)

    emin_x = cell(torch.floor((gx_ - ex) / tile_x), grid_x)
    emax_x = cell(torch.floor((gx_ + ex) / tile_x) + 1, grid_x)
    emin_y = cell(torch.floor((gy_ - ey) / tile_y), grid_y)
    emax_y = cell(torch.floor((gy_ + ey) / tile_y) + 1, grid_y)
    min_x = torch.maximum(rmin_x, emin_x)
    max_x = torch.minimum(rmax_x, emax_x)
    min_y = torch.maximum(rmin_y, emin_y)
    max_y = torch.minimum(rmax_y, emax_y)
    w_rect = torch.clamp(max_x - min_x, min=0)
    h_rect = torch.clamp(max_y - min_y, min=0)
    ok_opa = proc.opacity >= 1.0 / 255.0

    xb = max(int(grid_x).bit_length(), 1)    # holds 0..grid_x inclusive
    yb = max(int(grid_y).bit_length(), 1)
    if 2 * (xb + yb) > 31:
        raise ValueError(f"rect pack overflow: grid {grid_x}x{grid_y}")
    active = proc.visible & ok_opa & (w_rect > 0) & (h_rect > 0)
    zero = torch.zeros_like(w_rect)
    w_m = torch.where(active, w_rect, zero)
    h_m = torch.where(active, h_rect, zero)
    rect_all = ((min_x << (yb + xb + yb)) | (min_y << (xb + yb))
                | (w_m << yb) | h_m)

    # ---- depth pre-sort: all later work happens in depth-rank space ----
    depth_key = torch.where(active, proc.depth,
                            torch.full_like(proc.depth, float("inf")))
    order64 = torch.sort(depth_key, stable=True).indices
    order = order64.to(_I32)
    iota_p = torch.arange(p, dtype=_I32, device=dev)
    inv_order = torch.empty_like(order)
    inv_order[order64] = iota_p
    rect_all_d = rect_all[order64]
    feat_table_d = None if feat_table is None else feat_table[order64]
    minx_o = rect_all_d >> (yb + xb + yb)
    miny_o = (rect_all_d >> (xb + yb)) & ((1 << yb) - 1)
    w_o = (rect_all_d >> yb) & ((1 << xb) - 1)
    h_o = rect_all_d & ((1 << yb) - 1)
    counts = w_o * h_o
    # radii keep the reference 3-sigma semantics (forward.cu:251)
    ref_rect = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    radius = torch.where(proc.visible & (ref_rect > 0), proc.radius,
                         torch.zeros_like(proc.radius))

    offsets = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                         torch.cumsum(counts, 0, dtype=_I32)])
    num_dup = offsets[-1]

    # --- duplicate expansion: slot -> owning Gaussian ---
    starts = offsets[:p].contiguous()
    d = torch.arange(k_dup, dtype=_I32, device=dev)
    # marker bit on top keeps the pack nonzero for a (0, 0) rect corner
    pack = ((1 << (2 * xb + yb)) | (minx_o << (xb + yb))
            | (miny_o << xb) | w_o)
    if 2 * k_dup < 7 * p:
        pack_d, base_of_d, rank_d = merge_expand(starts, pack, k_dup)
    else:
        # rows owning no slot below the budget each land in a spare cell of
        # their own, cut off again (the JAX scatter's mode="drop"; a shared
        # cell would serialise their atomics). That also leaves slot
        # num_dup unmarked, which only changes slots that are masked out
        # below. The zero fill loses every max: packs carry the marker bit.
        owns = (counts > 0) & (starts < k_dup)
        idx = torch.where(owns, starts.long(),
                          k_dup + torch.arange(p, device=dev))
        marked = torch.zeros(k_dup + p, dtype=_I32, device=dev)
        marked = marked.scatter_reduce(0, idx, pack, reduce="amax")[:k_dup]
        base_in = torch.where(marked > 0, d, torch.zeros_like(d))
        pack_d, base_of_d, rank_d = expand_scan(marked, base_in)
    g_of_d = rank_d - 1
    minx_dd = (pack_d >> (xb + yb)) & ((1 << xb) - 1)
    miny_dd = (pack_d >> xb) & ((1 << yb) - 1)
    w_d = pack_d & ((1 << xb) - 1)
    r = d - base_of_d
    w_dd = torch.clamp(w_d, min=1)
    tx = minx_dd + r % w_dd
    ty = miny_dd + r // w_dd
    tile_id = ty * grid_x + tx

    # a slot is real iff its Gaussian's whole rect fits the budget
    k_t = torch.tensor([k_dup], dtype=_I32, device=dev)
    dup_limit = offsets[torch.searchsorted(offsets, k_t, right=True) - 1]
    in_budget = d < torch.minimum(dup_limit, num_dup)
    dup_key = torch.where(in_budget, tile_id,
                          torch.full_like(tile_id, num_tiles))
    dup_rank = torch.where(in_budget, g_of_d, torch.full_like(g_of_d, p))

    # --- per-tile pad candidates so sorted order is chunk-aligned ---
    fits = (counts > 0) & (offsets[:p] + counts <= k_dup)
    len_t = _tile_histogram(minx_o, miny_o, minx_o + w_o, miny_o + h_o,
                            fits, grid_x, grid_y)
    pads_t = torch.where(len_t > 0, (-(-len_t // chunk)) * chunk - len_t,
                         torch.zeros_like(len_t))
    tile_ids_2d = torch.arange(num_tiles, dtype=_I32, device=dev)[:, None]
    pad_valid_2d = (torch.arange(chunk, dtype=_I32, device=dev)[None, :]
                    < pads_t[:, None])
    pad_key = torch.where(pad_valid_2d, tile_ids_2d,
                          torch.full_like(tile_ids_2d, num_tiles)).reshape(-1)

    k_aligned = (-(-k_dup // chunk)) * chunk
    total = k_aligned + num_tiles * chunk
    tail_pad = (-total) % (chunk * align)  # sentinel chunks to align total
    def sentinel(n):
        return torch.full((n,), num_tiles, dtype=_I32, device=dev)

    all_keys = torch.cat([dup_key, sentinel(k_aligned - k_dup), pad_key,
                          sentinel(tail_pad)])
    all_rank = torch.cat([dup_rank, torch.full(
        (total - k_dup + tail_pad,), p, dtype=_I32, device=dev)])

    # one sort of (tile, depth rank): within a tile, slots stay in depth
    # order; pads (rank P) sort behind their tile's real slots
    rank_bits = max(int(p).bit_length(), 1)  # holds 0..p inclusive
    packed = (all_keys.long() << rank_bits) | all_rank.long()
    packed = torch.sort(packed).values
    key_sorted = (packed >> rank_bits).to(_I32)
    gid_sorted = (packed & ((1 << rank_bits) - 1)).to(_I32)

    tile_of_slot = torch.clamp(key_sorted, max=num_tiles - 1)
    chunk_tile = key_sorted[::chunk]
    change = (chunk_tile[1:] != chunk_tile[:-1]).to(_I32)
    one = torch.ones(1, dtype=_I32, device=dev)
    chunk_first = torch.cat([one, change])
    chunk_last = torch.cat([change, one])
    chunk_meta = (chunk_tile << 2) | (chunk_first << 1) | chunk_last

    used = fits[inv_order.long()]
    seg_bounds = torch.cat([
        torch.zeros(1, dtype=_I32, device=dev),
        torch.cumsum(torch.where(fits, counts, torch.zeros_like(counts)), 0,
                     dtype=_I32)])

    return Binning(gid=gid_sorted, order=order, inv_order=inv_order,
                   tile_of_slot=tile_of_slot, chunk_meta=chunk_meta,
                   tile_len=len_t, num_dup=num_dup, radius=radius, used=used,
                   seg_bounds=seg_bounds, feat_table=feat_table_d)
