"""Tile blends (port of gsplat_tpu/raster/tile_kernel.py): the inference
render ``render_forward`` (TPU ``_render_kernel``) and the differentiable
training blend ``tile_blend`` over ``tile_blend_forward`` (TPU
``_fwd_kernel``) and ``tile_blend_backward`` (TPU ``_bwd_kernel``).

Each wrapper takes a CUDA tensor to its hand-written Hopper kernel
(``csrc/render_kernel.cu``, ``csrc/blend_kernels.cu``; both cull exactly
by the rule in ``csrc/tile_common.cuh``) and adds one to its ``launches``
count, and a CPU tensor to the plain PyTorch version beside it. The
kernels take every tile and chunk size the plain versions take: larger
tiles run in groups of pixels, larger chunks in pieces.

``render_forward`` (tile_kernel.py:816-897): per tile, chunks front to
back; alpha = min(ALPHA_MAX, opa * e^power), 0 where power > 0 or
alpha < ALPHA_MIN; no per-pixel stop rule; after each chunk the tile stops
once every pixel has T <= T_EPS; the background is composited in; tiles
without chunks are background.

The training blend (tile_kernel.py:74-85, 266-304, 593-646) keeps the CUDA
stop rule: a contribution composites only while T * (1 - alpha) >= T_EPS
and the pixel is not done; the first violator is dropped and latches the
pixel done, and T freezes. T is the sequential float32 product in the
kernels and in the plain versions. The forward returns ``ct``
[T, 4, n_pix] (rows 0-2 color without background, row 3 final T) and the
per-slot count of composited pixels ``used``; the backward re-runs it and
returns per-slot ``dfeat`` [9, K] (no per-Gaussian reduction).

Feature rows of ``feat`` [9, K_slots]: global pixel mean (x, y), conic
(a, b, c), opacity, rgb. ``chunk_meta`` packs ``tile << 2 | first << 1 |
last`` per chunk; tile ids ascend along it and sentinel chunks carry
``num_tiles``.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.raster import cuda_ext

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

NUM_FEAT = 9


def _tile_chunk_ranges(chunk_meta: torch.Tensor, num_tiles: int):
    """[num_tiles] first chunk index and chunk count of each tile."""
    tile_of_chunk = (chunk_meta >> 2).contiguous()
    tiles = torch.arange(num_tiles, dtype=chunk_meta.dtype,
                         device=chunk_meta.device)
    first = torch.searchsorted(tile_of_chunk, tiles)
    end = torch.searchsorted(tile_of_chunk, tiles, right=True)
    return first, end - first


def render_plain_with_visits(feat, chunk_meta, bg, num_tiles: int,
                             n_pix: int, tile_x: int, tile_y: int,
                             grid_x: int, chunk: int, stats=None):
    """Plain PyTorch render; also returns each tile's count of visited
    chunks (the work the tile-wide stop leaves). ``feat`` may be bf16 or
    float32; compositing is float32, sequential in slot order. A ``stats``
    dict receives the visited chunk indices and the (pixel, slot) pairs of
    the visited chunks that pass alpha >= 1/255."""
    dev = feat.device
    f = feat.float().reshape(NUM_FEAT, -1, chunk)       # [9, n_chunks, C]
    first, n_ch = _tile_chunk_ranges(chunk_meta, num_tiles)
    pix = torch.arange(n_pix, device=dev)
    px = (pix % tile_x).float()
    py = torch.div(pix, tile_x, rounding_mode="floor").float()
    tiles = torch.arange(num_tiles, device=dev)
    ox = ((tiles % grid_x) * tile_x).float()
    oy = (torch.div(tiles, grid_x, rounding_mode="floor") * tile_y).float()
    acc = torch.zeros(num_tiles, 3, n_pix, dtype=torch.float32, device=dev)
    trans = torch.ones(num_tiles, n_pix, dtype=torch.float32, device=dev)
    live = n_ch > 0
    visits = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    # bound the [tiles, C, n_pix] temporaries to ~2^26 elements
    group = max(1, (1 << 26) // (chunk * n_pix))
    for j in range(int(n_ch.max()) if num_tiles else 0):
        idx_all = torch.nonzero(live & (j < n_ch)).flatten()
        for s in range(0, idx_all.numel(), group):
            idx = idx_all[s:s + group]
            fc = f[:, first[idx] + j, :]                   # [9, A, C]
            x = fc[0] - ox[idx, None]
            y = fc[1] - oy[idx, None]
            dx = px[None, None, :] - x[:, :, None]         # [A, C, n_pix]
            dy = py[None, None, :] - y[:, :, None]
            a, b, c = (fc[i][:, :, None] for i in (2, 3, 4))
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = torch.clamp(fc[5][:, :, None] * torch.exp(power),
                                max=ALPHA_MAX)
            alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN),
                                torch.zeros_like(alpha), alpha)
            if stats is not None:
                stats["passing"] = stats.get("passing", 0) + int(
                    (alpha > 0).sum())
                stats.setdefault("visited", []).append(first[idx] + j)
            t_in = trans[idx]                               # [A, n_pix]
            t_incl = t_in[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
            t_excl = torch.cat([t_in[:, None, :], t_incl[:, :-1]], dim=1)
            w = alpha * t_excl
            acc[idx] += torch.einsum("kac,acp->akp", fc[6:9], w)
            t_new = t_incl[:, -1]
            trans[idx] = t_new
            visits[idx] += 1
            live[idx] = t_new.amax(dim=1) > T_EPS
    img = acc + trans[:, None, :] * bg.float()[None, :, None]
    return img.to(torch.bfloat16), visits


def render_forward_plain(feat, chunk_meta, bg, num_tiles: int, n_pix: int,
                         tile_x: int, tile_y: int, grid_x: int, chunk: int):
    """Plain PyTorch version of ``render_forward``."""
    return render_plain_with_visits(feat, chunk_meta, bg, num_tiles, n_pix,
                                    tile_x, tile_y, grid_x, chunk)[0]


def _check_blend_args(feat, chunk_meta, n_pix: int, tile_x: int,
                      tile_y: int, chunk: int, **others) -> None:
    """Input checks shared by the render and the training blend wrappers;
    ``others`` are further tensors that must share ``feat``'s device."""
    device = feat.device
    if feat.dim() != 2 or feat.shape[0] != NUM_FEAT:
        raise ValueError(f"feat must be [9, K], got {tuple(feat.shape)}")
    if feat.shape[1] % chunk or chunk_meta.shape != (feat.shape[1] // chunk,):
        raise ValueError(f"chunk_meta {tuple(chunk_meta.shape)} does not "
                         f"match feat {tuple(feat.shape)} / chunk {chunk}")
    if n_pix != tile_x * tile_y:
        raise ValueError(f"n_pix {n_pix} != {tile_x} x {tile_y}")
    for name, t in (("chunk_meta", chunk_meta), *others.items()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if chunk_meta.dtype != torch.int32:
        raise ValueError("chunk_meta must be int32")


def render_forward(feat, chunk_meta, bg, num_tiles: int, n_pix: int,
                   tile_x: int, tile_y: int, grid_x: int, chunk: int):
    """Render-only tile blend: bf16 [num_tiles, 3, n_pix] over ``bg``."""
    device = feat.device
    _check_blend_args(feat, chunk_meta, n_pix, tile_x, tile_y, chunk, bg=bg)
    if bg.shape != (3,):
        raise ValueError("bg must be [3]")
    if device.type == "cpu":
        return render_forward_plain(feat, chunk_meta, bg, num_tiles, n_pix,
                                    tile_x, tile_y, grid_x, chunk)
    if feat.dtype != torch.bfloat16 or not feat.is_contiguous():
        raise ValueError("the CUDA render takes a contiguous bf16 feat")
    if not chunk_meta.is_contiguous():
        raise ValueError("chunk_meta must be contiguous")
    ext = cuda_ext.load()
    out = torch.empty(num_tiles, 3, n_pix, dtype=torch.bfloat16,
                      device=device)
    # tiles of more than 4,096 pixels keep each pixel group's state between
    # its own stop and the tile's (render_kernel.cu)
    scratch = torch.empty(ext.render_scratch_floats(num_tiles, n_pix, tile_x,
                                                    tile_y),
                          dtype=torch.float32, device=device)
    ext.render_forward(feat, chunk_meta, bg.float().contiguous(), out,
                       scratch, n_pix, tile_x, tile_y, grid_x, chunk)
    render_forward.launches += 1
    return out


render_forward.launches = 0


# ------------------------------------------------------- training blend ----

def _blend_chunk(fc, ox, oy, px, py, t_in, done_in, count_pairs=False):
    """Training-blend math of one chunk for a group of tiles, as the
    kernels do it: ``fc`` [9, A, C] raw features, ``ox``/``oy`` [A] tile
    origins, ``px``/``py`` [n_pix] local pixel coordinates, ``t_in`` [A,
    n_pix] carried T and ``done_in`` [A, n_pix] latches. Returns the
    per-(tile, slot, pixel) arrays and the carried state after the chunk.
    The quadratic form and T follow the kernels' operation order, so both
    take the same threshold branches. With ``count_pairs`` it also counts
    the (pixel, slot) pairs whose pixel is not done (the work of a kernel
    without culling) and, of those, the pairs that pass alpha >= 1/255."""
    x = fc[0] - ox[:, None]
    y = fc[1] - oy[:, None]
    dx = px[None, None, :] - x[:, :, None]                  # [A, C, n_pix]
    dy = py[None, None, :] - y[:, :, None]
    a, b, c = (fc[i][:, :, None] for i in (2, 3, 4))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    g_exp = torch.exp(power)
    alpha = torch.clamp(fc[5][:, :, None] * g_exp, max=ALPHA_MAX)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN),
                        torch.zeros_like(alpha), alpha)
    one_m = 1.0 - alpha
    t_g = torch.empty_like(alpha)     # T before each slot
    gate = torch.empty(alpha.shape, dtype=torch.bool, device=alpha.device)
    t, done = t_in, done_in
    live_pairs = torch.zeros((), dtype=torch.int64, device=alpha.device)
    passing_pairs = torch.zeros_like(live_pairs)
    for g in range(alpha.shape[1]):   # the sequential T product
        t_g[:, g] = t
        t_next = t * one_m[:, g]
        live = (alpha[:, g] > 0.0) & ~done
        if count_pairs:
            live_pairs += (~done).sum()
            passing_pairs += live.sum()
        stop = live & (t_next < T_EPS)
        gate[:, g] = live & ~stop
        t = torch.where(gate[:, g], t_next, t)
        done = done | stop
    return dict(dx=dx, dy=dy, g_exp=g_exp, alpha=alpha, one_m=one_m,
                t_g=t_g, gate=gate, t=t, done=done, live_pairs=live_pairs,
                passing_pairs=passing_pairs)


def _blend_plain(feat, chunk_meta, num_tiles, n_pix, tile_x, tile_y, grid_x,
                 chunk, dpack=None, stats=None):
    """Shared walk of the plain training blends: the forward when
    ``dpack`` is None, else the backward. A ``stats`` dict receives the
    visited chunk count and indices, the live (pixel, slot) pairs and the
    pairs that pass alpha >= 1/255."""
    dev = feat.device
    f = feat.reshape(NUM_FEAT, -1, chunk)                   # [9, n_chunks, C]
    first, n_ch = _tile_chunk_ranges(chunk_meta, num_tiles)
    pix = torch.arange(n_pix, device=dev)
    px = (pix % tile_x).float()
    py = torch.div(pix, tile_x, rounding_mode="floor").float()
    tiles = torch.arange(num_tiles, device=dev)
    ox = ((tiles % grid_x) * tile_x).float()
    oy = (torch.div(tiles, grid_x, rounding_mode="floor") * tile_y).float()
    acc = torch.zeros(num_tiles, 3, n_pix, dtype=torch.float32, device=dev)
    trans = torch.ones(num_tiles, n_pix, dtype=torch.float32, device=dev)
    done = torch.zeros(num_tiles, n_pix, dtype=torch.bool, device=dev)
    used = torch.zeros(feat.shape[1], dtype=torch.int32, device=dev)
    dfeat = None if dpack is None else torch.zeros_like(feat)
    run = torch.zeros(num_tiles, n_pix, dtype=torch.float32, device=dev)
    live_tile = n_ch > 0
    # bound the [tiles, C, n_pix] temporaries to ~2^24 elements
    group = max(1, (1 << 24) // (chunk * n_pix))
    for j in range(int(n_ch.max()) if num_tiles else 0):
        idx_all = torch.nonzero(live_tile & (j < n_ch)).flatten()
        for s in range(0, idx_all.numel(), group):
            idx = idx_all[s:s + group]
            cidx = first[idx] + j                            # chunk per tile
            fc = f[:, cidx, :]                               # [9, A, C]
            v = _blend_chunk(fc, ox[idx], oy[idx], px, py, trans[idx],
                             done[idx], count_pairs=stats is not None)
            if stats is not None:
                stats["chunks"] = stats.get("chunks", 0) + idx.numel()
                stats["pairs"] = stats.get("pairs", 0) + int(
                    v["live_pairs"])
                stats["passing"] = stats.get("passing", 0) + int(
                    v["passing_pairs"])
                stats.setdefault("visited", []).append(cidx)
            w = v["alpha"] * v["t_g"] * v["gate"]
            slots = (cidx[:, None] * chunk
                     + torch.arange(chunk, device=dev)[None, :]).flatten()
            if dpack is None:
                acc[idx] += torch.einsum("kac,acp->akp", fc[6:9], w)
                used[slots] = v["gate"].sum(dim=2, dtype=torch.int32
                                            ).flatten()
            else:
                dc = dpack[idx, 0:3]                         # [A, 3, n_pix]
                a_pg = torch.einsum("kac,akp->acp", fc[6:9], dc)
                cum = run[idx][:, None, :] + torch.cumsum(a_pg * w, dim=1)
                s_suf = dpack[idx, 3][:, None, :] - cum
                dalpha = torch.where(
                    v["gate"], a_pg * v["t_g"] - s_suf / v["one_m"],
                    torch.zeros_like(w))
                de = dalpha * v["g_exp"]
                dpow = de * fc[5][:, :, None]
                dx, dy = v["dx"], v["dy"]
                a, b, c = (fc[i][:, :, None] for i in (2, 3, 4))
                rows = [dpow * (a * dx + b * dy), dpow * (c * dy + b * dx),
                        -0.5 * dpow * dx * dx, -dpow * dx * dy,
                        -0.5 * dpow * dy * dy, de]
                d = torch.stack([r.sum(dim=2) for r in rows]
                                + [torch.einsum("akp,acp->kac", dc, w)[k]
                                   for k in range(3)])       # [9, A, C]
                dfeat[:, slots] = d.reshape(NUM_FEAT, -1)
                run[idx] = cum[:, -1]
            trans[idx] = v["t"]
            done[idx] = v["done"]
            live_tile[idx] = ~v["done"].all(dim=1)
    if dpack is not None:
        return dfeat
    ct = torch.cat([acc, trans[:, None, :]], dim=1)
    return ct, used


def tile_blend_forward_plain(feat, chunk_meta, num_tiles: int, n_pix: int,
                             tile_x: int, tile_y: int, grid_x: int,
                             chunk: int):
    """Plain PyTorch version of ``tile_blend_forward``."""
    return _blend_plain(feat, chunk_meta, num_tiles, n_pix, tile_x, tile_y,
                        grid_x, chunk)


def tile_blend_backward_plain(feat, chunk_meta, dpack, num_tiles: int,
                              n_pix: int, tile_x: int, tile_y: int,
                              grid_x: int, chunk: int):
    """Plain PyTorch version of ``tile_blend_backward``."""
    return _blend_plain(feat, chunk_meta, num_tiles, n_pix, tile_x, tile_y,
                        grid_x, chunk, dpack=dpack)


# The tile kernels' cull rule and warp geometry (the render and both
# blends), transcribed from csrc/tile_common.cuh (cull_extent, meets, kPix,
# kDetSlack, kR2Slack, kExtSlack) for the tests and chip_smoke.py's cull
# statistics; no path runs them, and they change with the kernels' rule.
BLEND_SUB_BLOCK = (8, 4)    # the pixels a warp's 8 x 4 lanes hold at once
BLEND_WARP_BLOCK = (16, 8)  # a warp's pixels: four a thread, 2 x 2 sub-blocks
BLEND_CULL_SLACK = (1e-5, 1e-5, 1e-4)   # on det, r^2 and the extents


def blend_cull_extent(a, b, c, opa):
    """Half extents (hx, hy) of the box around a slot's mean outside which
    no pixel passes alpha >= ALPHA_MIN: -1 where none can (opa <
    ALPHA_MIN), inf where the conic is not positive definite (never
    culled). float32 tensors, broadcast."""
    det_s, r2_s, ext_s = BLEND_CULL_SLACK
    ac = a * c
    det = ac - b * b - det_s * ac
    pd = (a > 0) & (c > 0) & (det > 0)
    r2 = torch.clamp(2.0 * torch.log(255.0 * opa), min=0.0) * (1 + r2_s) + r2_s
    det = torch.where(pd, det, torch.ones_like(det))
    inf = torch.full_like(ac, float("inf"))
    hx = torch.where(pd, torch.sqrt(r2 * c / det) * (1 + ext_s), inf)
    hy = torch.where(pd, torch.sqrt(r2 * a / det) * (1 + ext_s), inf)
    drop = opa < ALPHA_MIN
    return hx.masked_fill(drop, -1.0), hy.masked_fill(drop, -1.0)


def blend_cull_meets(xl, yl, hx, hy, x0, x1, y0, y1):
    """May a pixel of [x0, x1] x [y0, y1] (tile coordinates) pass for a
    slot at tile-local mean (xl, yl) with half extents (hx, hy)? False only
    when none can; NaN extents keep the slot. Broadcast."""
    return ~((hx < 0) | (x0 - xl > hx) | (x1 - xl < -hx)
             | (y0 - yl > hy) | (y1 - yl < -hy))


def _check_blend_cuda(feat, chunk_meta, *others) -> None:
    if feat.dtype != torch.float32 or not all(
            t.is_contiguous() for t in (feat, chunk_meta, *others)):
        raise ValueError("the CUDA blend takes contiguous float32 tensors")


def tile_blend_forward(feat, chunk_meta, num_tiles: int, n_pix: int,
                       tile_x: int, tile_y: int, grid_x: int, chunk: int):
    """Training blend forward: (ct [num_tiles, 4, n_pix] float32 — rows 0-2
    premultiplied color without background, row 3 final T — and
    used [K] int32, the pixels each slot composited into)."""
    _check_blend_args(feat, chunk_meta, n_pix, tile_x, tile_y, chunk)
    if feat.device.type == "cpu":
        return tile_blend_forward_plain(feat.float(), chunk_meta, num_tiles,
                                        n_pix, tile_x, tile_y, grid_x, chunk)
    _check_blend_cuda(feat, chunk_meta)
    ct = torch.empty(num_tiles, 4, n_pix, dtype=torch.float32,
                     device=feat.device)
    used = torch.zeros(feat.shape[1], dtype=torch.int32, device=feat.device)
    cuda_ext.load().blend_forward(feat, chunk_meta, ct, used, n_pix, tile_x,
                                  tile_y, grid_x, chunk)
    tile_blend_forward.launches += 1
    return ct, used


tile_blend_forward.launches = 0


def tile_blend_backward(feat, chunk_meta, dpack, num_tiles: int, n_pix: int,
                        tile_x: int, tile_y: int, grid_x: int, chunk: int):
    """Training blend backward: per-slot dfeat [9, K] float32 from
    ``dpack`` [num_tiles, 4, n_pix] (rows 0-2 dC, row 3
    D = <dC, C> + dT * T per pixel)."""
    _check_blend_args(feat, chunk_meta, n_pix, tile_x, tile_y, chunk,
                      dpack=dpack)
    if dpack.shape != (num_tiles, 4, n_pix):
        raise ValueError(f"dpack must be [{num_tiles}, 4, {n_pix}], got "
                         f"{tuple(dpack.shape)}")
    if feat.device.type == "cpu":
        return tile_blend_backward_plain(feat.float(), chunk_meta,
                                         dpack.float(), num_tiles, n_pix,
                                         tile_x, tile_y, grid_x, chunk)
    _check_blend_cuda(feat, chunk_meta, dpack)
    dfeat = torch.zeros_like(feat)
    cuda_ext.load().blend_backward(feat, chunk_meta, dpack, dfeat, n_pix,
                                   tile_x, tile_y, grid_x, chunk)
    tile_blend_backward.launches += 1
    return dfeat


tile_blend_backward.launches = 0


class TileBlend(torch.autograd.Function):
    """Differentiable training blend (JAX's ``_tile_blend_packed`` custom
    VJP): feat -> (ct, used); ``used`` is integer bookkeeping."""

    @staticmethod
    def forward(ctx, feat, chunk_meta, num_tiles, n_pix, tile_x, tile_y,
                grid_x, chunk):
        ct, used = tile_blend_forward(feat, chunk_meta, num_tiles, n_pix,
                                      tile_x, tile_y, grid_x, chunk)
        ctx.save_for_backward(feat, chunk_meta, ct)
        ctx.static = (num_tiles, n_pix, tile_x, tile_y, grid_x, chunk)
        ctx.mark_non_differentiable(used)
        return ct, used

    @staticmethod
    def backward(ctx, dct, _dused):
        feat, chunk_meta, ct = ctx.saved_tensors
        # the per-pixel total downstream dot D = <dC, C> + dT * T
        d_tot = ((dct[:, 0:3] * ct[:, 0:3]).sum(dim=1, keepdim=True)
                 + dct[:, 3:4] * ct[:, 3:4])
        dpack = torch.cat([dct[:, 0:3], d_tot], dim=1).contiguous()
        dfeat = tile_blend_backward(feat, chunk_meta, dpack, *ctx.static)
        return (dfeat,) + (None,) * 7


def tile_blend(feat, chunk_meta, num_tiles: int, n_pix: int, tile_x: int,
               tile_y: int, grid_x: int, chunk: int):
    """(color [T, 3, n_pix] premultiplied without background,
    transmittance [T, 1, n_pix], used [K] int32) — differentiable in
    ``feat``."""
    ct, used = TileBlend.apply(feat, chunk_meta, num_tiles, n_pix, tile_x,
                               tile_y, grid_x, chunk)
    return ct[:, 0:3], ct[:, 3:4], used
