"""Inference tile render (port of gsplat_tpu/raster/tile_kernel.py:
``render_forward``, which launches ``_render_kernel``).

``render_forward`` is a wrapper: a CUDA tensor launches the hand-written
Hopper kernel in ``csrc/render_kernel.cu`` (and adds one to
``render_forward.launches``), a CPU tensor takes the plain PyTorch version
beside it. Semantics (tile_kernel.py:816-897): per tile, chunks front to
back; alpha = min(ALPHA_MAX, opa * e^power), 0 where power > 0 or
alpha < ALPHA_MIN; no per-pixel stop rule; after each chunk the tile stops
once every pixel has T <= T_EPS; the background is composited in; tiles
without chunks are background.

Feature rows of ``feat`` [9, K_slots]: global pixel mean (x, y), conic
(a, b, c), opacity, rgb. ``chunk_meta`` packs ``tile << 2 | first << 1 |
last`` per chunk; tile ids ascend along it and sentinel chunks carry
``num_tiles``. The training kernels (``_fwd_kernel``, ``_bwd_kernel``)
belong to the training slice.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.raster import cuda_ext

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

NUM_FEAT = 9
MAX_CHUNK = 256     # shared-memory staging limit of the CUDA kernel
MAX_PIXELS = 4096   # 1024 threads x 4 pixels per tile


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
                             grid_x: int, chunk: int):
    """Plain PyTorch render; also returns each tile's count of visited
    chunks (the work the tile-wide stop leaves). ``feat`` may be bf16 or
    float32; compositing is float32, sequential in slot order."""
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


def render_forward(feat, chunk_meta, bg, num_tiles: int, n_pix: int,
                   tile_x: int, tile_y: int, grid_x: int, chunk: int):
    """Render-only tile blend: bf16 [num_tiles, 3, n_pix] over ``bg``."""
    device = feat.device
    if feat.dim() != 2 or feat.shape[0] != NUM_FEAT:
        raise ValueError(f"feat must be [9, K], got {tuple(feat.shape)}")
    if feat.shape[1] % chunk or chunk_meta.shape != (feat.shape[1] // chunk,):
        raise ValueError(f"chunk_meta {tuple(chunk_meta.shape)} does not "
                         f"match feat {tuple(feat.shape)} / chunk {chunk}")
    if n_pix != tile_x * tile_y:
        raise ValueError(f"n_pix {n_pix} != {tile_x} x {tile_y}")
    for name, t in (("chunk_meta", chunk_meta), ("bg", bg)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if chunk_meta.dtype != torch.int32 or bg.shape != (3,):
        raise ValueError("chunk_meta must be int32 and bg [3]")
    if device.type == "cpu":
        return render_forward_plain(feat, chunk_meta, bg, num_tiles, n_pix,
                                    tile_x, tile_y, grid_x, chunk)
    if feat.dtype != torch.bfloat16 or not feat.is_contiguous():
        raise ValueError("the CUDA render takes a contiguous bf16 feat")
    if not chunk_meta.is_contiguous():
        raise ValueError("chunk_meta must be contiguous")
    if chunk > MAX_CHUNK or n_pix > MAX_PIXELS:
        raise ValueError(f"CUDA render supports chunk <= {MAX_CHUNK} and "
                         f"tiles of <= {MAX_PIXELS} pixels")
    out = torch.empty(num_tiles, 3, n_pix, dtype=torch.bfloat16,
                      device=device)
    cuda_ext.load().render_forward(feat, chunk_meta,
                                   bg.float().contiguous(), out, n_pix,
                                   tile_x, tile_y, grid_x, chunk)
    render_forward.launches += 1
    return out


render_forward.launches = 0
