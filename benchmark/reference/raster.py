"""Plain PyTorch reference of 3D Gaussian splatting, written from the
published algorithm (Kerbl et al. 2023, the diff-gaussian-rasterization
CUDA source) and not from the program under test, which it never imports.

One straightforward path, with no kernels, no slot budget and no caches:

- ``preprocess``: near cull at z <= 0.2, perspective projection, EWA
  2-D covariance with the 1.3 tan(fov) clamp and the +0.3 low-pass, conic,
  3-sigma radius, SH colour (+0.5, clamped at 0);
- ``bin_pairs``: every (Gaussian, tile) pair of the Gaussian's tile rect,
  sorted by tile and then depth. The rect is the 3-sigma rect intersected
  with the tiles where alpha can reach 1/255 (the bounding box of that
  ellipse): the second rect only drops tiles where every alpha is below
  1/255, so it changes no pixel; it makes the pair count the duplicate
  count that a slot budget is defined on;
- ``composite``: front-to-back alpha blending per pixel. Training
  semantics: alpha = min(0.99, o e^power), skipped where power > 0 or
  alpha < 1/255; a pixel stops at the first contribution that would take
  its transmittance below 1e-4 (that contribution is dropped). The
  gradient of the 0.99 clamp passes straight through, as in the CUDA
  backward. Render semantics (``stop=False``): every contribution
  composites.

Everything computes in the dtype of its inputs: float32 is the reference;
a lower type is the control of the benchmark's correctness check (the
same computation one precision step down).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products and convolutions in float32, not TF32."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


class Camera(NamedTuple):
    """A pinhole camera: world->camera ``view`` [4, 4], ``full_proj`` [4, 4]
    (projection @ view), ``cam_pos`` [3] as float32 tensors; the half-angle
    tangents and the image size as Python numbers."""

    view: torch.Tensor
    full_proj: torch.Tensor
    cam_pos: torch.Tensor
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Projected(NamedTuple):
    xy: torch.Tensor       # [P, 2] pixel-space mean
    depth: torch.Tensor    # [P]
    conic: torch.Tensor    # [P, 3] inverse 2-D covariance (a, b, c)
    rgb: torch.Tensor      # [P, 3]
    opacity: torch.Tensor  # [P]
    radius: torch.Tensor   # [P] float, 0 where culled
    visible: torch.Tensor  # [P] bool


def rotation_matrix(q):
    """Unit (w, x, y, z) quaternions [P, 4] -> rotation matrices [P, 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def covariance(scales, quats, scale_modifier: float = 1.0):
    """Sigma = R S S^T R^T [P, 3, 3] from scales [P, 3] and unit quats."""
    m = rotation_matrix(quats) * (scale_modifier * scales)[:, None, :]
    return m @ m.transpose(1, 2)


def sh_color(deg: int, shs, means, cam_pos):
    """View-dependent colour: SH [P, (deg+1)^2, 3] at the direction from
    the camera to each mean, +0.5, clamped at 0."""
    d = means - cam_pos
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(
        min=1e-12)
    x, y, z = (d[:, i:i + 1] for i in range(3))
    c = SH_C0 * shs[:, 0]
    if deg > 0:
        c = c - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] \
            - SH_C1 * x * shs[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * shs[:, 4] + SH_C2[1] * yz * shs[:, 5]
             + SH_C2[2] * (2 * zz - xx - yy) * shs[:, 6]
             + SH_C2[3] * xz * shs[:, 7] + SH_C2[4] * (xx - yy) * shs[:, 8])
    if deg > 2:
        c = (c + SH_C3[0] * y * (3 * xx - yy) * shs[:, 9]
             + SH_C3[1] * xy * z * shs[:, 10]
             + SH_C3[2] * y * (4 * zz - xx - yy) * shs[:, 11]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * shs[:, 12]
             + SH_C3[4] * x * (4 * zz - xx - yy) * shs[:, 13]
             + SH_C3[5] * z * (xx - yy) * shs[:, 14]
             + SH_C3[6] * x * (xx - 3 * yy) * shs[:, 15])
    return torch.clamp(c + 0.5, min=0.0)


def preprocess(means, scales, quats, opacities, shs, cam: Camera,
               sh_degree: int, scale_modifier: float = 1.0) -> Projected:
    """Screen-space quantities of every Gaussian (differentiable).
    ``quats`` are unit quaternions, ``scales`` and ``opacities`` activated,
    ``shs`` [P, K, 3]."""
    dt = means.dtype
    view = cam.view.to(dt)
    hom = torch.cat([means, torch.ones_like(means[:, :1])], 1)
    t = hom @ view[:3].T                                  # camera space
    depth = t[:, 2]
    visible = depth > NEAR
    ph = hom @ cam.full_proj.to(dt).T
    ndc = ph[:, :2] / (ph[:, 3:4] + 1e-7)
    size = torch.tensor([cam.width, cam.height], dtype=dt,
                        device=means.device)
    xy = ((ndc + 1.0) * size - 1.0) * 0.5

    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    tz = torch.where(depth.abs() < 1e-6, torch.full_like(depth, 1e-6),
                     depth)
    tx = torch.clamp(t[:, 0] / tz, -1.3 * cam.tan_fovx,
                     1.3 * cam.tan_fovx) * tz
    ty = torch.clamp(t[:, 1] / tz, -1.3 * cam.tan_fovy,
                     1.3 * cam.tan_fovy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                       zero, fy / tz, -fy * ty / (tz * tz)],
                      -1).reshape(-1, 2, 3)
    tm = jac @ view[:3, :3]
    cov2 = tm @ covariance(scales, quats, scale_modifier) @ tm.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    visible = visible & (det != 0)
    det = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([c / det, -b / det, a / det], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    radius = torch.where(visible, radius, torch.zeros_like(radius)).detach()
    rgb = sh_color(sh_degree, shs, means, cam.cam_pos.to(dt))
    return Projected(xy=xy, depth=depth, conic=conic, rgb=rgb,
                     opacity=opacities, radius=radius, visible=visible)


class Pairs(NamedTuple):
    gauss: torch.Tensor       # [K] Gaussian of each pair, by tile then depth
    tile: torch.Tensor        # [K] its tile
    tile_start: torch.Tensor  # [T] first pair of each tile
    tile_len: torch.Tensor    # [T] pairs of each tile
    grid: tuple               # (grid_x, grid_y)


def tile_rects(proj: Projected, width: int, height: int, tile_x: int,
               tile_y: int):
    """(x0, y0, w, h) tile rect of every Gaussian, w = h = 0 where it has
    no pair, and the grid (grid_x, grid_y)."""
    gx, gy = -(-width // tile_x), -(-height // tile_y)
    x, y = proj.xy[:, 0].detach().float(), proj.xy[:, 1].detach().float()
    r = proj.radius.float()
    con = proj.conic.detach().float()
    opa = proj.opacity.detach().float()

    def cell(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n).long()

    x0, x1 = cell(x - r, tile_x, gx), cell(x + r + tile_x - 1, tile_x, gx)
    y0, y1 = cell(y - r, tile_y, gy), cell(y + r + tile_y - 1, tile_y, gy)
    # the bounding box of the ellipse where alpha >= 1/255
    det = torch.clamp(con[:, 0] * con[:, 2] - con[:, 1] ** 2, min=1e-24)
    r2 = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * opa, min=1e-12)),
                     min=0.0)
    ex = torch.sqrt(r2 * torch.clamp(con[:, 2] / det, min=0.0))
    ey = torch.sqrt(r2 * torch.clamp(con[:, 0] / det, min=0.0))
    x0 = torch.maximum(x0, cell(x - ex, tile_x, gx))
    x1 = torch.minimum(x1, torch.clamp(torch.floor((x + ex) / tile_x) + 1,
                                       0, gx).long())
    y0 = torch.maximum(y0, cell(y - ey, tile_y, gy))
    y1 = torch.minimum(y1, torch.clamp(torch.floor((y + ey) / tile_y) + 1,
                                       0, gy).long())
    active = proj.visible & (opa >= ALPHA_MIN)
    w = torch.where(active, torch.clamp(x1 - x0, min=0), 0)
    h = torch.where(active, torch.clamp(y1 - y0, min=0), 0)
    return (x0, y0, w, h), (gx, gy)


def bin_pairs(proj: Projected, width: int, height: int, tile_x: int,
              tile_y: int) -> Pairs:
    """Every (Gaussian, tile) pair, in tile order and, inside a tile, by
    depth (ties by Gaussian index)."""
    (x0, y0, w, h), (gx, gy) = tile_rects(proj, width, height, tile_x,
                                          tile_y)
    n = w * h
    active = n > 0
    x = proj.xy[:, 0].detach().float()
    p = n.shape[0]
    gauss = torch.repeat_interleave(torch.arange(p, device=n.device), n)
    first = torch.cumsum(n, 0) - n
    local = torch.arange(gauss.shape[0], device=n.device) - first[gauss]
    wg = w[gauss]
    tile = (y0[gauss] + local // wg) * gx + x0[gauss] + local % wg
    depth = torch.where(active, proj.depth.detach().float(),
                        torch.full_like(x, float("inf")))
    rank = torch.empty_like(n)
    rank[torch.sort(depth, stable=True).indices] = torch.arange(
        p, device=n.device)
    order = torch.argsort(tile * p + rank[gauss])
    gauss, tile = gauss[order], tile[order]
    tile_len = torch.bincount(tile, minlength=gx * gy)
    return Pairs(gauss=gauss, tile=tile,
                 tile_start=torch.cumsum(tile_len, 0) - tile_len,
                 tile_len=tile_len, grid=(gx, gy))


def features(proj: Projected):
    """[P, 9] rows (x, y, conic a, b, c, opacity, r, g, b)."""
    return torch.cat([proj.xy, proj.conic, proj.opacity[:, None], proj.rgb],
                     1)


def _groups(pairs: Pairs, budget: int):
    """Tiles grouped by pair count (longest first) so that tiles x padded
    length stays under ``budget`` pairs a group; yields (tile ids, length)."""
    lens = pairs.tile_len
    order = torch.argsort(lens, descending=True)
    lens_h = lens[order].tolist()
    i = 0
    while i < len(lens_h) and lens_h[i] > 0:
        length = lens_h[i]
        a = max(1, budget // length)
        j = min(i + a, len(lens_h))
        while j > i + 1 and lens_h[j - 1] == 0:
            j -= 1
        yield order[i:j], length
        i = j


def _blend_group(feat, tiles, length, pairs: Pairs, tile_x: int,
                 tile_y: int, stop: bool, work=None):
    """(colour [A, 3, n_pix], T [A, n_pix]) of the tiles ``tiles`` from the
    feature rows ``feat`` [A, L, 9] of their pairs (zero rows pad)."""
    dev, dt = feat.device, feat.dtype
    gx = pairs.grid[0]
    pix = torch.arange(tile_x * tile_y, device=dev)
    px = ((tiles % gx) * tile_x)[:, None] + (pix % tile_x)[None]
    py = ((tiles // gx) * tile_y)[:, None] + (pix // tile_x)[None]
    dx = px.to(dt)[:, None, :] - feat[:, :, 0:1]          # [A, L, n_pix]
    dy = py.to(dt)[:, None, :] - feat[:, :, 1:2]
    a, b, c = (feat[:, :, i:i + 1] for i in (2, 3, 4))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = feat[:, :, 5:6] * torch.exp(power)
    alpha = raw - torch.clamp(raw - ALPHA_MAX, min=0.0).detach()
    keep = (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    one_m = 1.0 - alpha
    t_all = torch.cumprod(one_m.detach(), 1)
    if stop:
        gate = keep & (t_all >= T_EPS)
        one_m = torch.where(gate, one_m, torch.ones_like(one_m))
    else:
        gate = keep
    t_incl = torch.cumprod(one_m, 1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    wgt = torch.where(gate, alpha * t_excl, torch.zeros_like(alpha))
    color = torch.einsum("alk,alp->akp", feat[:, :, 6:9], wgt)
    t_final = t_incl[:, -1]
    if work is not None:
        t_before = torch.cat([torch.ones_like(t_all[:, :1]), t_all[:, :-1]],
                             1)
        _count_work(work, keep & (t_before >= T_EPS))
    return color, t_final


def _count_work(work, live):
    """The work these inputs need: per tile, the slots up to the last one
    that passes 1/255 at a pixel whose T is still >= 1e-4 (``slots``), and
    those (pixel, slot) pairs (``passing``)."""
    last = torch.where(live.any(2), torch.arange(
        live.shape[1], device=live.device)[None], -1).amax(1) + 1
    work["slots"] = work.get("slots", 0) + int(last.sum())
    work["passing"] = work.get("passing", 0) + int(live.sum())


def _gather(feat_table, pairs: Pairs, tiles, length):
    """[A, length, 9] feature rows of the tiles' pairs, zero-padded."""
    starts, lens = pairs.tile_start[tiles], pairs.tile_len[tiles]
    j = torch.arange(length, device=starts.device)
    idx = starts[:, None] + j[None]
    ok = j[None] < lens[:, None]
    g = pairs.gauss[torch.where(ok, idx, torch.zeros_like(idx))]
    rows = feat_table[g]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows)), g, ok


def composite(feat_table, pairs: Pairs, width: int, height: int,
              tile_x: int, tile_y: int, stop: bool = True,
              budget: int = 1 << 15, work=None):
    """The image [3, H, W] over a black background and the final T
    [H, W]; no autograd graph."""
    gx, gy = pairs.grid
    n_pix = tile_x * tile_y
    dev, dt = feat_table.device, feat_table.dtype
    color = torch.zeros(gx * gy, 3, n_pix, dtype=dt, device=dev)
    trans = torch.ones(gx * gy, n_pix, dtype=dt, device=dev)
    with torch.no_grad():
        for tiles, length in _groups(pairs, budget):
            f, _, _ = _gather(feat_table, pairs, tiles, length)
            color[tiles], trans[tiles] = _blend_group(
                f, tiles, length, pairs, tile_x, tile_y, stop, work=work)
    img = _assemble(color, gx, gy, tile_x, tile_y, width, height)
    t = _assemble(trans[:, None], gx, gy, tile_x, tile_y, width, height)[0]
    return img, t


def composite_grad(feat_table, pairs: Pairs, d_img, tile_x: int,
                   tile_y: int, budget: int = 1 << 15):
    """d(loss)/d(feature table) [P, 9], given d(loss)/d(image) [3, H, W]
    of a training composite (black background): each group of tiles is
    blended again under autograd and its gradient summed per Gaussian in
    float64."""
    gx, gy = pairs.grid
    h, w = d_img.shape[1:]
    pad = torch.zeros(3, gy * tile_y, gx * tile_x, dtype=d_img.dtype,
                      device=d_img.device)
    pad[:, :h, :w] = d_img
    d_tiles = pad.reshape(3, gy, tile_y, gx, tile_x).permute(
        1, 3, 0, 2, 4).reshape(gx * gy, 3, tile_x * tile_y)
    base = feat_table.detach()
    d_table = torch.zeros(base.shape, dtype=torch.float64,
                          device=base.device)
    for tiles, length in _groups(pairs, budget):
        f, g, ok = _gather(base, pairs, tiles, length)
        f = f.requires_grad_(True)
        color, _ = _blend_group(f, tiles, length, pairs, tile_x, tile_y,
                                True)
        (df,) = torch.autograd.grad(color, f, d_tiles[tiles])
        d_table.index_add_(0, g[ok], df[ok].double())
    return d_table


def _assemble(t, gx, gy, tile_x, tile_y, width, height):
    ch = t.shape[1]
    img = t.reshape(gy, gx, ch, tile_y, tile_x).permute(2, 0, 3, 1, 4)
    return img.reshape(ch, gy * tile_y, gx * tile_x)[:, :height, :width]


def num_dup(means, scales, quats, opacities, cam: Camera, tile_x: int,
            tile_y: int) -> int:
    """The pair count of a camera (colours do not enter it)."""
    shs = torch.zeros(means.shape[0], 1, 3, dtype=means.dtype,
                      device=means.device)
    with torch.no_grad():
        proj = preprocess(means, scales, quats, opacities, shs, cam, 0)
        (_, _, w, h), _ = tile_rects(proj, cam.width, cam.height, tile_x,
                                     tile_y)
        return int((w * h).sum())
