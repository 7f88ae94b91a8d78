"""gsplat_tpu_torch kernel wrappers, without JAX.

This module imports neither jax nor gsplat_tpu, so it also runs where only
PyTorch is installed (the GPU host):

- on the CPU, each plain PyTorch version is held against a numpy oracle
  written as a loop from the kernel's definition (exact for the integer
  scans, float32 tolerance for the render), and the served frame's encode
  against numpy's float32 encode (bit for bit);
- ``gpu`` tests hold each CUDA kernel against its plain version on the same
  inputs: the scans and the encode bit-equal, images within two bf16 ULPs;
  the scans and the served frame replayed as CUDA graphs against eager
  calls, bit for bit.
  They skip on a host without an NVIDIA GPU. Run them there with
  ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``
  (``--noconftest``: tests/conftest.py configures JAX).

The case builders here are shared by the JAX parity tests.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.model import mcmc as tmcmc
from gsplat_tpu_torch.raster import binning as tbinning
from gsplat_tpu_torch.raster import cuda_ext
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import scan_kernel as tscan
from gsplat_tpu_torch.raster import tile_kernel as ttile
from gsplat_tpu_torch.viewer import network_gui
from tests.torch_threads import one_torch_thread  # noqa: F401

BG = [0.2, 0.3, 0.4]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_params(p=300, cap=400, deg=1, seed=0):
    """Raw GaussianState leaves (numpy) with an alive prefix of ``p``."""
    rng = np.random.default_rng(seed)
    k = (deg + 1) ** 2
    z = np.zeros
    par = dict(xyz=z((cap, 3)), f_dc=z((cap, 1, 3)), f_rest=z((cap, k - 1, 3)),
               opacity=z((cap, 1)), scaling=z((cap, 3)), rotation=z((cap, 4)))
    par["xyz"][:p] = np.c_[rng.uniform(-1.2, 1.2, (p, 2)),
                           rng.uniform(2.0, 6.0, p)]
    par["f_dc"][:p] = 1.0 + 0.3 * rng.normal(size=(p, 1, 3))
    par["f_rest"][:p] = 0.3 * rng.normal(size=(p, k - 1, 3))
    par["opacity"][:p] = rng.uniform(-2.0, 6.0, (p, 1))
    par["scaling"][:p] = rng.uniform(-3.5, -1.5, (p, 3))
    par["rotation"][:p] = rng.normal(size=(p, 4))
    return {key: v.astype(np.float32) for key, v in par.items()}


def expand_case(k, seed):
    """Sparse marks incl. index 0, block edges and a whole empty block;
    base_in as binning builds it."""
    rng = np.random.default_rng(seed)
    marks = np.zeros(k, np.int32)
    edges = [e for e in (0, 4095, 4096, 2 * 4096 - 1, 8192) if e < k]
    pos = np.unique(np.concatenate([rng.integers(100, k, 40), edges]))
    pos = pos[(pos < 4096 * 2) | (pos >= 4096 * 3)]  # empty 3rd block
    marks[pos] = rng.integers(1, 1 << 20, pos.shape[0])
    base_in = np.where(marks != 0, np.arange(k, dtype=np.int32), 0)
    return marks, base_in.astype(np.int32)


# (active rows, total rows, slots): ``active`` non-empty ranges followed
# by empty ones, or a kind of case (``merge_case``): empty ranges
# interleaved and at the front ("interleaved"), a run of empty ranges longer
# than a kernel block's 2048 merged items at the front ("front") or at the
# end ("tailrun"); each with slots more than a block past the last start
MERGE_CASES = [(50, 80, 700), (1000, 1200, 5000), (3, 5, 40), (0, 4, 30),
               (600, 600, 512), (513, 513, 2048), (1500, 2000, 9000),
               ("interleaved", 3000, 20000), ("front", 5000, 12000),
               ("tailrun", 6000, 12000)]
# cases the JAX kernel does not take (its window of 3 x 512 candidate rows
# a 512-slot block assumes no long run of empty ranges among live ones):
# a run of 5000 empty ranges between live ones ("innerrun"), and the main
# path's size, P = 1M with 900k trailing empty ranges and K = 3.43M as at
# the 1M training setting ("mainpath")
MERGE_MORE_CASES = [("innerrun", 6000, 30000), ("mainpath", 1_000_000,
                                                 3_431_424)]


def merge_case(p_act, p_total, seed=0):
    """Ascending range starts, random packs and the live slot count:
    ``p_act`` non-empty ranges followed by empty ones, or the ranges of a
    kind of case (see MERGE_CASES)."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(p_total, np.int32)
    if isinstance(p_act, int):
        counts[:p_act] = rng.integers(1, 9, size=p_act)
    else:
        counts[:] = rng.integers(1, 61 if p_act == "mainpath" else 9,
                                 size=p_total)
        empty = {"interleaved": rng.uniform(size=p_total) < 0.35,
                 "front": np.arange(p_total) < 3000,
                 "tailrun": np.arange(p_total) >= 1000,
                 "innerrun": (np.arange(p_total) >= 500)
                 & (np.arange(p_total) < 5500),
                 "mainpath": np.arange(p_total) >= 100_000}[p_act]
        counts[empty] = 0
        counts[:5] = 0 if p_act == "interleaved" else counts[:5]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    pack = rng.integers(1, 1 << 23, size=p_total).astype(np.int32)
    return offsets[:p_total], pack, int(offsets[-1])


def torch_scene(width=80, height=48, cap=400, device="cpu"):
    """A 300-Gaussian state and a camera on ``device``."""
    par = make_params(cap=cap, seed=11)
    state = tgauss.state_from_numpy(par, 300, 1, device)
    cam = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height,
                              device=device)
    return state, cam


def numpy_encode(img):
    """numpy's float32 encode of a bf16 [3, H, W] image: the uint8 [H, W,
    3] bytes of clip(x, 0, 1) * 255 + 0.5."""
    x = img.float().permute(1, 2, 0).cpu().numpy()
    return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8).tobytes()


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize("k", [150, 700, 3 * 4096 + 511])
def test_expand_scan_plain_matches_loop(k):
    marks, base_in = expand_case(k, seed=k)
    pack, base, rank = np.zeros(k, np.int32), np.zeros(k, np.int32), \
        np.zeros(k, np.int32)
    carry = [0, 0, 0]
    for i in range(k):
        if marks[i]:
            carry[0] = marks[i]
            carry[2] += 1
        carry[1] = max(carry[1], base_in[i])
        pack[i], base[i], rank[i] = carry
    got = tscan.expand_scan(torch.from_numpy(marks), torch.from_numpy(base_in))
    for g, w in zip(got, (pack, base, rank)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("p_act,p_total,k", MERGE_CASES + MERGE_MORE_CASES)
def test_merge_expand_plain_matches_loop(p_act, p_total, k):
    """Every slot, live or past the duplicate count, against a walk of the
    starts in order: the owner is the last range starting at or before
    the slot."""
    starts, pack, num_dup = merge_case(p_act, p_total)
    assert k > num_dup or isinstance(p_act, int)
    got = [g.numpy() for g in tscan.merge_expand(
        torch.from_numpy(starts), torch.from_numpy(pack), k)]
    starts_l, owners, owner = starts.tolist(), [], -1
    for d in range(k):
        while owner + 1 < p_total and starts_l[owner + 1] <= d:
            owner += 1
        owners.append(owner)
    g = np.asarray(owners, np.int64)
    has = g >= 0
    np.testing.assert_array_equal(got[0], np.where(has, pack[g], 0))
    np.testing.assert_array_equal(got[1], np.where(has, starts[g], 0))
    np.testing.assert_array_equal(got[2], g + 1)


def test_tile_histogram_is_exact():
    rng = np.random.default_rng(5)
    gx, gy, n = 7, 5, 200
    mnx = rng.integers(0, gx, n)
    mny = rng.integers(0, gy, n)
    mxx = mnx + rng.integers(0, gx - mnx + 1)
    mxy = mny + rng.integers(0, gy - mny + 1)
    act = rng.uniform(size=n) < 0.7
    want = np.zeros((gy, gx), np.int32)
    for i in np.flatnonzero(act):
        want[mny[i]:mxy[i], mnx[i]:mxx[i]] += 1
    T = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    got = tbinning._tile_histogram(T(mnx), T(mny), T(mxx), T(mxy),
                                   torch.from_numpy(act), gx, gy)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))


def render_case(seed=0, chunk=16, tile_x=8, tile_y=4, grid_x=3):
    """Random feature stream over 4 tiles: tile 0 has 3 chunks (dense
    opaque splats, so the tile-wide stop fires), tile 1 none, tiles 2 and 3
    one each; two trailing sentinel chunks."""
    rng = np.random.default_rng(seed)
    tiles = [0, 0, 0, 2, 3, 6, 6]   # 6 == num_tiles: sentinel
    n = len(tiles) * chunk
    feat = np.zeros((9, n), np.float32)
    for c, t in enumerate(tiles):
        s = slice(c * chunk, (c + 1) * chunk)
        ox, oy = (t % grid_x) * tile_x, (t // grid_x) * tile_y
        feat[0, s] = ox + rng.uniform(-2, tile_x + 2, chunk)
        feat[1, s] = oy + rng.uniform(-2, tile_y + 2, chunk)
        lo, hi = (0.005, 0.02) if t == 0 else (0.05, 0.6)  # tile 0: wide
        feat[2, s] = rng.uniform(lo, hi, chunk)
        feat[3, s] = rng.uniform(-lo, lo, chunk)
        feat[4, s] = rng.uniform(lo, hi, chunk)
        feat[5, s] = rng.uniform(0.9 if t == 0 else 0.0, 1.0, chunk)
        feat[6:9, s] = rng.uniform(0, 1, (3, chunk))
    feat = torch.from_numpy(feat).to(torch.bfloat16).float().numpy()
    tl = np.array(tiles, np.int32)
    first = np.r_[1, tl[1:] != tl[:-1]].astype(np.int32)
    last = np.r_[tl[1:] != tl[:-1], 1].astype(np.int32)
    meta = (tl << 2) | (first << 1) | last
    return feat, meta, dict(num_tiles=6, n_pix=tile_x * tile_y,
                            tile_x=tile_x, tile_y=tile_y, grid_x=grid_x,
                            chunk=chunk)


def test_render_forward_plain_matches_loop():
    feat, meta, kw = render_case()
    tx, n_pix, chunk = kw["tile_x"], kw["n_pix"], kw["chunk"]
    want = np.tile(np.asarray(BG, np.float32)[None, :, None],
                   (kw["num_tiles"], 1, n_pix))
    stopped = []
    for t in range(kw["num_tiles"]):
        chunks = [c for c in range(len(meta)) if meta[c] >> 2 == t]
        ox, oy = (t % kw["grid_x"]) * tx, (t // kw["grid_x"]) * kw["tile_y"]
        T = np.ones(n_pix, np.float32)
        col = np.zeros((3, n_pix), np.float32)
        px = (np.arange(n_pix) % tx).astype(np.float32)
        py = (np.arange(n_pix) // tx).astype(np.float32)
        for c in chunks:
            for g in range(c * chunk, (c + 1) * chunk):
                x, y, a, b, cc, opa = feat[:6, g]
                dx, dy = px - (x - ox), py - (y - oy)
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                alpha = np.minimum(ttile.ALPHA_MAX, opa * np.exp(power))
                alpha = np.where((power > 0) | (alpha < ttile.ALPHA_MIN), 0.0,
                                 alpha).astype(np.float32)
                col += feat[6:9, g, None] * (alpha * T)
                T = T * (1 - alpha)
            if T.max() <= ttile.T_EPS:
                stopped.append((t, c))
                break
        want[t] = col + T * np.asarray(BG, np.float32)[:, None]
    assert stopped and stopped[0][0] == 0 and stopped[0][1] < 2, stopped
    got = ttile.render_forward(torch.from_numpy(feat).to(torch.bfloat16),
                               torch.from_numpy(meta), torch.tensor(BG), **kw)
    assert got.dtype == torch.bfloat16
    # float32 products in another order, then one bf16 rounding
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=1e-5)


def bf16(x):
    """float32 values rounded to bf16 and decoded (what the render's
    feature stream holds)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def stream_meta(tiles):
    """chunk_meta for chunks of the given tile ids (ascending)."""
    tl = np.array(tiles, np.int32)
    first = np.r_[1, tl[1:] != tl[:-1]].astype(np.int32)
    last = np.r_[tl[1:] != tl[:-1], 1].astype(np.int32)
    return (tl << 2) | (first << 1) | last


def render_stop_case(seed=0, half=False, chunk=128, tile_x=128, tile_y=32,
                     top=None, fill=None):
    """One tile of four chunks: the first two hold dense opaque splats over
    the whole tile (the tile-wide stop fires after the second) or, with
    ``half``, smaller ones over its top rows (rows 0-7 end below 1e-4, the
    lower half does not, so the tile walks all four chunks and the
    saturated pixels keep compositing); the last two hold small splats
    anywhere. ``top`` moves the half case's lowest splat centre (3/8 of
    the tile down by default); ``fill`` leaves only the first ``fill``
    slots of each chunk live (the rest padding, opacity 0). A trailing
    sentinel chunk."""
    rng = np.random.default_rng(seed)
    tiles = [0, 0, 0, 0, 1]
    feat = np.zeros((9, len(tiles) * chunk), np.float32)
    chunk_all, chunk = chunk, fill or chunk
    for ci in range(4):
        s = slice(ci * chunk_all, ci * chunk_all + chunk)
        if ci < 2:
            lo, hi = (0.03, 0.06) if half else (0.005, 0.02)
            feat[0, s] = rng.uniform(-4, tile_x + 4, chunk)
            feat[1, s] = rng.uniform(-2, (top or 3 * tile_y / 8) if half
                                     else tile_y + 2, chunk)
            feat[2, s] = feat[4, s] = rng.uniform(lo, hi, chunk)
            feat[5, s] = rng.uniform(0.95, 1.0, chunk)
        else:
            feat[0, s] = rng.uniform(0, tile_x, chunk)
            feat[1, s] = rng.uniform(0, tile_y, chunk)
            feat[2, s] = feat[4, s] = rng.uniform(0.1, 0.5, chunk)
            feat[3, s] = rng.uniform(-0.05, 0.05, chunk)
            feat[5, s] = rng.uniform(0.2, 1.0, chunk)
        feat[6:9, s] = rng.uniform(0, 1, (3, chunk))
    return bf16(feat), stream_meta(tiles), dict(
        num_tiles=1, n_pix=tile_x * tile_y, tile_x=tile_x, tile_y=tile_y,
        grid_x=1, chunk=chunk_all)


def render_graze_case(seed=0, tile_x=128, tile_y=32, chunk=128):
    """One tile of bf16 slots whose alpha = 1/255 contour (exact, from the
    bf16-decoded values) reaches within 1e-6-1e-3 px of a column on a
    multiple of 8 or a row on a multiple of 4 (the edges of the kernels'
    8 x 4 sub-blocks), from either side; axis-aligned and rotated conics,
    means on integer pixels or anywhere; the last 8 slots are padding.
    Found by a seeded search over 2^20 random slots. Returns the case and
    the slots' distances to their edge."""
    rng = np.random.default_rng(seed)
    n = 1 << 20
    s1, s2 = 10 ** rng.uniform(-0.3, 1.0, (2, n))
    th = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, np.pi, n))
    cs, sn = np.cos(th), np.sin(th)
    sxx = cs * cs * s1 * s1 + sn * sn * s2 * s2
    syy = sn * sn * s1 * s1 + cs * cs * s2 * s2
    sxy = cs * sn * (s1 * s1 - s2 * s2)
    det = sxx * syy - sxy * sxy
    a, b, c = (bf16(v).astype(np.float64)
               for v in (syy / det, -sxy / det, sxx / det))
    opa = bf16(rng.uniform(0.02, 1.0, n)).astype(np.float64)
    on_pix = rng.uniform(size=n) < 0.5
    x = np.where(on_pix, rng.integers(4, tile_x - 4, n),
                 bf16(rng.uniform(4, tile_x - 4, n))).astype(np.float64)
    y = np.where(on_pix, rng.integers(2, tile_y - 2, n),
                 bf16(rng.uniform(2, tile_y - 2, n))).astype(np.float64)
    r2 = 2 * np.log(255 * opa)
    dt = a * c - b * b
    hx, hy = np.sqrt(r2 * c / dt), np.sqrt(r2 * a / dt)
    # contour extremes against sub-block edges: the first column (row) of
    # the next sub-block, or the last of the previous one
    ends = ((x + hx, 8), (x - hx + 1, 8), (y + hy, 4), (y - hy + 1, 4))
    dist = np.min([np.abs(e - np.round(e / m) * m) for e, m in ends],
                  axis=0)
    # up to a third of the slots from each decade of distance
    per = (chunk - 8) // 3
    pick = np.concatenate([np.flatnonzero((dist >= lo) & (dist < 10 * lo))
                           [:per] for lo in (1e-6, 1e-5, 1e-4)])
    pick = np.concatenate([pick, np.flatnonzero(
        (dist >= 1e-5) & (dist <= 1e-3) & ~np.isin(np.arange(n), pick))
        [:chunk - 8 - pick.shape[0]]])
    feat = np.zeros((9, 2 * chunk), np.float32)
    k = pick.shape[0]
    for row, v in enumerate((x, y, a, b, c, opa)):
        feat[row, :k] = v[pick]
    feat[6:9, :k] = bf16(rng.uniform(0, 1, (3, k)))
    meta = stream_meta([0, 1])
    return feat, meta, dict(num_tiles=1, n_pix=tile_x * tile_y,
                            tile_x=tile_x, tile_y=tile_y, grid_x=1,
                            chunk=chunk), dist[pick]


def render_empty_case(chunk=32, tile_x=16, tile_y=16):
    """Six tiles and no chunk but two sentinels: every tile is
    background."""
    return (np.zeros((9, 2 * chunk), np.float32), stream_meta([6, 6]),
            dict(num_tiles=6, n_pix=tile_x * tile_y, tile_x=tile_x,
                 tile_y=tile_y, grid_x=3, chunk=chunk))


# (chunk, tile_x, tile_y) of render_case's six tiles, or a case function.
# Above 4,096 pixels (two groups of 32 warp blocks: rows 0-31 and 32-63 of
# a 128 x 64 tile) and 256-slot chunks (two pieces) the kernel's tile-wide
# stop spans groups: "stop-128x64-c512" (256 live slots a chunk, the
# density of "stop-128x32-c128") stops both groups after two chunks; in
# "halfstop-128x64-c512" the top group is all below 1e-4 after
# two chunks and the bottom one never, so the top group resumes from its
# kept state and composites the last two chunks too
RENDER_CASES = {"128x32-c128": (128, 128, 32), "128x32-c256": (256, 128, 32),
                "16x16-c16": (16, 16, 16), "ragged-24x10-c32": (32, 24, 10),
                "thin-256x4-c128": (128, 256, 4),
                "stop-128x32-c128": lambda: render_stop_case(),
                "halfstop-128x32-c128": lambda: render_stop_case(half=True),
                "empty-16x16-c32": render_empty_case,
                "graze-128x32-c128": lambda: render_graze_case()[:3],
                "128x64-c512": (512, 128, 64),
                "stop-128x64-c512": lambda: render_stop_case(
                    chunk=512, tile_y=64, fill=256),
                "halfstop-128x64-c512": lambda: render_stop_case(
                    half=True, chunk=512, tile_y=64, top=34)}


def render_stream(case, seed=0):
    """(feat bf16-decoded float32, chunk_meta, kwargs) of a render case."""
    spec = RENDER_CASES[case]
    if callable(spec):
        return spec()
    chunk, tile_x, tile_y = spec
    return render_case(seed, chunk=chunk, tile_x=tile_x, tile_y=tile_y)


def plain_power(a, b, c, dx, dy):
    """The plain render's quadratic form (tile_kernel.render_forward_plain):
    -0.5 (a dx dx + c dy dy) - b dx dy, each operation rounded."""
    return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy


def staged_power(a, b, c, dx, dy):
    """tile_common.cuh::power_of on the staged record: (ha dx dx + hc dy dy)
    - b dx dy with ha = -a/2, hc = -c/2."""
    ha, hc = -0.5 * a, -0.5 * c
    return (ha * dx * dx + hc * dy * dy) - b * dx * dy


def passing_mask(xl, yl, a, b, c, opa, xs, ys):
    """float32 pixels (xs, ys broadcast against the slot values) whose
    alpha passes 1/255 in the plain render's operation order."""
    dx, dy = xs - xl, ys - yl
    power = plain_power(a, b, c, dx, dy)
    alpha = torch.clamp(opa * torch.exp(power), max=ttile.ALPHA_MAX)
    return (power <= 0) & (alpha >= ttile.ALPHA_MIN)


def sub_block_cull(feat, kw):
    """For each slot of a one-tile stream and each 8 x 4 sub-block of the
    tile: (kept by the cull box, holds a pixel that passes 1/255), as
    [slots, sub-blocks] bool tensors, all from the bf16-decoded values."""
    f = torch.from_numpy(feat)
    tx, ty = kw["tile_x"], kw["tile_y"]
    sx, sy = ttile.BLEND_SUB_BLOCK
    col = lambda t: t[:, None]  # noqa: E731
    xl, yl, a, b, c, opa = (col(f[i]) for i in range(6))
    hx, hy = ttile.blend_cull_extent(a, b, c, opa)
    pix = torch.arange(tx * ty)
    xs, ys = (pix % tx).float()[None], (pix // tx).float()[None]
    passing = passing_mask(xl, yl, a, b, c, opa, xs, ys)   # [K, n_pix]
    nbx, nby = -(-tx // sx), -(-ty // sy)
    sub = (pix // tx // sy) * nbx + (pix % tx) // sx
    holds = torch.zeros(f.shape[1], nbx * nby, dtype=torch.int32)
    holds = holds.scatter_reduce(1, sub.expand(f.shape[1], -1),
                                 passing.int(), "amax") > 0
    bx = torch.arange(nbx * nby)
    x0, y0 = ((bx % nbx) * sx).float(), ((bx // nbx) * sy).float()
    x1 = torch.clamp(x0 + sx, max=tx) - 1
    y1 = torch.clamp(y0 + sy, max=ty) - 1
    kept = ttile.blend_cull_meets(xl, yl, hx, hy, x0[None], x1[None],
                                  y0[None], y1[None])
    return kept, holds


@given(log_s=st.tuples(st.floats(-0.6, 2.5), st.floats(-0.6, 2.5)),
       theta=st.floats(0.0, np.pi), opa=st.floats(1e-4, 1.0),
       tile=st.tuples(st.integers(0, 14), st.integers(0, 33)),
       mean=st.tuples(st.floats(-40, 168), st.floats(-40, 72)),
       near=st.booleans(), shift=st.tuples(st.integers(-1, 1),
                                           st.integers(-1, 1)),
       sub=st.tuples(st.integers(0, 15), st.integers(0, 7)))
@settings(max_examples=200, deadline=None)
def test_render_cull_never_drops_a_passing_pixel_bf16(log_s, theta, opa,
                                                      tile, mean, near,
                                                      shift, sub):
    """The render's cull rule on bf16-decoded features: no (8 x 4
    sub-block, slot) pair it drops holds a pixel of a 128 x 32 tile whose
    float32 alpha, in the plain render's operation order, passes 1/255.
    The mean is a bf16 global coordinate made tile-local as the kernel
    does; the sub-block straddles the box's edge or lies anywhere."""
    s1, s2 = 10.0 ** log_s[0], 10.0 ** log_s[1]
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]])
    a, b, _, c = bf16(np.linalg.inv(rot @ np.diag([s1 * s1, s2 * s2])
                                    @ rot.T).ravel())
    opa = bf16(opa)
    ox, oy = np.float32(tile[0] * 128), np.float32(tile[1] * 32)
    x, y = bf16([ox + mean[0], oy + mean[1]])
    xl, yl = f32(x) - f32(ox), f32(y) - f32(oy)
    hx, hy = cull_extent(a, b, c, opa)
    sx, sy = ttile.BLEND_SUB_BLOCK
    if near and np.isfinite(float(hx)) and hx > 0:
        x0 = (int(np.floor(float(xl + hx))) // sx + shift[0]) * sx
        y0 = (int(np.floor(float(yl))) // sy + shift[1]) * sy
    else:
        x0, y0 = sub[0] * sx, sub[1] * sy
    if not (0 <= x0 < 128 and 0 <= y0 < 32):
        return
    x1, y1 = x0 + sx - 1, y0 + sy - 1
    if not block_meets(xl, yl, hx, hy, x0, x1, y0, y1):
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1, dtype=np.float32),
                             np.arange(y0, y1 + 1, dtype=np.float32))
        assert not bool(passing_mask(xl, yl, f32(a), f32(b), f32(c),
                                     f32(opa), torch.from_numpy(xs),
                                     torch.from_numpy(ys)).any())


def test_render_cull_keeps_grazing_bf16_slots():
    """Slots whose contour ends 1e-6-1e-3 px from a sub-block edge: the
    box never drops a (sub-block, slot) pair that holds a passing pixel,
    and the case does graze (distances down to 1e-5 px; pixels whose
    alpha is within 1% of 1/255 pass)."""
    feat, _, kw, dist = render_graze_case()
    assert dist.shape[0] == kw["chunk"] - 8
    assert dist.min() < 1e-5 and 1e-4 < dist.max() <= 1e-3
    kept, holds = sub_block_cull(feat, kw)
    assert not bool((holds & ~kept).any())
    assert int(holds.sum()) > 0 and bool((~kept).any())
    f = torch.from_numpy(feat)
    pix = torch.arange(kw["n_pix"])
    xs = (pix % kw["tile_x"]).float()[None]
    ys = (pix // kw["tile_x"]).float()[None]
    power = plain_power(*(f[i][:, None] for i in (2, 3, 4)),
                        xs - f[0][:, None], ys - f[1][:, None])
    alpha = f[5][:, None] * torch.exp(power)
    assert int(((alpha >= ttile.ALPHA_MIN)
                & (alpha < 1.01 * ttile.ALPHA_MIN)).sum()) > 0


def test_render_staged_power_matches_plain_form_bitwise():
    """The kernels' staged quadratic form (-1/2 folded into a and c) gives
    the plain render's power bit for bit on bf16-decoded conics and
    tile-local offsets (zero offsets included)."""
    rng = np.random.default_rng(3)
    n = 1 << 18
    a, c = (torch.from_numpy(bf16(10 ** rng.uniform(-4, 0.6, n)))
            for _ in range(2))
    b = torch.from_numpy(bf16(rng.uniform(-0.99, 0.99, n)
                              * np.sqrt((a * c).numpy())))
    ox = (rng.integers(0, 15, n) * 128).astype(np.float32)
    oy = (rng.integers(0, 34, n) * 32).astype(np.float32)
    xl = torch.from_numpy(bf16(ox + rng.uniform(-30, 158, n)) - ox)
    yl = torch.from_numpy(bf16(oy + rng.uniform(-30, 62, n)) - oy)
    px = torch.from_numpy(rng.integers(0, 128, n)).float()
    py = torch.from_numpy(rng.integers(0, 32, n)).float()
    px[: n // 8] = torch.round(xl[: n // 8]).clamp(0, 127)   # dx = 0 often
    dx, dy = px - xl, py - yl
    want = plain_power(a, b, c, dx, dy)
    got = staged_power(a, b, c, dx, dy)
    assert bool((dx == 0).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_render_halfstop_case_stops_one_pixel_group_early():
    """The 8,192-pixel half-stop case does what the card's test needs: after
    its first two chunks every pixel of the top 32 rows (the kernel's
    first group of 32 warp blocks) is at T <= 1e-4 and some pixel of the
    bottom 32 is not, so the tile walks all four chunks (plain render on
    the CPU; with black splats over a white background the image is T)."""
    feat, meta, kw = RENDER_CASES["halfstop-128x64-c512"]()
    chunk, n_pix = kw["chunk"], kw["n_pix"]
    two = feat[:, :2 * chunk].copy()
    two[6:9] = 0.0
    img, visits = ttile.render_plain_with_visits(
        torch.from_numpy(two).to(torch.bfloat16),
        torch.from_numpy(stream_meta([0, 0])), torch.ones(3),
        num_tiles=1, n_pix=n_pix, tile_x=kw["tile_x"], tile_y=kw["tile_y"],
        grid_x=1, chunk=chunk)
    t = img[0, 0].float().reshape(kw["tile_y"], kw["tile_x"])
    assert int(visits[0]) == 2
    assert float(t[:32].max()) <= ttile.T_EPS
    assert float(t[32:].max()) > ttile.T_EPS
    _, visits = ttile.render_plain_with_visits(
        torch.from_numpy(feat).to(torch.bfloat16), torch.from_numpy(meta),
        torch.tensor(BG), **kw)
    assert int(visits[0]) == 4


def test_render_passing_pairs_match_loop():
    """The plain render's stats: the visited chunks and the (pixel, slot)
    pairs of those chunks that pass 1/255, against a numpy loop."""
    feat, meta, kw = render_case()
    tx, n_pix, chunk = kw["tile_x"], kw["n_pix"], kw["chunk"]
    px = (np.arange(n_pix) % tx).astype(np.float32)
    py = (np.arange(n_pix) // tx).astype(np.float32)
    want_pass, want_visited = 0, []
    for t in range(kw["num_tiles"]):
        ox, oy = (t % kw["grid_x"]) * tx, (t // kw["grid_x"]) * kw["tile_y"]
        T = np.ones(n_pix, np.float32)
        for ci in [ci for ci in range(len(meta)) if meta[ci] >> 2 == t]:
            want_visited.append(ci)
            for g in range(ci * chunk, (ci + 1) * chunk):
                x, y, a, b, cc, opa = feat[:6, g]
                dx = px - np.float32(x - np.float32(ox))
                dy = py - np.float32(y - np.float32(oy))
                power = (np.float32(-0.5) * (a * dx * dx + cc * dy * dy)
                         - b * dx * dy)
                alpha = np.minimum(np.float32(ttile.ALPHA_MAX),
                                   opa * exp32(power))
                ok = (power <= 0) & (alpha >= np.float32(ttile.ALPHA_MIN))
                want_pass += int(ok.sum())
                T = T * (1 - np.where(ok, alpha, 0)).astype(np.float32)
            if T.max() <= ttile.T_EPS:
                break
    stats = {}
    ttile.render_plain_with_visits(
        torch.from_numpy(feat).to(torch.bfloat16), torch.from_numpy(meta),
        torch.tensor(BG), **kw, stats=stats)
    assert sorted(int(i) for v in stats["visited"] for i in v) == sorted(
        want_visited)
    assert stats["passing"] == want_pass > 0


def graze_case(seed=0, tile_x=32, tile_y=16, chunk=128):
    """One tile of splats whose alpha = 1/255 contours end within
    +-1e-3 px of a pixel column or row on a multiple of 8 columns or 4
    rows (the edges of the kernels' warp blocks), from either side, at
    axis-aligned and rotated conics; opacities just above and below 1/255
    and chunk padding (opacity 0) among them. A trailing sentinel chunk."""
    rng = np.random.default_rng(seed)
    sx, sy = ttile.BLEND_SUB_BLOCK
    n = chunk - 8                          # the last 8 slots are padding
    feat = np.zeros((9, 2 * chunk), np.float64)
    deltas = [-1e-3, -1e-4, -1e-6, 0.0, 1e-6, 1e-4, 1e-3]
    for k in range(n):
        kind = k % 4
        opa = rng.uniform(0.02, 1.0)
        if k % 16 == 5:
            opa = (1 + (1e-6 if k % 32 == 5 else -1e-6)) / 255.0
        s1, s2 = rng.uniform(0.5, 4.0, 2)
        th = 0.0 if kind < 2 else rng.uniform(0, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        a, b, _, c = np.linalg.inv(rot @ np.diag([s1 * s1, s2 * s2])
                                   @ rot.T).ravel()
        r2 = 2 * np.log(255 * opa) if opa > 1 / 255 else 0.0
        det = a * c - b * b
        hx, hy = np.sqrt(r2 * c / det), np.sqrt(r2 * a / det)
        d = deltas[k % len(deltas)]
        row = rng.integers(2, tile_y - 2)
        col = rng.integers(2, tile_x - 2)
        ex = sx * rng.integers(1, tile_x // sx)
        ey = sy * rng.integers(1, tile_y // sy)
        if kind in (0, 3):     # rightmost point near column ex, from the left
            x = ex - hx + d
            y = row + b / c * hx
        elif kind == 1:        # leftmost point near column ex - 1
            x = ex - 1 + hx - d
            y = row - b / c * hx
        else:                  # lowest point near row ey
            y = ey - hy + d
            x = col + b / a * hy
        feat[:, k] = [x, y, a, b, c, opa, *rng.uniform(0, 1, 3)]
    feat = feat.astype(np.float32)
    meta = np.array([(0 << 2) | 3, (1 << 2) | 3], np.int32)
    return feat, meta, dict(num_tiles=1, n_pix=tile_x * tile_y,
                            tile_x=tile_x, tile_y=tile_y, grid_x=1,
                            chunk=chunk)


# (chunk, tile_x, tile_y) of render_case's six tiles, or the grazing case
# (four groups of 8 warp blocks and two 128-slot pieces a chunk at
# 128x32-c256; eight groups and four pieces at 128x64-c512)
BLEND_CASES = {"8x4-c16": (16, 8, 4), "16x16-c128": (128, 16, 16),
               "64x16-c128": (128, 64, 16), "ragged-24x10-c32": (32, 24, 10),
               "thin-256x4-c128": (128, 256, 4), "graze-32x16-c128": None,
               "128x32-c256": (256, 128, 32), "128x64-c512": (512, 128, 64)}


def blend_case(case="8x4-c16", seed=0):
    """A float32 training stream (``render_case`` at the case's chunk and
    tile shape: a saturating tile, an empty one, and two one-chunk tiles;
    or ``graze_case``), with a random cotangent pack for the backward."""
    if BLEND_CASES[case] is None:
        feat, meta, kw = graze_case(seed)
    else:
        chunk, tile_x, tile_y = BLEND_CASES[case]
        feat, meta, kw = render_case(seed, chunk=chunk, tile_x=tile_x,
                                     tile_y=tile_y)
    rng = np.random.default_rng(seed + 1)
    dpack = rng.normal(size=(kw["num_tiles"], 4, kw["n_pix"])).astype(
        np.float32)
    return feat, meta, dpack, kw


def exp32(x):
    """float32 e^x as PyTorch (and the CUDA kernels) round it: numpy's
    float32 exp differs in the last bit on some inputs, which flips
    grazing pixels at the 1/255 threshold."""
    return torch.exp(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def blend_loop(feat, meta, kw, gates=None):
    """The training blend written as the CUDA reference's per-pixel loop
    (float32): (ct [T, 4, n_pix], used [K]). A ``gates`` dict receives the
    (hit, stop) pixel masks of each visited slot."""
    tx, n_pix, chunk = kw["tile_x"], kw["n_pix"], kw["chunk"]
    f32 = np.float32
    ct = np.zeros((kw["num_tiles"], 4, n_pix), f32)
    used = np.zeros(feat.shape[1], np.int64)
    for t in range(kw["num_tiles"]):
        ox, oy = (t % kw["grid_x"]) * tx, (t // kw["grid_x"]) * kw["tile_y"]
        chunks = [c for c in range(len(meta)) if meta[c] >> 2 == t]
        T = np.ones(n_pix, f32)
        done = np.zeros(n_pix, bool)
        col = np.zeros((3, n_pix), f32)
        px = (np.arange(n_pix) % tx).astype(f32)
        py = (np.arange(n_pix) // tx).astype(f32)
        for c in chunks:
            for g in range(c * chunk, (c + 1) * chunk):
                x, y, a, b, cc, opa = feat[:6, g]
                dx, dy = px - (x - f32(ox)), py - (y - f32(oy))
                power = f32(-0.5) * (a * dx * dx + cc * dy * dy) - b * dx * dy
                alpha = np.minimum(f32(ttile.ALPHA_MAX), opa * exp32(power))
                alpha = np.where((power > 0) | (alpha < ttile.ALPHA_MIN),
                                 f32(0), alpha).astype(f32)
                t_next = T * (f32(1) - alpha)
                live = (alpha > 0) & ~done
                stop = live & (t_next < ttile.T_EPS)
                hit = live & ~stop
                col += feat[6:9, g, None] * np.where(hit, alpha * T, f32(0))
                T = np.where(hit, t_next, T)
                done |= stop
                used[g] = hit.sum()
                if gates is not None:
                    gates[g] = (hit, stop)
            if done.all():
                break
        ct[t, :3], ct[t, 3] = col, T
    return ct, used


@pytest.mark.parametrize("case", list(BLEND_CASES))
def test_tile_blend_forward_plain_matches_loop(case):
    feat, meta, _, kw = blend_case(case)
    want_ct, want_used = blend_loop(feat, meta, kw)
    ct, used = ttile.tile_blend_forward(torch.from_numpy(feat),
                                        torch.from_numpy(meta), **kw)
    assert used.dtype == torch.int32
    n_pix, chunk = kw["n_pix"], kw["chunk"]
    if BLEND_CASES[case] is None:
        # grazing splats: some barely pass at their contour's pixel
        assert (want_used[:chunk - 8] > 0).mean() > 0.5
    else:
        # tile 0 saturates: every pixel latched done inside its 3 chunks,
        # the third never visited; tile 1 has no chunks
        assert want_ct[0, 3].max() < 0.05
        assert (want_used[2 * chunk:3 * chunk] == 0).all()
        np.testing.assert_array_equal(
            ct[1].numpy(), np.r_[np.zeros((3, n_pix)), np.ones((1, n_pix))])
    np.testing.assert_array_equal(used.numpy(), want_used)
    np.testing.assert_allclose(ct.numpy(), want_ct, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(BLEND_CASES))
def test_tile_blend_backward_plain_matches_autograd_of_loop(case):
    """The plain backward against torch autograd through the per-pixel
    loop written with differentiable ops (float64 for the reference; the
    branches at 1/255 and 1e-4 are the float32 loop's, as the plain
    version takes them)."""
    feat, meta, dpack, kw = blend_case(case)
    gates = {}
    ct, _ = blend_loop(feat, meta, kw, gates)
    f = torch.from_numpy(feat).double().requires_grad_(True)
    tx, n_pix, chunk = kw["tile_x"], kw["n_pix"], kw["chunk"]
    loss = 0.0
    for t in range(kw["num_tiles"]):
        ox, oy = (t % kw["grid_x"]) * tx, (t // kw["grid_x"]) * kw["tile_y"]
        px = torch.arange(n_pix, dtype=torch.float64) % tx
        py = torch.div(torch.arange(n_pix), tx, rounding_mode="floor")
        T = torch.ones(n_pix, dtype=torch.float64)
        col = torch.zeros(3, n_pix, dtype=torch.float64)
        for c in [c for c in range(len(meta)) if meta[c] >> 2 == t]:
            for g in range(c * chunk, (c + 1) * chunk):
                if g not in gates:       # past the tile's stop
                    break
                hit = torch.from_numpy(gates[g][0])
                dx, dy = px - (f[0, g] - ox), py - (f[1, g] - oy)
                power = (-0.5 * (f[2, g] * dx * dx + f[4, g] * dy * dy)
                         - f[3, g] * dx * dy)
                raw = f[5, g] * torch.exp(power)
                # the 0.99 clamp passes the gradient through
                alpha = raw - (raw - ttile.ALPHA_MAX).clamp(min=0).detach()
                col = col + f[6:9, g, None] * torch.where(hit, alpha * T, 0)
                T = torch.where(hit, T * (1 - alpha), T)
        d = torch.from_numpy(dpack[t]).double()
        loss = loss + (d[:3] * col).sum() + (d[3] * T).sum()
    loss.backward()
    want = f.grad.numpy()
    # the plain backward reads D = <dC, C> + dT T from the forward's values
    dp = dpack.copy()
    dp[:, 3] = (dpack[:, :3] * ct[:, :3]).sum(1) + dpack[:, 3] * ct[:, 3]
    got = ttile.tile_blend_backward(torch.from_numpy(feat),
                                    torch.from_numpy(meta),
                                    torch.from_numpy(dp), **kw).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def f32(v):
    return torch.tensor(np.float32(v))


def cull_extent(a, b, c, opa):
    """The port's transcription of blend_kernels.cu::cull_extent on float32
    scalars: half extents (hx, hy), -1 for a slot that never passes, inf
    when the box is unknown."""
    return ttile.blend_cull_extent(f32(a), f32(b), f32(c), f32(opa))


def block_meets(xl, yl, hx, hy, x0, x1, y0, y1):
    """blend_kernels.cu::meets: may a pixel of [x0, x1] x [y0, y1] (tile
    coordinates) pass, for a slot at tile-local mean (xl, yl)?"""
    return bool(ttile.blend_cull_meets(f32(xl), f32(yl), hx, hy,
                                       *map(f32, (x0, x1, y0, y1))))


def passing_pixels(xl, yl, a, b, c, opa, x0, x1, y0, y1):
    """Pixels of the block whose float32 alpha, in the plain version's
    operation order, passes 1/255 (power <= 0 too)."""
    f = np.float32
    xs, ys = np.meshgrid(np.arange(x0, x1 + 1, dtype=f),
                         np.arange(y0, y1 + 1, dtype=f))
    dx, dy = xs - f(xl), ys - f(yl)
    a, b, c, opa = f(a), f(b), f(c), f(opa)
    with np.errstate(over="ignore", invalid="ignore"):
        power = f(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = np.minimum(f(ttile.ALPHA_MAX), opa * np.exp(power))
    return (power <= 0) & (alpha >= f(ttile.ALPHA_MIN))


@given(log_s=st.tuples(st.floats(-0.6, 2.5), st.floats(-0.6, 2.5)),
       theta=st.floats(0.0, np.pi), opa=st.floats(1e-4, 1.0),
       mean=st.tuples(st.floats(-40, 40), st.floats(-40, 40)),
       size=st.tuples(st.integers(1, 16), st.integers(1, 8)),
       near=st.booleans(), shift=st.tuples(st.integers(-2, 2),
                                           st.integers(-2, 2)),
       far=st.tuples(st.integers(-60, 60), st.integers(-60, 60)))
@settings(max_examples=300, deadline=None)
def test_cull_box_never_drops_a_passing_pixel(log_s, theta, opa, mean, size,
                                              near, shift, far):
    """No (slot, pixel block) pair that the cull box drops holds a pixel
    whose float32 alpha passes 1/255, over conics up to 10^3 : 1 in scale,
    every opacity and blocks that straddle the box's edge."""
    s1, s2 = 10.0 ** log_s[0], 10.0 ** log_s[1]
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]])
    a, b, _, c = np.linalg.inv(rot @ np.diag([s1 * s1, s2 * s2])
                               @ rot.T).ravel().astype(np.float32)
    xl, yl = np.float32(mean[0]), np.float32(mean[1])
    hx, hy = cull_extent(a, b, c, opa)
    w, h = size
    if near and np.isfinite(float(hx)) and hx > 0:  # at the box's edge
        x0 = int(np.floor(xl + float(hx))) + shift[0]
        y0 = int(np.floor(yl - h / 2)) + shift[1]
    else:
        x0, y0 = far
    x1, y1 = x0 + w - 1, y0 + h - 1
    if not block_meets(xl, yl, hx, hy, x0, x1, y0, y1):
        assert not passing_pixels(xl, yl, a, b, c, opa, x0, x1, y0,
                                  y1).any()


def test_cull_box_drops_far_and_faint_slots():
    """The box must cull: a splat far from the block, and one whose
    opacity is below 1/255 sitting on the block; a conic that is not
    positive definite is never culled."""
    a, b, c = 0.5, 0.1, 0.4
    hx, hy = cull_extent(a, b, c, 0.9)
    assert 0 < hx < 10 and 0 < hy < 10
    assert not block_meets(100.0, 3.0, hx, hy, 0, 15, 0, 7)
    assert block_meets(10.0, 3.0, hx, hy, 0, 15, 0, 7)
    faint = cull_extent(a, b, c, np.float32(1 / 255) * np.float32(0.999))
    assert not block_meets(3.0, 3.0, *faint, 0, 15, 0, 7)
    assert not block_meets(3.0, 3.0, *cull_extent(a, b, c, 0.0), 0, 15, 0, 7)
    for bad in ((0.5, 0.6, 0.4), (-0.5, 0.0, 0.4), (np.nan, 0.0, 0.4)):
        assert block_meets(1e4, 1e4, *cull_extent(*bad, 0.9), 0, 15, 0, 7)


def test_multi_cumsum_plain_matches_float64():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 3 * 4096 + 77)).astype(np.float32) + 0.5
    got = tscan.multi_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.cumsum(x, axis=1, dtype=np.float64),
                               atol=2e-3, rtol=1e-5)


def cummax_case(n, k, seed):
    """[n, K] int32 rows: random values, an INT_MIN prefix in row 0, a
    descending row and a constant row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31 - 1, size=(n, k), dtype=np.int64)
    x = x.astype(np.int32)
    if k:
        x[0, :min(k, 5000)] = np.iinfo(np.int32).min
        if n > 1:
            x[1] = np.sort(x[1])[::-1]
        if n > 2:
            x[2] = 7
    return x


@pytest.mark.parametrize("n,k", [(3, 4096 * 2 + 77), (2, 1), (1, 0),
                                 (4, 4096)])
def test_multi_cummax_plain_matches_loop(n, k):
    x = cummax_case(n, k, seed=k)
    want = x.copy()
    for row in want:
        for i in range(1, k):
            row[i] = max(row[i], row[i - 1])
    got = tscan.multi_cummax(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (n, k)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tscan.multi_cummax(torch.from_numpy(x).long())
    with pytest.raises(ValueError):
        tscan.multi_cummax(torch.zeros(4, 6, dtype=torch.int32)[:, ::2])


def all_bf16_frame(h=97, w=115, seed=0):
    """bf16 [3, h, w] holding every finite bf16 value in [-0.25, 1.25]
    (so the neighbours of each k/255 and (k + 0.5)/255, of 0 and of 1, and
    values beyond them), shuffled, the rest of the frame repeating them.
    The default shape is odd: h * w is no multiple of 4 or of a tile."""
    bits = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16)
    x = bits.float()
    vals = bits[torch.isfinite(x) & (x >= -0.25) & (x <= 1.25)]
    n = 3 * h * w
    assert vals.numel() <= n
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    return vals.repeat(-(-n // vals.numel()))[:n][perm].reshape(3, h, w)


def test_encode_rgb8_plain_matches_numpy_encode():
    """The plain served-frame encode gives, bit for bit, numpy's float32
    encode (the server's bytes before the encode moved to the device),
    over every bf16 value of [-0.25, 1.25]; every level 0-255 occurs."""
    img = all_bf16_frame()
    got = ttile.encode_rgb8(img)
    assert got.dtype == torch.uint8 and got.shape == (97, 115, 3)
    assert got.is_contiguous()
    assert got.numpy().tobytes() == numpy_encode(img)
    assert torch.equal(ttile.encode_rgb8_plain(img), got)
    assert torch.unique(got).numel() == 256


def test_wrappers_reject_bad_inputs():
    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tscan.expand_scan(i32.long(), i32)
    with pytest.raises(ValueError):
        tscan.expand_scan(i32, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        tscan.merge_expand(torch.zeros((2, 4), dtype=torch.int32),
                           torch.zeros((2, 4), dtype=torch.int32), 8)
    feat = torch.zeros(9, 256, dtype=torch.bfloat16)
    meta = torch.zeros(2, dtype=torch.int32)
    kw = dict(num_tiles=1, tile_x=16, tile_y=16, grid_x=1, chunk=128)
    with pytest.raises(ValueError):
        ttile.render_forward(feat[:8], meta, torch.zeros(3), n_pix=256, **kw)
    with pytest.raises(ValueError):
        ttile.render_forward(feat, meta[:1], torch.zeros(3), n_pix=256, **kw)
    with pytest.raises(ValueError):
        ttile.render_forward(feat, meta, torch.zeros(3), n_pix=200, **kw)
    with pytest.raises(ValueError):
        ttile.tile_blend_forward(feat.float(), meta.long(), n_pix=256, **kw)
    with pytest.raises(ValueError):
        ttile.tile_blend_backward(feat.float(), meta,
                                  torch.zeros(1, 3, 256), n_pix=256, **kw)
    with pytest.raises(ValueError):
        tscan.multi_cumsum(torch.zeros(9, 10, dtype=torch.float64))
    img = torch.zeros(3, 4, 5, dtype=torch.bfloat16)
    for bad in (img.float(), img[0], img[:2], img.to("meta")):
        with pytest.raises(ValueError):
            ttile.encode_rgb8(bad)


def test_extension_sources_and_flags():
    """The build compiles every kernel source in csrc/ for sm_90a, with
    PyTorch's headers in the one binding file only."""
    for name in cuda_ext.SOURCES:
        text = (cuda_ext.CSRC / name).read_text()
        assert ("torch/extension.h" in text) == (name == "binding.cpp"), name
    headers = list(cuda_ext.CSRC.glob("*.cuh"))
    assert headers and not any("torch/" in h.read_text() for h in headers)
    assert "-gencode=arch=compute_90a,code=sm_90a" in cuda_ext.CUDA_FLAGS
    cu = sorted(p.name for p in cuda_ext.CSRC.glob("*.cu"))
    assert cu == sorted(s for s in cuda_ext.SOURCES if s.endswith(".cu"))


# ---------------------------------------------------------------- GPU ----

def expand_kind_case(kind, k, seed=0):
    """expand_case, or: all-zero marks ("zeros"), a single mark at slot
    K - 1 ("last"), marks on ~10% of the slots ("dense")."""
    if kind == "sparse":
        return expand_case(k, seed)
    marks = np.zeros(k, np.int32)
    if kind == "last":
        marks[k - 1] = 12345
    elif kind == "dense":
        rng = np.random.default_rng(seed)
        pos = np.flatnonzero(rng.uniform(size=k) < 0.1)
        marks[pos] = rng.integers(1, 1 << 30, pos.shape[0])
    base_in = np.where(marks != 0, np.arange(k, dtype=np.int32), 0)
    return marks, base_in.astype(np.int32)


# (kind, K): around the 4096-slot tile edges, several windows of look-back
# (more than 32 tiles), and the serving frame's K = 8M
EXPAND_CASES = [("sparse", k) for k in (700, 4095, 4096, 4097, 8191, 8192,
                                        3 * 4096 + 511, 1 << 20)] + [
    ("zeros", 5 * 4096), ("last", 40 * 4096 + 3), ("last", 1),
    ("dense", 200 * 4096 + 17), ("dense", 8_000_000)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,k", EXPAND_CASES)
def test_expand_scan_cuda_matches_plain(cuda, kind, k):
    """The single-pass kernel bit-equal to the plain scans; a second and a
    third launch (the look-back state reused under new epochs, once on
    inputs that are not 16-byte aligned) give the same outputs."""
    marks, base_in = expand_kind_case(kind, k, seed=k)
    m, b = torch.from_numpy(marks), torch.from_numpy(base_in)
    want = tscan.expand_scan_plain(m, b)
    before = tscan.expand_scan.launches
    mc, bc = m.to(cuda), b.to(cuda)
    got = tscan.expand_scan(mc, bc)
    again = tscan.expand_scan(mc, bc)
    # one int32 in: every buffer 4 bytes past a 16-byte boundary
    mo = torch.zeros(k + 1, dtype=torch.int32, device=cuda)[1:]
    bo = torch.zeros(k + 1, dtype=torch.int32, device=cuda)[1:]
    mo.copy_(mc)
    bo.copy_(bc)
    shifted = tscan.expand_scan(mo, bo)
    torch.cuda.synchronize()
    assert tscan.expand_scan.launches == before + 3
    for g, a, h, w in zip(got, again, shifted, want):
        assert torch.equal(g.cpu(), w)
        assert torch.equal(g, a)
        assert torch.equal(h.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4096, 41 * 4096 + 5, 8_000_000])
def test_expand_scan_cuda_stays_in_its_state_buffer(cuda, k):
    """The kernel writes no further than expand_scan_state_words(k) words
    of the look-back state (sentinel words after them stay), leaves its
    ticket counter at 0 and the call's epoch (one more a call) beside it,
    in the header's high 32 bits, for the next call, and gives the plain
    outputs."""
    ext = cuda_ext.load()
    marks, base_in = expand_kind_case("dense", k, seed=1)
    m, b = torch.from_numpy(marks), torch.from_numpy(base_in)
    want = tscan.expand_scan_plain(m, b)
    words = ext.expand_scan_state_words(k)
    state = torch.full((words + 256,), -7, dtype=torch.int64, device=cuda)
    state[:words] = 0
    outs = [torch.empty(k, dtype=torch.int32, device=cuda) for _ in range(3)]
    for epoch in (1, 2):
        ext.expand_scan(m.to(cuda), b.to(cuda), state, *outs)
        torch.cuda.synchronize()
        assert bool((state[words:] == -7).all())
        assert int(state[0]) == epoch << 32
        for g, w in zip(outs, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("p_act,p_total,k", MERGE_CASES + MERGE_MORE_CASES)
def test_merge_expand_cuda_matches_plain(cuda, p_act, p_total, k):
    """The merge-path kernel bit-equal to the plain version on every slot,
    one launch a call."""
    starts, pack, _ = merge_case(p_act, p_total)
    s, p = torch.from_numpy(starts), torch.from_numpy(pack)
    want = tscan.merge_expand_plain(s, p, k)
    before = tscan.merge_expand.launches
    got = tscan.merge_expand(s.to(cuda), p.to(cuda), k)
    torch.cuda.synchronize()
    assert tscan.merge_expand.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def within_bf16_ulps(got, want, ulps=2):
    """|got - want| <= ``ulps`` bf16 ULPs of the larger magnitude."""
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulps * ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_forward_cuda_matches_plain(cuda, case):
    """The render kernel (exact culling, tiles over 8 warps split over a
    cluster with a shared tile-wide stop) within two bf16 ULPs of its
    plain version on the card, and two launches bit-equal."""
    feat, meta, kw = render_stream(case)
    f = torch.from_numpy(feat).to(torch.bfloat16).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    bgc = torch.tensor(BG, device=cuda)
    want, visits = ttile.render_plain_with_visits(f, m, bgc, **kw)
    before = ttile.render_forward.launches
    got = ttile.render_forward(f, m, bgc, **kw)
    again = ttile.render_forward(f, m, bgc, **kw)
    torch.cuda.synchronize()
    assert ttile.render_forward.launches == before + 2
    assert within_bf16_ulps(got.float(), want.float())
    assert torch.equal(got, again)
    if case.startswith("stop"):
        assert int(visits[0]) == 2     # the tile stopped mid-way
    if case.startswith("halfstop"):
        assert int(visits[0]) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("tiles,k_dup,cap", [((16, 16), 1536, 400),
                                             ((16, 16), 1536, 1000),
                                             ((128, 32), 1536, 400)])
def test_render_cuda_matches_cpu_port(cuda, tiles, k_dup, cap):
    """The whole slice on the card (both expansion branches and the render
    kernel) against the port on the CPU."""
    width = 256 if tiles[0] == 128 else 80
    out = []
    for dev in ("cpu", cuda):
        s, c = torch_scene(width=width, height=64, cap=cap, device=dev)
        out.append(trasterize.render_image(
            s.xyz, s.get_scaling(), s.get_rotation(), s.get_opacity()[:, 0],
            s.get_features(), c, 1, BG, k_dup, alive=s.alive_mask,
            tile_x=tiles[0], tile_y=tiles[1]))
    (want, want_dup), (got, got_dup) = out
    torch.cuda.synchronize()
    assert int(got_dup) == int(want_dup)
    assert within_bf16_ulps(got.float().cpu(), want.float())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BLEND_CASES))
def test_tile_blend_cuda_matches_plain(cuda, case):
    """Blend forward and backward kernels against their plain versions on
    the card (same expf, so the same threshold branches; the kernels'
    culling must not drop a pair that passes 1/255); two backward launches
    give the same dfeat bit for bit."""
    feat, meta, dpack, kw = blend_case(case)
    f, m, d = (torch.from_numpy(a).to(cuda) for a in (feat, meta, dpack))
    want_ct, want_used = ttile.tile_blend_forward_plain(f, m, **kw)
    want_d = ttile.tile_blend_backward_plain(f, m, d, **kw)
    before = (ttile.tile_blend_forward.launches,
              ttile.tile_blend_backward.launches)
    ct, used = ttile.tile_blend_forward(f, m, **kw)
    dfeat = ttile.tile_blend_backward(f, m, d, **kw)
    again = ttile.tile_blend_backward(f, m, d, **kw)
    torch.cuda.synchronize()
    assert (ttile.tile_blend_forward.launches,
            ttile.tile_blend_backward.launches) == (before[0] + 1,
                                                    before[1] + 2)
    assert torch.equal(used, want_used)
    assert float((ct - want_ct).abs().max()) <= 1e-5
    scale = want_d.abs().amax(dim=1, keepdim=True) + 1e-12
    assert float(((dfeat - want_d) / scale).abs().max()) <= 1e-4
    assert torch.equal(dfeat, again)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [77, 4096, 3 * 4096 + 511, (1 << 20) + 3])
def test_multi_cumsum_cuda_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32) + 0.5)
    want = torch.cumsum(x.double(), dim=1)
    got = tscan.multi_cumsum(x.to(cuda))
    torch.cuda.synchronize()
    err = (got.cpu().double() - want).abs()
    assert bool((err <= 2e-3 + 1e-5 * want.abs()).all()), float(err.max())
    plain = tscan.multi_cumsum_plain(x.to(cuda)).cpu().double()
    assert bool(((got.cpu().double() - plain).abs()
                 <= 2e-3 + 1e-5 * plain.abs()).all())


@pytest.mark.gpu
def test_multi_cumsum_cuda_launches_are_bit_equal(cuda):
    """Five launches on one input give the same bits (the look-back folds
    the carry in block order whatever it finds published), within the
    float64 gate, on 9 rows of 2^22 + 3 (257 tiles a row, rows not
    16-byte aligned)."""
    rng = np.random.default_rng(4)
    k = (1 << 22) + 3
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32) + 0.5)
    want = torch.cumsum(x.double(), dim=1)
    xc = x.to(cuda)
    before = tscan.multi_cumsum.launches
    outs = [tscan.multi_cumsum(xc) for _ in range(5)]
    torch.cuda.synchronize()
    assert tscan.multi_cumsum.launches == before + 5
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    err = (outs[0].cpu().double() - want).abs()
    assert bool((err <= 2e-3 + 1e-5 * want.abs()).all()), float(err.max())


@pytest.mark.gpu
def test_expand_scan_and_multi_cumsum_keep_separate_state(cuda):
    """expand_scan, multi_cumsum and multi_cummax called in turns on one
    stream, each against its plain version: none reads another's
    look-back state (each kernel has its own buffer and epochs)."""
    marks, base_in = expand_kind_case("dense", 41 * 4096 + 5, seed=2)
    m, b = torch.from_numpy(marks), torch.from_numpy(base_in)
    want_e = tscan.expand_scan_plain(m, b)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(9, 37 * 4096 + 11)).astype(
        np.float32))
    want_c = torch.cumsum(x.double(), dim=1)
    y = torch.from_numpy(cummax_case(3, 29 * 16384 + 5, seed=8))
    want_m = tscan.multi_cummax_plain(y)
    mc, bc, xc, yc = m.to(cuda), b.to(cuda), x.to(cuda), y.to(cuda)
    first = None
    for _ in range(3):
        got_e = tscan.expand_scan(mc, bc)
        got_c = tscan.multi_cumsum(xc)
        torch.cuda.synchronize()
        for g, w in zip(got_e, want_e):
            assert torch.equal(g.cpu(), w)
        err = (got_c.cpu().double() - want_c).abs()
        assert bool((err <= 2e-3 + 1e-5 * want_c.abs()).all())
        first = got_c if first is None else first
        assert torch.equal(got_c, first)
        got_m = tscan.multi_cummax(yc)
        torch.cuda.synchronize()
        assert torch.equal(got_m.cpu(), want_m)
    keys = {key[0] for key in tscan._LOOKBACK}
    assert {"expand_scan", "multi_cumsum", "multi_cummax"} <= keys


@pytest.mark.gpu
def test_training_rasterize_cuda_matches_cpu_port(cuda):
    """The training path on the card (blend kernels, scatter-add
    reduction) against the port on the CPU: image, T, is_used, grads."""
    outs = []
    for dev in ("cpu", cuda):
        state, cam = torch_scene(device=dev)
        settings = trasterize.RasterizeSettings(k_dup=1536, tile_x=16,
                                                tile_y=16)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in state.params().items()}
        s = state.replace_params(params)
        out = trasterize.rasterize(
            s.xyz, s.get_scaling(), s.get_rotation(), s.get_opacity()[:, 0],
            s.get_features(), cam, 1, torch.tensor(BG, device=dev), settings,
            alive=s.alive_mask)
        w = torch.linspace(-1, 1, out.image.numel(), device=dev)
        loss = (out.image.reshape(-1) * w).sum() + out.final_t.sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        outs.append((out, [g.cpu() for g in grads]))
    (co, cg), (go, gg) = outs
    torch.cuda.synchronize()
    assert torch.equal(go.is_used.cpu(), co.is_used)
    assert torch.equal(go.radii.cpu(), co.radii)
    assert float((go.image.detach().cpu() - co.image.detach()).abs().max()
                 ) <= 5e-5
    assert float((go.final_t.detach().cpu() - co.final_t.detach()).abs(
        ).max()) <= 5e-5
    for a, b in zip(gg, cg):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(3, 77), (1, 4096), (3, 3 * 4096 + 511),
                                 (2, (1 << 20) + 3), (1, 0), (1, 1),
                                 (3, 16383), (3, 16384), (3, 16385),
                                 (3, 8_000_000)])
def test_multi_cummax_cuda_matches_plain(cuda, n, k):
    x = torch.from_numpy(cummax_case(n, k, seed=k))
    want = tscan.multi_cummax_plain(x)
    before = tscan.multi_cummax.launches
    got = tscan.multi_cummax(x.to(cuda))
    torch.cuda.synchronize()
    assert tscan.multi_cummax.launches == before + (1 if k else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_multi_cummax_cuda_launches_are_bit_equal(cuda):
    """Five launches on one input, each one launch, all equal to
    torch.cummax, on 3 rows of 2^22 + 3 (257 tiles a row, rows not
    16-byte aligned)."""
    x = torch.from_numpy(cummax_case(3, (1 << 22) + 3, seed=5))
    want = tscan.multi_cummax_plain(x)
    xc = x.to(cuda)
    before = tscan.multi_cummax.launches
    outs = [tscan.multi_cummax(xc) for _ in range(5)]
    torch.cuda.synchronize()
    assert tscan.multi_cummax.launches == before + 5
    for o in outs:
        assert torch.equal(o.cpu(), want)


@pytest.mark.gpu
def test_multi_cummax_cuda_restarts_when_epochs_run_out(cuda):
    """The packed status word holds a 30-bit epoch: the kernel's epoch
    (the high 32 bits of its state's first word, the ticket below them)
    runs up to limit - 1 and starts again at 1, and the results stay equal
    to torch.cummax across the restart."""
    x = torch.from_numpy(cummax_case(2, 5 * 16384 + 9, seed=9))
    want = tscan.multi_cummax_plain(x)
    xc = x.to(cuda)
    assert torch.equal(tscan.multi_cummax(xc).cpu(), want)
    key = next(key for key in tscan._LOOKBACK if key[0] == "multi_cummax")
    state = tscan._LOOKBACK[key]
    limit = cuda_ext.load().multi_cummax_epoch_limit()
    state[0] = (limit - 3) << 32
    for epoch_after in (limit - 2, 0, 1):  # epochs limit-2, limit-1, 1
        assert torch.equal(tscan.multi_cummax(xc).cpu(), want)
        assert int(state[0]) == epoch_after << 32


def scan_inputs(kernel, gen, device):
    """New inputs of ``kernel`` drawn on the card: expand_scan's sparse
    marks and base_in over 2M slots (489 tiles), 3 rows of 2^20 + 5
    floats for multi_cumsum or int32s for multi_cummax (65 tiles a row)."""
    if kernel == "expand_scan":
        k = 2_000_003
        hit = torch.rand(k, generator=gen, device=device) < 0.01
        marks = torch.where(hit, torch.randint(
            1, 1 << 20, (k,), generator=gen, device=device,
            dtype=torch.int32), 0)
        base_in = torch.where(hit, torch.arange(
            k, dtype=torch.int32, device=device), 0)
        return marks, base_in
    shape = (3, (1 << 20) + 5)
    if kernel == "multi_cumsum":
        return (torch.randn(shape, generator=gen, device=device) + 0.5,)
    return (torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                          device=device, dtype=torch.int32),)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["expand_scan", "multi_cumsum",
                                    "multi_cummax"])
def test_scan_replayed_in_a_cuda_graph_matches_plain(cuda, kernel):
    """The scan captured in a CUDA graph and replayed 50 times, new inputs
    copied into the captured ones before each replay and an eager call of
    the same kernel on them between replays: each replay's output is
    bit-equal to the plain version (multi_cumsum: to the eager launch,
    which is within 2e-3 + 1e-5 |x| of a float64 cumsum). The kernel keeps
    its look-back epoch on the device, so each replay tags its status
    words anew; an epoch passed from the host is captured once, and a
    replay then takes the last replay's words for published."""
    run = getattr(tscan, kernel)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    static = scan_inputs(kernel, gen, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(*static)                 # the graph's look-back buffer
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = run(*static)
    for _ in range(50):
        new = scan_inputs(kernel, gen, cuda)
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        eager = run(*new)
        if kernel == "multi_cumsum":
            assert torch.equal(out, eager)
            want = torch.cumsum(new[0].double(), dim=1)
            assert bool(((eager.double() - want).abs()
                         <= 2e-3 + 1e-5 * want.abs()).all())
        elif kernel == "multi_cummax":
            want = tscan.multi_cummax_plain(new[0])
            assert torch.equal(out, want) and torch.equal(eager, want)
        else:
            for o, e, w in zip(out, eager, tscan.expand_scan_plain(*new)):
                assert torch.equal(o, w) and torch.equal(e, w)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [400, 12_000])
def test_graphed_served_frame_equals_eager(cuda, cap):
    """The server's render (``serve.make_render_fn``, through
    ``FrameGraph``) over 8 orbit cameras, byte-equal to eager
    ``render_frame``, at an expand_scan budget (cap 400: 2K >= 7P, 10 scan
    tiles) and a merge_expand one (cap 12,000), then camera 0 again at
    scale modifier 0.8: each returned frame unchanged by the later calls;
    one capture and a replay a later frame, the new scale modifier
    included (counters, under a profiler session); in the profiler's CUDA
    trace, the owner expansion's, the render's and the encode's kernels
    each running 10 times (the first frame's eager warm-up and replay,
    then 8 replays), the other owner expansion's never."""
    import bench_torch
    from torch.profiler import ProfilerActivity
    from gsplat_tpu_torch.utils import profiling
    from gsplat_tpu_torch.viewer import serve

    w, h, k_dup = 256, 64, 40_000
    state, _ = torch_scene(width=w, height=h, cap=cap, device=cuda)
    cams = bench_torch.orbit_cameras(8, w, h, cuda)
    rows = (state.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], state.get_features())
    bg = torch.zeros(3, device=cuda)
    calls = [(cam, 1.0) for cam in cams] + [(cams[0], 0.8)]
    want = [trasterize.render_frame(*rows, cam, 1, bg, k_dup,
                                    alive=state.alive_mask,
                                    scale_modifier=scale)[0]
            for cam, scale in calls]
    assert float(torch.stack(want).float().mean()) > 2
    assert not torch.equal(want[0], want[-1])
    expand = 2 * k_dup >= 7 * cap
    render = serve.make_render_fn(state, k_dup, w, h, cuda)
    torch.cuda.synchronize()
    profiling.reset()
    try:
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = [render(cam, scale) for cam, scale in calls]
            torch.cuda.synchronize()
        counters = profiling.counters()
    finally:
        profiling.reset()
    ran = {name: sum(e.count for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")
                     and name in e.key)
           for name in ("expand_scan_kernel", "merge_expand_kernel",
                        "render_kernel", "encode_rgb8_kernel")}
    assert ran == {"expand_scan_kernel": 10 if expand else 0,
                   "merge_expand_kernel": 0 if expand else 10,
                   "render_kernel": 10, "encode_rgb8_kernel": 10}
    assert counters == {"raster.graph_capture": 1,
                        "raster.graph_replay": 8}
    for g, e in zip(got, want):
        assert torch.equal(g, e)


def zero_row_probs(rows=50_000, alive=49_500, seed=0):
    """[rows] float32 densification probabilities: opacity-like values,
    some zero rows, a zero row at each multi_cumsum tile join and zeros
    past ``alive``."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.005, 1.0, rows).astype(np.float32)
    p[rng.uniform(size=rows) < 0.05] = 0.0
    p[np.arange(tscan.CUMSUM_BLOCK, rows, tscan.CUMSUM_BLOCK)] = 0.0
    p[alive:] = 0.0
    return torch.from_numpy(p)


@pytest.mark.gpu
def test_template_sampler_on_card_is_reproducible(cuda):
    """The densification's template draw twice from one seed on the card:
    one multi_cumsum and one multi_cummax launch each, the same templates,
    no zero-probability row; the searched CDF never decreases, is flat at
    zero rows and equals the CPU's within the CDF's float32 rounding."""
    probs = zero_row_probs().to(cuda)
    before = (tscan.multi_cumsum.launches, tscan.multi_cummax.launches)
    draws = []
    for _ in range(2):
        gen = torch.Generator(device=cuda).manual_seed(0)
        draws.append(tmcmc._sample_templates(gen, probs, probs.shape[0]))
    assert (tscan.multi_cumsum.launches,
            tscan.multi_cummax.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(draws[0], draws[1])
    assert int((probs[draws[0]] == 0).sum()) == 0
    cdf = tmcmc._template_cdf(probs)
    zero = torch.nonzero(probs[1:] == 0)[:, 0] + 1
    assert bool((cdf[1:] >= cdf[:-1]).all())
    assert torch.equal(cdf[zero], cdf[zero - 1])
    want = tmcmc._template_cdf(probs.cpu())
    assert float((cdf.cpu() - want).abs().max()) <= 1e-5 * float(want[-1])


@pytest.mark.gpu
def test_scatter_reduce_on_card_is_bit_reproducible(cuda):
    """The scatter-add reduction of the per-slot gradients (200k slots into
    100k rows, 30% padding) three times on the card: bit-equal, and within
    2e-6 of the largest sum of the CPU's."""
    rng = np.random.default_rng(9)
    k, p1 = 200_000, 100_000
    gid = rng.integers(0, p1, k).astype(np.int32)
    gid[rng.uniform(size=k) < 0.3] = p1 - 1
    dfeat = rng.normal(size=(9, k)).astype(np.float32)
    dfeat[:, gid == p1 - 1] = 0.0
    d, g = torch.from_numpy(dfeat), torch.from_numpy(gid)
    outs = [trasterize._scatter_reduce(d.to(cuda), g.to(cuda), p1)
            for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = trasterize._scatter_reduce(d, g, p1)
    scale = float(want.abs().max())
    assert float((outs[0].cpu() - want).abs().max()) / scale <= 2e-6


# (h, w, how): pixel counts that are and are not a multiple of 4, an input
# 2 bytes past an aligned start, a sliced (non-contiguous) input
ENCODE_CASES = [(97, 115, "plain"), (96, 128, "plain"), (1088, 1920, "plain"),
                (96, 128, "offset"), (97, 116, "offset"), (96, 130, "sliced")]


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,how", ENCODE_CASES)
def test_encode_rgb8_cuda_matches_plain(cuda, h, w, how):
    """The served-frame encode kernel bit-equal to its plain version on
    every bf16 value of [-0.25, 1.25], aligned or not, one launch a call;
    it refuses float32, rank 2 and host tensors."""
    img = all_bf16_frame(h, w, seed=h * w)
    want = ttile.encode_rgb8_plain(img)
    x = img.to(cuda)
    if how == "offset":
        buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(3, h, w)
    elif how == "sliced":
        x = x[:, :, 1:]
        want = ttile.encode_rgb8_plain(img[:, :, 1:])
    before = ttile.encode_rgb8.launches
    got = ttile.encode_rgb8(x)
    torch.cuda.synchronize()
    assert ttile.encode_rgb8.launches == before + 1
    assert got.is_contiguous() and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), want)
    for bad in (x.float(), x[0]):
        with pytest.raises(ValueError):
            ttile.encode_rgb8(bad)
    out = torch.empty(want.shape, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_ext.load().encode_rgb8(img, out)


@pytest.mark.gpu
def test_uint8_frame_copies_through_a_reused_pinned_buffer(cuda):
    """A uint8 frame on the card: its bytes through one page-locked buffer
    a shape, reused from call to call; the card's encode gives numpy's
    bytes; a float frame is refused."""
    frames = [torch.randint(0, 256, (64, 96, 3), dtype=torch.uint8)
              for _ in range(3)]
    for f in frames:
        assert network_gui.image_to_bytes(f.to(cuda)) == f.numpy().tobytes()
    buf = network_gui._pinned_frame((64, 96, 3), frames[0].to(cuda).device)
    assert buf.is_pinned() and torch.equal(buf, frames[-1])
    img = all_bf16_frame().to(cuda)
    assert network_gui.image_to_bytes(ttile.encode_rgb8(img)) == \
        numpy_encode(img)
    with pytest.raises(ValueError, match="uint8"):
        network_gui.image_to_bytes(img.float().permute(1, 2, 0))
