"""gsplat_tpu_torch kernel wrappers, without JAX.

This module imports neither jax nor gsplat_tpu, so it also runs where only
PyTorch is installed (the GPU host):

- on the CPU, each plain PyTorch version is held against a numpy oracle
  written as a loop from the kernel's definition (exact for the integer
  scans, float32 tolerance for the render);
- ``gpu`` tests hold each CUDA kernel against its plain version on the same
  inputs: the scans bit-equal, images within two bf16 ULPs. They skip on a
  host without an NVIDIA GPU. Run them there with
  ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``
  (``--noconftest``: tests/conftest.py configures JAX).

The case builders here are shared by the JAX parity tests.
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import renderer as trenderer
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.raster import binning as tbinning
from gsplat_tpu_torch.raster import cuda_ext
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import scan_kernel as tscan
from gsplat_tpu_torch.raster import tile_kernel as ttile

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


# (active rows, total rows, slots)
MERGE_CASES = [(50, 80, 700), (1000, 1200, 5000), (3, 5, 40), (0, 4, 30),
               (600, 600, 512), (513, 513, 2048), (1500, 2000, 9000)]


def merge_case(p_act, p_total, seed=0):
    """Ascending range starts of ``p_act`` non-empty ranges followed by
    empty ones, random packs, and the live slot count."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(p_total, np.int32)
    counts[:p_act] = rng.integers(1, 9, size=p_act)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    pack = rng.integers(1, 1 << 23, size=p_total).astype(np.int32)
    return offsets[:p_total], pack, int(offsets[-1])


def torch_scene(tile_x=16, tile_y=16, width=80, height=48, cap=400,
                k_dup=1536, device="cpu"):
    """A 300-Gaussian state, camera and inference settings on ``device``."""
    par = make_params(cap=cap, seed=11)
    state = tgauss.state_from_numpy(par, 300, 1, device)
    cam = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height,
                              device=device)
    settings = trasterize.RasterizeSettings(k_dup=k_dup, tile_x=tile_x,
                                            tile_y=tile_y, inference=True)
    return state, cam, settings


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


@pytest.mark.parametrize("p_act,p_total,k", MERGE_CASES)
def test_merge_expand_plain_matches_loop(p_act, p_total, k):
    starts, pack, num_dup = merge_case(p_act, p_total)
    got = [g.numpy() for g in tscan.merge_expand(
        torch.from_numpy(starts), torch.from_numpy(pack), k)]
    for d in range(min(num_dup, k)):
        owner = max(g for g in range(p_total) if starts[g] <= d)
        assert (got[0][d], got[1][d], got[2][d]) == (
            pack[owner], starts[owner], owner + 1), d


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


def blend_case(seed=0):
    """``render_case`` as a float32 training stream, with row 3 of a
    random cotangent pack for the backward."""
    feat, meta, kw = render_case(seed)
    rng = np.random.default_rng(seed + 1)
    dpack = rng.normal(size=(kw["num_tiles"], 4, kw["n_pix"])).astype(
        np.float32)
    return feat, meta, dpack, kw


def blend_loop(feat, meta, kw):
    """The training blend written as the CUDA reference's per-pixel loop
    (float32): (ct [T, 4, n_pix], used [K])."""
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
                alpha = np.minimum(f32(ttile.ALPHA_MAX), opa * np.exp(power))
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
            if done.all():
                break
        ct[t, :3], ct[t, 3] = col, T
    return ct, used


def test_tile_blend_forward_plain_matches_loop():
    feat, meta, _, kw = blend_case()
    want_ct, want_used = blend_loop(feat, meta, kw)
    ct, used = ttile.tile_blend_forward(torch.from_numpy(feat),
                                        torch.from_numpy(meta), **kw)
    assert used.dtype == torch.int32
    # tile 0 saturates: every pixel latched done inside its 3 chunks
    assert want_ct[0, 3].max() < 0.05 and (want_used[2 * 16:3 * 16] == 0).all()
    np.testing.assert_array_equal(used.numpy(), want_used)
    np.testing.assert_allclose(ct.numpy(), want_ct, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ct[1].numpy(), np.r_[np.zeros((3, 32)),
                                                       np.ones((1, 32))])


def test_tile_blend_backward_plain_matches_autograd_of_loop():
    """The plain backward against torch autograd through the per-pixel
    loop written with differentiable ops (float64 for the reference)."""
    feat, meta, dpack, kw = blend_case()
    got = ttile.tile_blend_backward(torch.from_numpy(feat),
                                    torch.from_numpy(meta),
                                    torch.from_numpy(dpack), **kw)
    ct, _ = blend_loop(feat, meta, kw)
    f = torch.from_numpy(feat).double().requires_grad_(True)
    tx, n_pix, chunk = kw["tile_x"], kw["n_pix"], kw["chunk"]
    loss = 0.0
    for t in range(kw["num_tiles"]):
        ox, oy = (t % kw["grid_x"]) * tx, (t // kw["grid_x"]) * kw["tile_y"]
        px = torch.arange(n_pix, dtype=torch.float64) % tx
        py = torch.div(torch.arange(n_pix), tx, rounding_mode="floor")
        T = torch.ones(n_pix, dtype=torch.float64)
        done = torch.zeros(n_pix, dtype=torch.bool)
        col = torch.zeros(3, n_pix, dtype=torch.float64)
        for c in [c for c in range(len(meta)) if meta[c] >> 2 == t]:
            for g in range(c * chunk, (c + 1) * chunk):
                dx, dy = px - (f[0, g] - ox), py - (f[1, g] - oy)
                power = (-0.5 * (f[2, g] * dx * dx + f[4, g] * dy * dy)
                         - f[3, g] * dx * dy)
                raw = f[5, g] * torch.exp(power)
                # the 0.99 clamp passes the gradient through
                alpha = raw - (raw - ttile.ALPHA_MAX).clamp(min=0).detach()
                live = ((power <= 0) & (alpha >= ttile.ALPHA_MIN) & ~done)
                t_next = T * (1 - alpha)
                stop = live & (t_next < ttile.T_EPS)
                hit = live & ~stop
                col = col + f[6:9, g, None] * torch.where(hit, alpha * T, 0)
                T = torch.where(hit, t_next, T)
                done = done | stop
            if bool(done.all()):
                break
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


def test_extension_sources_and_flags():
    """The build compiles every kernel source in csrc/ for sm_90a, with
    PyTorch's headers in the one binding file only."""
    for name in cuda_ext.SOURCES:
        text = (cuda_ext.CSRC / name).read_text()
        assert ("torch/extension.h" in text) == (name == "binding.cpp"), name
    assert "-gencode=arch=compute_90a,code=sm_90a" in cuda_ext.CUDA_FLAGS
    cu = sorted(p.name for p in cuda_ext.CSRC.glob("*.cu"))
    assert cu == sorted(s for s in cuda_ext.SOURCES if s.endswith(".cu"))


# ---------------------------------------------------------------- GPU ----

@pytest.mark.gpu
@pytest.mark.parametrize("k", [700, 3 * 4096 + 511, 1 << 20])
def test_expand_scan_cuda_matches_plain(cuda, k):
    marks, base_in = expand_case(k, seed=k)
    m, b = torch.from_numpy(marks), torch.from_numpy(base_in)
    want = tscan.expand_scan_plain(m, b)
    before = tscan.expand_scan.launches
    got = tscan.expand_scan(m.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert tscan.expand_scan.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("p_act,p_total,k", MERGE_CASES)
def test_merge_expand_cuda_matches_plain(cuda, p_act, p_total, k):
    starts, pack, _ = merge_case(p_act, p_total)
    s, p = torch.from_numpy(starts), torch.from_numpy(pack)
    want = tscan.merge_expand_plain(s, p, k)
    got = tscan.merge_expand(s.to(cuda), p.to(cuda), k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def within_bf16_ulps(got, want, ulps=2):
    """|got - want| <= ``ulps`` bf16 ULPs of the larger magnitude."""
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulps * ulp).all())


@pytest.mark.gpu
def test_render_forward_cuda_matches_plain(cuda):
    feat, meta, kw = render_case()
    feat_t = torch.from_numpy(feat).to(torch.bfloat16)
    want = ttile.render_forward(feat_t, torch.from_numpy(meta),
                                torch.tensor(BG), **kw).float()
    got = ttile.render_forward(feat_t.to(cuda), torch.from_numpy(meta).to(
        cuda), torch.tensor(BG, device=cuda), **kw)
    torch.cuda.synchronize()
    assert within_bf16_ulps(got.float().cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles,k_dup,cap", [((16, 16), 1536, 400),
                                             ((16, 16), 1536, 1000),
                                             ((128, 32), 1536, 400)])
def test_render_cuda_matches_cpu_port(cuda, tiles, k_dup, cap):
    """The whole slice on the card (both expansion branches and the render
    kernel) against the port on the CPU."""
    width = 256 if tiles[0] == 128 else 80
    kw = dict(tile_x=tiles[0], tile_y=tiles[1], width=width, height=64,
              cap=cap, k_dup=k_dup)
    state, cam, settings = torch_scene(**kw)
    want = trenderer.render(cam, state, BG, settings)
    g_state, g_cam, _ = torch_scene(**kw, device=cuda)
    got = trenderer.render(g_cam, g_state, BG, settings)
    torch.cuda.synchronize()
    assert int(got["num_dup"]) == int(want["num_dup"])
    assert torch.equal(got["radii"].cpu(), want["radii"])
    assert within_bf16_ulps(got["render"].float().cpu(),
                            want["render"].float())


@pytest.mark.gpu
def test_tile_blend_cuda_matches_plain(cuda):
    """Blend forward and backward kernels against their plain versions on
    the card (same expf, so the same threshold branches)."""
    feat, meta, dpack, kw = blend_case()
    f, m, d = (torch.from_numpy(a).to(cuda) for a in (feat, meta, dpack))
    want_ct, want_used = ttile.tile_blend_forward_plain(f, m, **kw)
    want_d = ttile.tile_blend_backward_plain(f, m, d, **kw)
    before = (ttile.tile_blend_forward.launches,
              ttile.tile_blend_backward.launches)
    ct, used = ttile.tile_blend_forward(f, m, **kw)
    dfeat = ttile.tile_blend_backward(f, m, d, **kw)
    torch.cuda.synchronize()
    assert (ttile.tile_blend_forward.launches,
            ttile.tile_blend_backward.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.equal(used, want_used)
    assert float((ct - want_ct).abs().max()) <= 1e-5
    scale = want_d.abs().amax(dim=1, keepdim=True) + 1e-12
    assert float(((dfeat - want_d) / scale).abs().max()) <= 1e-4


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
def test_training_rasterize_cuda_matches_cpu_port(cuda):
    """The training path on the card (blend kernels, scatter-add
    reduction) against the port on the CPU: image, T, is_used, grads."""
    outs = []
    for dev in ("cpu", cuda):
        state, cam, settings = torch_scene(device=dev)
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
    assert float((go.image.detach().cpu() - co.image.detach()).abs().max()
                 ) <= 5e-5
    assert float((go.final_t.detach().cpu() - co.final_t.detach()).abs(
        ).max()) <= 5e-5
    for a, b in zip(gg, cg):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(3, 77), (1, 4096), (3, 3 * 4096 + 511),
                                 (2, (1 << 20) + 3), (1, 0)])
def test_multi_cummax_cuda_matches_plain(cuda, n, k):
    x = torch.from_numpy(cummax_case(n, k, seed=k))
    want = tscan.multi_cummax_plain(x)
    before = tscan.multi_cummax.launches
    got = tscan.multi_cummax(x.to(cuda))
    torch.cuda.synchronize()
    assert tscan.multi_cummax.launches == before + (1 if k else 0)
    assert torch.equal(got.cpu(), want)
