"""Tile and chunk sizes beyond the CUDA kernels' staging sizes, on the CPU:
the port's training rasterizer at 128 x 32 tiles and 256-slot chunks (the
serving tile; a block of the blend kernels holds 1,024 pixels and stages
128 slots, so on the card the kernels walk such a tile in four pixel groups
and each chunk in two pieces) against the JAX package's (Pallas in
interpret mode, as its own tests run it), on one tile.

Image, final T, is_used, radii and num_dup are held to
tests/test_torch_train_raster.py's gates, and so are the gradients of the
means, opacities and SH. The scale and rotation gradients are held to 2e-2
of their largest: at 4,096-pixel tiles JAX's Pallas backward, which
reduces over pixels with bf16 hi/lo matmuls and takes T from an
exp-of-log1p scan, leaves the conic rows of dfeat up to 1.9e-4 of their max
from a float64 loop on this scene (the port: 4.9e-6), and preprocess
carries that into the scale gradients at 9.6e-3 and the rotation ones at
1.1e-3 of their largest (the others: 7.0e-5, 9.3e-5 and 4.3e-6). So the
port's blend gradient itself is held to 1e-5 of each row's max against
autograd through the float64 per-pixel loop.

The card runs the same sizes through the kernels in
tests/test_torch_kernels.py (``BLEND_CASES`` and ``RENDER_CASES`` at
128 x 32 / c256 and 8,192 pixels / c512)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.raster.rasterize import RasterizeSettings as JSettings
from gsplat_tpu.raster.rasterize import rasterize as jrasterize
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.raster import binning as tbinning
from gsplat_tpu_torch.raster import project as tproject
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import tile_kernel as ttile
from tests.test_reference_port import BG, SH_DEGREE, make_scene
from tests.test_torch_kernels import blend_loop
from tests.torch_threads import one_torch_thread  # noqa: F401

TILE_X, TILE_Y, CHUNK = 128, 32, 256
WIDTH, HEIGHT = TILE_X, TILE_Y   # one tile
K_DUP = 1024


def blend_grad_f64(feat, meta, dpack, kw):
    """d(<dC, C> + <dT, T>)/dfeat by autograd through the float32 loop's
    branches (blend_loop) evaluated in float64."""
    gates = {}
    blend_loop(feat, meta, kw, gates)
    f = torch.from_numpy(feat).double().requires_grad_(True)
    n_pix, tx, chunk = kw["n_pix"], kw["tile_x"], kw["chunk"]
    px = torch.arange(n_pix, dtype=torch.float64) % tx
    py = torch.div(torch.arange(n_pix), tx, rounding_mode="floor").double()
    T = torch.ones(n_pix, dtype=torch.float64)
    col = torch.zeros(3, n_pix, dtype=torch.float64)
    for c in [c for c in range(len(meta)) if meta[c] >> 2 == 0]:
        for g in range(c * chunk, (c + 1) * chunk):
            if g not in gates:
                break
            hit = torch.from_numpy(gates[g][0])
            dx, dy = px - f[0, g], py - f[1, g]
            power = (-0.5 * (f[2, g] * dx * dx + f[4, g] * dy * dy)
                     - f[3, g] * dx * dy)
            raw = f[5, g] * torch.exp(power)
            alpha = raw - (raw - ttile.ALPHA_MAX).clamp(min=0).detach()
            col = col + f[6:9, g, None] * torch.where(hit, alpha * T, 0)
            T = torch.where(hit, T * (1 - alpha), T)
    d = torch.from_numpy(dpack[0]).double()
    ((d[:3] * col).sum() + (d[3] * T).sum()).backward()
    return f.grad.numpy()


def test_rasterize_128x32_c256_matches_jax():
    scene = make_scene(p=600, seed=3, stack=40)
    jc = jcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, WIDTH, HEIGHT)
    tc = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, WIDTH, HEIGHT,
                             device="cpu")
    rng = np.random.default_rng(12)
    w_img = rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    w_t = rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32)
    j_settings = JSettings(k_dup=K_DUP, tile_x=TILE_X, tile_y=TILE_Y,
                           chunk=CHUNK, super_chunks=1, interpret=True)

    def jloss(*a):
        o = jrasterize(*a, jc, SH_DEGREE, jnp.asarray(BG), j_settings)
        return jnp.sum(o.image * w_img) + jnp.sum(o.final_t * w_t), o

    (_, jo), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *map(jnp.asarray, scene))

    leaves = [torch.tensor(np.asarray(a), requires_grad=True) for a in scene]
    settings = trasterize.RasterizeSettings(k_dup=K_DUP, tile_x=TILE_X,
                                            tile_y=TILE_Y, chunk=CHUNK,
                                            super_chunks=1)
    out = trasterize.rasterize(*leaves, tc, SH_DEGREE, torch.tensor(BG),
                               settings)
    loss = ((out.image * torch.from_numpy(w_img)).sum()
            + (out.final_t * torch.from_numpy(w_t)).sum())
    grads = torch.autograd.grad(loss, leaves)

    image, final_t = out.image.detach(), out.final_t.detach()
    assert image.shape == (HEIGHT, WIDTH, 3)
    assert 0 < int(out.num_dup) == int(jo.num_dup) <= K_DUP
    assert float(final_t.min()) < 1e-3, "the stop rule must fire"
    np.testing.assert_allclose(image.numpy(), np.asarray(jo.image),
                               atol=5e-5)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(jo.final_t),
                               atol=5e-5)
    np.testing.assert_array_equal(out.is_used.numpy(),
                                  np.asarray(jo.is_used))
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(jo.radii))
    gates = {"means": 2e-4, "scales": 2e-2, "quats": 2e-2,
             "opacities": 2e-4, "shs": 2e-4}
    for (name, gate), got, want in zip(gates.items(), grads, jg):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all(), name
        scale = np.abs(want).max() + 1e-20
        np.testing.assert_allclose(got / scale, want / scale, atol=gate,
                                   err_msg=name)

    # the port's blend gradient on this tile against the float64 loop
    proc = tproject.preprocess(*[torch.tensor(np.asarray(a)) for a in scene],
                               tc, SH_DEGREE)
    binn = tbinning.bin_gaussians(proc, tile_x=TILE_X, tile_y=TILE_Y,
                                  grid_x=1, grid_y=1, k_dup=K_DUP, align=1,
                                  chunk=CHUNK,
                                  feat_table=trasterize._feat_columns(proc))
    feat = trasterize._slot_features(binn.feat_table, binn.gid).float()
    meta = binn.chunk_meta
    kw = dict(num_tiles=1, n_pix=TILE_X * TILE_Y, tile_x=TILE_X,
              tile_y=TILE_Y, grid_x=1, chunk=CHUNK)
    assert int((meta >> 2 == 0).sum()) >= 2, "several chunks in the tile"
    ct, _ = ttile.tile_blend_forward(feat, meta, **kw)
    dpack = rng.normal(size=(1, 4, TILE_X * TILE_Y)).astype(np.float32)
    want = blend_grad_f64(feat.numpy(), meta.numpy(), dpack, kw)
    dp = dpack.copy()
    dp[:, 3] = ((dpack[:, :3] * ct[:, :3].numpy()).sum(1)
                + dpack[:, 3] * ct[:, 3].numpy())
    got = ttile.tile_blend_backward(feat, meta, torch.from_numpy(dp),
                                    **kw).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
