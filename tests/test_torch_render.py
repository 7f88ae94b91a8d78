"""gsplat_tpu_torch's served frame (``render_frame`` / ``render_image``)
and training path against the JAX package.

- ``render_forward`` plain version vs the JAX Pallas ``_render_kernel`` in
  interpret mode, both fed JAX's own ``feat`` / ``chunk_meta``: max abs
  <= 1.6e-2 and mean abs <= 1e-3. The JAX kernel scans log-transmittance
  with a single-pass bf16 matmul and accumulates color from bf16 weights;
  the port composites sequentially in float32; both round the output to
  bf16 (one bf16 ULP in [0.5, 1) is 3.9e-3).
- the whole slice, port ``render_image`` vs JAX ``renderer.render``
  (inference, both expansion branches): PSNR >= 45 dB, ``num_dup`` equal;
  ``render_frame`` is its ``encode_rgb8``.
- port inference vs the JAX training path (``tile_blend``, interpret):
  >= 40 dB and mean abs < 5e-3, as tests/test_raster.py:154-178 gates the
  JAX inference path.
- the port's training path vs JAX's: image, T, ``is_used``, radii.
- the reference's bf16 global x/y rounding on a 1920x32 strip: PSNR by
  column band of the bf16 feature stream against an f32 stream, pinned
  for the port and for JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import renderer as jrenderer
from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.raster import binning as jbinning
from gsplat_tpu.raster import project as jproject
from gsplat_tpu.raster import tile_kernel as jtile
from gsplat_tpu.raster.rasterize import RasterizeSettings as JSettings
from gsplat_tpu.raster.rasterize import _feat_columns as j_feat_columns
from gsplat_tpu.raster.rasterize import _slot_features as j_slot_features
from gsplat_tpu_torch import renderer as trenderer
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.raster import binning as tbinning
from gsplat_tpu_torch.raster import project as tproject
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import tile_kernel as ttile
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import make_params
from tests.torch_threads import one_torch_thread  # noqa: F401

BG = [0.2, 0.3, 0.4]

# name: (tile_x, tile_y, width, height, capacity, k_dup); capacity 400
# with k 1536 takes the expand branch (2k >= 7P), capacity 1000 the merge
# branch
CONFIGS = {
    "expand_16x16": (16, 16, 80, 48, 400, 1536),
    "merge_16x16": (16, 16, 80, 48, 1000, 1536),
    "expand_128x32": (128, 32, 256, 64, 400, 1536),
}


def scene(name):
    tile_x, tile_y, width, height, cap, k_dup = CONFIGS[name]
    par = make_params(cap=cap, seed=11)
    js = jax_state(par, 300, 1)
    ts = tgauss.state_from_numpy(par, 300, 1, "cpu")
    jc = jcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height)
    tc = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height,
                             device="cpu")
    js_set = JSettings(k_dup=k_dup, tile_x=tile_x, tile_y=tile_y,
                       interpret=True, inference=True)
    ts_set = trasterize.RasterizeSettings(k_dup=k_dup, tile_x=tile_x,
                                          tile_y=tile_y)
    return js, ts, jc, tc, js_set, ts_set


def frame_call(fn, ts, tc, s):
    """``render_image`` / ``render_frame`` of state ``ts`` with the tiles
    and budget of settings ``s``."""
    return fn(ts.xyz, ts.get_scaling(), ts.get_rotation(),
              ts.get_opacity()[:, 0], ts.get_features(), tc, 1, BG, s.k_dup,
              alive=ts.alive_mask, tile_x=s.tile_x, tile_y=s.tile_y)


def psnr(a, b):
    return -10.0 * np.log10(np.mean((a - b) ** 2) + 1e-20)


def test_render_forward_plain_matches_jax_kernel():
    js, _, jc, _, s, _ = scene("expand_128x32")
    grid_x = -(-jc.width // s.tile_x)
    grid_y = -(-jc.height // s.tile_y)
    jp = jproject.preprocess(js.xyz, js.get_scaling(), js.get_rotation(),
                             js.get_opacity()[:, 0], js.get_features(), jc,
                             1, alive=js.alive_mask)
    jb = jbinning.bin_gaussians(
        jp, tile_x=s.tile_x, tile_y=s.tile_y, grid_x=grid_x, grid_y=grid_y,
        k_dup=s.k_dup, chunk=128, align=8, interpret=True,
        feat_table=j_feat_columns(jp))
    feat = j_slot_features(jb.feat_table, jb.gid, jb.seg_bounds,
                           dtype=jnp.bfloat16)
    n_pix = s.tile_x * s.tile_y
    args = (grid_x * grid_y, n_pix, s.tile_x, s.tile_y, grid_x, 128)
    want = np.asarray(jtile.render_forward(
        feat, jb.chunk_meta, jnp.asarray(BG, jnp.float32), *args[:5],
        args[5], True), np.float32)
    got = ttile.render_forward(
        torch.from_numpy(np.asarray(feat, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.array(jb.chunk_meta)), torch.tensor(BG), *args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 1.6e-2 and err.mean() <= 1e-3, (err.max(),
                                                        err.mean())


# The merge config renders the expand config's scene and camera (only the
# padding capacity differs), so its JAX reference is the expand render: the
# JAX branches agree pixel for pixel (tests/test_raster.py).
JAX_REFERENCE = {"expand_16x16": "expand_16x16",
                 "merge_16x16": "expand_16x16",
                 "expand_128x32": "expand_128x32"}


@pytest.fixture(scope="module")
def renders():
    """JAX inference renders and the port's served frames of each config,
    before and after the encode (computed once)."""
    out = {}
    for name in CONFIGS:
        js, ts, jc, tc, js_set, ts_set = scene(name)
        jo = None
        if JAX_REFERENCE[name] == name:
            jo = jrenderer.render(jc, js, jnp.asarray(BG), js_set)
        image, num_dup = frame_call(trasterize.render_image, ts, tc, ts_set)
        frame, frame_dup = frame_call(trasterize.render_frame, ts, tc, ts_set)
        assert int(frame_dup) == int(num_dup)
        out[name] = (jo, {"render": image, "num_dup": num_dup,
                          "frame": frame})
    return {name: (out[JAX_REFERENCE[name]][0], to)
            for name, (_, to) in out.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_render_matches_jax_renderer(renders, name):
    jo, to = renders[name]
    a = np.asarray(jo["render"], np.float32)
    b = to["render"].float().numpy()
    assert to["render"].dtype == torch.bfloat16 and b.shape == a.shape
    assert int(to["num_dup"]) == int(jo["num_dup"])
    assert psnr(a, b) >= 45.0, psnr(a, b)
    assert to["frame"].dtype == torch.uint8
    assert torch.equal(to["frame"], ttile.encode_rgb8(to["render"]))


def test_render_merge_branch_matches_expand_branch(renders):
    """Same scene, two capacities / budgets: the padding rows change P and
    so the expansion branch, never the image."""
    _, a = renders["expand_16x16"]
    _, b = renders["merge_16x16"]
    # different capacities reseed nothing: make_params fills the same
    # 300 alive rows for any capacity
    assert int(a["num_dup"]) == int(b["num_dup"])
    assert torch.equal(a["render"], b["render"])
    assert torch.equal(a["frame"], b["frame"])


def test_inference_matches_jax_training_path(renders):
    js, ts, jc, tc, js_set, _ = scene("expand_16x16")
    train = dataclasses.replace(js_set, inference=False)
    ref = np.asarray(jrenderer.render(jc, js, jnp.asarray(BG),
                                      train)["render"])      # [H, W, 3]
    got = renders["expand_16x16"][1]["render"].float().numpy()
    diff = got.transpose(1, 2, 0) - ref
    assert psnr(got.transpose(1, 2, 0), ref) >= 40.0
    assert np.abs(diff).mean() < 5e-3


def test_training_path_matches_jax():
    """``renderer.render`` (the training blend) against JAX's training
    render (interpret mode): image, final T, ``is_used`` and radii."""
    js, ts, jc, tc, js_set, ts_set = scene("expand_16x16")
    got = trenderer.render(tc, ts, BG, ts_set)
    want = jrenderer.render(jc, js, jnp.asarray(BG),
                            dataclasses.replace(js_set, inference=False))
    assert got["render"].dtype == torch.float32
    np.testing.assert_allclose(got["render"].numpy(),
                               np.asarray(want["render"]), atol=5e-5)
    np.testing.assert_allclose(got["final_t"].numpy(),
                               np.asarray(want["final_t"]), atol=5e-5)
    for key in ("is_used", "radii"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(got["radii"].gt(0).sum()) > 0


def test_slot_features_round_global_xy_to_bf16():
    """The reference casts the whole feature table, global pixel means
    included, to bf16 before the gather (rasterize.py:246-248): x in
    [1024, 2048) snaps to a grid of 8 px. The port keeps it."""
    table = torch.zeros(2, 9)
    table[:, 0] = torch.tensor([1500.3, 37.3])
    feat = trasterize._slot_features(table, torch.tensor([0, 1, 2]),
                                     dtype=torch.bfloat16)
    assert feat.shape == (9, 3) and feat.dtype == torch.bfloat16
    assert feat[0].float().tolist() == [1504.0, 37.25, 0.0]
    want = np.asarray(j_slot_features(
        jnp.asarray(table.numpy()), jnp.asarray([0, 1, 2]),
        jnp.asarray([0, 1, 2]), dtype=jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(feat.float().numpy(), want)


# 400 splats of 3 px sigma on a 1920x32 strip, 128x32 tiles
STRIP = dict(width=1920, height=32, tile_x=128, tile_y=32, n=400, sigma=3.0)
BANDS = ((0, 256), (256, 512), (512, 1024), (1024, 1920))


def strip_arrays(seed=0):
    s = STRIP
    rng = np.random.default_rng(seed)
    n, inv = s["n"], 1.0 / s["sigma"] ** 2
    return dict(
        xy=np.c_[rng.uniform(0, s["width"], n), rng.uniform(0, s["height"], n)
                 ].astype(np.float32),
        depth=rng.uniform(1, 10, n).astype(np.float32),
        conic=np.tile(np.float32([inv, 0.0, inv]), (n, 1)),
        rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opacity=rng.uniform(0.5, 0.99, n).astype(np.float32),
        radius=np.full(n, int(np.ceil(3 * s["sigma"])), np.int32),
        visible=np.ones(n, bool))


def strip_images(side):
    """The strip's inference image from the bf16 feature stream and from an
    f32 stream through the same render, [3, H, W] numpy: the port's plain
    render, or the JAX ``render_forward`` in interpret mode."""
    s, arr = STRIP, strip_arrays()
    gx, gy = -(-s["width"] // s["tile_x"]), -(-s["height"] // s["tile_y"])
    args = (gx * gy, s["tile_x"] * s["tile_y"], s["tile_x"], s["tile_y"],
            gx, 128)

    def assemble(img_t):
        img = np.asarray(img_t, np.float32).reshape(
            gy, gx, 3, s["tile_y"], s["tile_x"]).transpose(2, 0, 3, 1, 4)
        return img.reshape(3, gy * s["tile_y"], gx * s["tile_x"])[
            :, :s["height"], :s["width"]]

    if side == "port":
        proc = tproject.Preprocessed(**{k: torch.from_numpy(v)
                                        for k, v in arr.items()})
        binn = tbinning.bin_gaussians(
            proc, tile_x=s["tile_x"], tile_y=s["tile_y"], grid_x=gx,
            grid_y=gy, k_dup=8 * s["n"], chunk=128, align=8,
            feat_table=trasterize._feat_columns(proc))
        out = []
        for dtype in (torch.bfloat16, torch.float32):
            feat = trasterize._slot_features(binn.feat_table, binn.gid, dtype)
            out.append(assemble(ttile.render_forward_plain(
                feat, binn.chunk_meta, torch.zeros(3), *args).float()))
        return out
    proc = jproject.Preprocessed(**{k: jnp.asarray(v) for k, v in arr.items()})
    binn = jbinning.bin_gaussians(
        proc, tile_x=s["tile_x"], tile_y=s["tile_y"], grid_x=gx, grid_y=gy,
        k_dup=8 * s["n"], chunk=128, align=8, interpret=True,
        feat_table=j_feat_columns(proc))
    out = []
    for dtype in (jnp.bfloat16, jnp.float32):
        feat = j_slot_features(binn.feat_table, binn.gid, binn.seg_bounds,
                               dtype=dtype)
        out.append(assemble(jtile.render_forward(
            feat, binn.chunk_meta, jnp.zeros(3), *args[:5], args[5], True)))
    return out


# PSNR (dB) by column band of each side's bf16 image against its f32
# reference, pinned to +-0.1 dB; ROADMAP Queue C quotes these numbers
STRIP_PSNR = {"port": (40.88, 32.83, 28.5, 22.0),
              "jax": (40.87, 32.83, 28.5, 22.0)}


@pytest.mark.parametrize("side", list(STRIP_PSNR))
def test_bf16_global_xy_cost_by_column_band(side):
    """The reference's bf16 global x/y costs PSNR the further right a splat
    sits (grid of 1, 2, 4 and 8 px in the bands); the port reproduces it."""
    got, ref = strip_images(side)
    bands = [psnr(got[:, :, lo:hi], ref[:, :, lo:hi]) for lo, hi in BANDS]
    np.testing.assert_allclose(bands, STRIP_PSNR[side], atol=0.1)
