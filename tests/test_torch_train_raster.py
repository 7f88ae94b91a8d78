"""gsplat_tpu_torch training rasterizer against the JAX package (Pallas in
interpret mode on the CPU) and the numpy CUDA-port oracle.

- ``tile_blend`` (plain forward and backward) vs JAX ``tile_blend`` on the
  same binning output: colour and T within 5e-5, ``used > 0`` identical,
  dfeat within 2e-4 of each row's max (JAX's own gates, tests/
  test_raster.py). JAX's T is an exp-of-log1p scan, the port's the
  sequential float32 product.
- ``rasterize(inference=False)`` vs JAX: image, final_t, is_used, radii
  and num_dup, and the gradients of all five inputs vs ``jax.grad``.
- the port against the CUDA-port oracle: the committed
  reference_port_golden.npz vectors, the saturation / 0.99-clamp edge case
  and backward.cu's gradients (5e-4, as the JAX test gates).
- ``multi_cumsum`` vs float64 and vs JAX; the segment-sum reduction vs
  the scatter-add (2e-6 scaled, tests/test_raster.py:205-225), also
  forced through a whole backward by lowering the two thresholds.
- padding and culled rows get finite, zero gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.raster import scan_kernel as jscan
from gsplat_tpu.raster import tile_kernel as jtile
from gsplat_tpu.raster.rasterize import RasterizeSettings as JSettings
from gsplat_tpu.raster.rasterize import rasterize as jrasterize
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.raster import binning as tbinning
from gsplat_tpu_torch.raster import project as tproject
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import scan_kernel as tscan
from gsplat_tpu_torch.raster import tile_kernel as ttile
from tests import reference_port as refp
from tests.test_reference_port import (BG, GOLDEN, HEIGHT, SH_DEGREE, WIDTH,
                                       cam_arrays, make_scene, run_oracle)
from tests.test_torch_kernels import make_params
from tests.torch_threads import one_torch_thread  # noqa: F401

TILE = 16
SETTINGS = trasterize.RasterizeSettings(k_dup=1 << 14, tile_x=TILE,
                                        tile_y=TILE)
J_SETTINGS = JSettings(k_dup=1 << 14, tile_x=TILE, tile_y=TILE,
                       interpret=True)


@pytest.fixture(scope="module")
def cams():
    return (jcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, WIDTH,
                                HEIGHT),
            tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, WIDTH,
                                HEIGHT, device="cpu"))


def port_render(scene, cam, settings=SETTINGS, bg=BG, grad=False):
    """Port training render of a (means, scales, quats, opa, shs) scene;
    with ``grad`` the inputs are leaves that require gradients."""
    leaves = [torch.tensor(np.asarray(a), requires_grad=grad)
              for a in scene]
    out = trasterize.rasterize(*leaves, cam, SH_DEGREE, torch.tensor(bg),
                               settings)
    return out, leaves


# ------------------------------------------------------------ tile_blend ----

def test_tile_blend_matches_jax(cams):
    """Both blends on the port's binning of the reference scene (bit-equal
    to JAX's binning, tests/test_torch_binning.py)."""
    _, tc = cams
    scene = [torch.tensor(a) for a in make_scene(p=160, seed=3, stack=40)]
    gx, gy = -(-WIDTH // TILE), -(-HEIGHT // TILE)
    proc = tproject.preprocess(*scene, tc, SH_DEGREE)
    binn = tbinning.bin_gaussians(proc, tile_x=TILE, tile_y=TILE, grid_x=gx,
                                  grid_y=gy, k_dup=1 << 12, align=8,
                                  feat_table=trasterize._feat_columns(proc))
    feat = trasterize._slot_features(binn.feat_table, binn.gid)
    meta = binn.chunk_meta
    kw = dict(num_tiles=gx * gy, n_pix=TILE * TILE, tile_x=TILE,
              tile_y=TILE, grid_x=gx, chunk=128)
    rng = np.random.default_rng(4)
    dc = rng.normal(size=(gx * gy, 3, TILE * TILE)).astype(np.float32)
    dt = rng.normal(size=(gx * gy, 1, TILE * TILE)).astype(np.float32)

    def jblend(f):
        c, t, u = jtile.tile_blend(f, jnp.asarray(meta.numpy()),
                                   interpret=True, **kw)
        return (c, t), u

    (jc, jt), jvjp, jused = jax.vjp(jblend, jnp.asarray(feat.numpy()),
                                    has_aux=True)
    (jdfeat,) = jvjp((jnp.asarray(dc), jnp.asarray(dt)))

    f = feat.clone().requires_grad_(True)
    c, t, used = ttile.tile_blend(f, meta, **kw)
    ((c * torch.from_numpy(dc)).sum() + (t * torch.from_numpy(dt)).sum()
     ).backward()
    assert (t < 1e-3).any(), "the stop rule must fire for this to test it"
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=5e-5)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jt), atol=5e-5)
    np.testing.assert_array_equal(used.numpy() > 0, np.asarray(jused) > 0)
    want = np.asarray(jdfeat)
    scale = np.abs(want).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(f.grad.numpy() / scale, want / scale,
                               atol=2e-4)


# ----------------------------------------------------- rasterize vs JAX ----

@pytest.fixture(scope="module")
def jax_and_port(cams):
    """One JAX value_and_grad (jitted once) and the port's counterpart on
    the reference scene with a random image cotangent and a final_t
    term."""
    jc, tc = cams
    scene = make_scene(p=160, seed=3, stack=40)
    rng = np.random.default_rng(11)
    w_img = rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    w_t = rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32)

    def jloss(*a):
        o = jrasterize(*a, jc, SH_DEGREE, jnp.asarray(BG), J_SETTINGS)
        return jnp.sum(o.image * w_img) + jnp.sum(o.final_t * w_t), o

    (_, jo), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *map(jnp.asarray, scene))
    out, leaves = port_render(scene, tc, grad=True)
    loss = ((out.image * torch.from_numpy(w_img)).sum()
            + (out.final_t * torch.from_numpy(w_t)).sum())
    grads = torch.autograd.grad(loss, leaves)
    return jo, jg, out, grads


def test_rasterize_train_matches_jax(jax_and_port):
    jo, _, out, _ = jax_and_port
    assert out.image.shape == (HEIGHT, WIDTH, 3)
    np.testing.assert_allclose(out.image.detach().numpy(),
                               np.asarray(jo.image), atol=5e-5)
    np.testing.assert_allclose(out.final_t.detach().numpy(),
                               np.asarray(jo.final_t), atol=5e-5)
    np.testing.assert_array_equal(out.is_used.numpy(),
                                  np.asarray(jo.is_used))
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(jo.radii))
    assert int(out.num_dup) == int(jo.num_dup)


@pytest.mark.parametrize("i,name", list(enumerate(
    ["means", "scales", "quats", "opacities", "shs"])))
def test_rasterize_gradients_match_jax(jax_and_port, i, name):
    _, jg, _, grads = jax_and_port
    got, want = grads[i].numpy(), np.asarray(jg[i])
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() + 1e-20
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4,
                               err_msg=name)


def test_chw_layout_is_the_transpose(cams):
    _, tc = cams
    scene = make_scene(p=60, seed=5)
    hwc, _ = port_render(scene, tc)
    chw, _ = port_render(scene, tc, dataclasses.replace(SETTINGS,
                                                        layout="chw"))
    assert torch.equal(chw.image, hwc.image.permute(2, 0, 1))


# ------------------------------------------------------ CUDA-port oracle ----

def test_matches_reference_port_golden(cams):
    """The committed oracle vectors (color, final_t, is_used) at the
    reference's 16x16 block size."""
    _, tc = cams
    g = np.load(GOLDEN)
    out, _ = port_render(make_scene(p=160, seed=3, stack=40), tc)
    np.testing.assert_allclose(out.image.numpy(),
                               np.transpose(g["color"], (1, 2, 0)),
                               atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_t.numpy(), g["final_t"], atol=5e-5,
                               rtol=1e-4)
    assert (out.is_used.numpy() != g["is_used"].astype(bool)).sum() <= 2
    np.testing.assert_array_equal(out.radii.numpy(), g["radii"])


def test_saturation_and_clamp_edge_cases(cams):
    """A dense near-opaque stack: the 0.99 clamp fires and pixels hit the
    T*(1-alpha) < 1e-4 stop rule; the frozen final_T must match the CUDA
    drop-the-violator semantics."""
    jc, tc = cams
    scene = make_scene(p=120, seed=7, stack=90)
    oracle = run_oracle(scene, jc)
    assert (oracle["final_t"] < 2e-4).sum() > 30
    out, _ = port_render(scene, tc)
    np.testing.assert_allclose(out.image.numpy(),
                               np.transpose(oracle["color"], (1, 2, 0)),
                               atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_t.numpy(), oracle["final_t"],
                               atol=5e-5, rtol=1e-4)


def test_gradients_match_cuda_backward_port(cams):
    """Gradients of all inputs against the numpy transliteration of
    backward.cu, with the tolerance and the rotation projection of
    tests/test_reference_port.py::test_gradients_match_cuda_backward_port
    (a big off-axis splat exercises the clamp-masked mean gradient)."""
    jc, tc = cams
    means, scales, quats, opa, shs = map(np.copy, make_scene(p=160, seed=3,
                                                             stack=40))
    means[-3] = [1.9, 0.0, 2.5]
    scales[-3] = 0.5
    opa[-3] = 0.9
    scene = (means, scales, quats, opa, shs)
    dl_img = np.random.default_rng(11).normal(
        size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    out, leaves = port_render(scene, tc, grad=True)
    got = torch.autograd.grad((out.image * torch.from_numpy(dl_img)).sum(),
                              leaves)
    view_flat, proj_flat, campos = cam_arrays(jc)
    ref = refp.backward_full(
        means, scales, quats, opa, shs, SH_DEGREE, view_flat, proj_flat,
        campos, jc.width, jc.height, float(jc.tan_fovx), float(jc.tan_fovy),
        BG, np.transpose(dl_img, (2, 0, 1)))
    q = quats / np.linalg.norm(quats, axis=1, keepdims=True)
    ref_rot = ref["dl_drots"] - q * np.sum(q * ref["dl_drots"], axis=1,
                                           keepdims=True)
    for g, want, name in zip(got, (ref["dl_dmeans"], ref["dl_dscales"],
                                   ref_rot, ref["dl_dopacity"],
                                   ref["dl_dshs"]),
                             ("means", "scales", "rotations", "opacity",
                              "shs")):
        diff = np.abs(g.numpy() - want) / (np.abs(want).max() + 1e-20)
        assert (diff > 5e-4).sum() <= max(1, int(0.005 * diff.size)), (
            name, float(diff.max()))
        assert diff.max() < 5e-2, (name, float(diff.max()))


# ------------------------------------------------ per-Gaussian reduction ----

def test_multi_cumsum_matches_float64_and_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 9000)).astype(np.float32)
    got = tscan.multi_cumsum(torch.from_numpy(x)).numpy()
    want = np.cumsum(x, axis=1, dtype=np.float64)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-5)
    jgot = jscan.multi_cumsum([jnp.asarray(a) for a in x], interpret=True)
    np.testing.assert_allclose(got, np.stack([np.asarray(a) for a in jgot]),
                               atol=2e-3, rtol=1e-5)


def test_segsum_reduce_matches_scatter_add():
    rng = np.random.default_rng(9)
    k, p1 = 20_000, 700
    gid = rng.integers(0, p1, k).astype(np.int32)
    gid[rng.uniform(size=k) < 0.3] = p1 - 1          # padding slots
    dfeat = rng.normal(size=(9, k)).astype(np.float32)
    dfeat[:, gid == p1 - 1] = 0.0
    seg_bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(gid, minlength=p1))])[:p1].astype(
            np.int32)
    exact = np.zeros((p1, 9), np.float64)
    np.add.at(exact, gid, dfeat.T.astype(np.float64))
    scale = np.abs(exact).max()
    t = torch.from_numpy
    seg = trasterize._segsum_reduce(t(dfeat), t(gid), t(seg_bounds), p1)
    sca = trasterize._scatter_reduce(t(dfeat), t(gid), p1)
    for got in (seg, sca):
        np.testing.assert_allclose(got.numpy() / scale, exact / scale,
                                   atol=2e-6)


def test_segsum_branch_matches_scatter_branch(cams, monkeypatch):
    """A whole backward through each branch of the reduction (forced at
    this size by lowering the thresholds) gives the same gradients."""
    _, tc = cams
    scene = make_scene(p=160, seed=3, stack=40)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(HEIGHT, WIDTH, 3)).astype(np.float32))
    grads = []
    for rows in (trasterize._SCATTER_MAX_ROWS, 10):
        monkeypatch.setattr(trasterize, "_SCATTER_MAX_ROWS", rows)
        launches = tscan.multi_cumsum.launches
        out, leaves = port_render(scene, tc, grad=True)
        grads.append(torch.autograd.grad((out.image * w).sum(), leaves))
        assert tscan.multi_cumsum.launches == launches  # CPU: plain only
    # the reductions agree to 2e-6 of the per-row scale (test above); the
    # chain rule carries that into the leaves, whose scale is set by other
    # rows, so the leaves are held to 2e-5 of their own max
    for a, b in zip(*grads):
        scale = float(b.abs().max()) + 1e-20
        assert float((a - b).abs().max()) / scale <= 2e-5


def test_padding_rows_get_finite_zero_gradients(cams):
    """Dead padding rows (all-zero raw parameters) and culled rows behind
    the camera: finite, zero gradients through the activations."""
    _, tc = cams
    par = make_params(p=300, cap=400, deg=1, seed=0)
    par["xyz"][290:300, 2] = -3.0                    # behind the camera
    state = tgauss.state_from_numpy(par, 300, 1, "cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in state.params().items()}
    s = state.replace_params(params)
    out = trasterize.rasterize(s.xyz, s.get_scaling(), s.get_rotation(),
                               s.get_opacity()[:, 0], s.get_features(), tc,
                               1, torch.tensor(BG), SETTINGS,
                               alive=s.alive_mask)
    grads = torch.autograd.grad(out.image.sum() + out.final_t.sum(),
                                list(params.values()))
    for name, g in zip(params, grads):
        assert bool(torch.isfinite(g).all()), name
        assert float(g[290:].abs().max()) == 0.0, name
        assert float(g[:290].abs().max()) > 0.0, name
