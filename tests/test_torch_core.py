"""gsplat_tpu_torch core math and preprocess against the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
its port; float32 values agree to rtol 1e-5 / atol 1e-5 (both evaluate the
same elementwise formulas in float32; only libm rounding differs), and the
integer screen radius is exact. Also checks that the port imports neither
jax nor gsplat_tpu.
"""

import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.core import covariance as jcov
from gsplat_tpu.core import quaternion as jquat
from gsplat_tpu.core import sh as jsh
from gsplat_tpu.model import gaussians as jgauss
from gsplat_tpu.raster import project as jproject
from gsplat_tpu.raster.rasterize import mark_visible as j_mark_visible
from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.core import covariance as tcov
from gsplat_tpu_torch.core import quaternion as tquat
from gsplat_tpu_torch.core import sh as tsh
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.raster import project as tproject
from gsplat_tpu_torch.raster import rasterize as trasterize
from tests.test_torch_kernels import make_params

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **{**TOL, **kw})


def T(a):
    return torch.from_numpy(np.array(a))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_gsplat_tpu():
    """Nor the JAX side's entry scripts (bench.py, __graft_entry__.py,
    the JAX soaks); the port's scripts under scripts/ neither."""
    files = sorted((REPO / "gsplat_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gsplat_tpu", "bench",
                               "__graft_entry__",
                               "gen_hw_parity_golden", "soak_30k",
                               "soak_swin"), (
                f"{path.relative_to(REPO)} imports {mod}")


def test_get_device_refuses_missing_cuda():
    assert get_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert get_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_device("cuda")


def test_quaternion_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0  # zero quaternion (padding row) stays finite
    close(tquat.normalize(T(q)), jquat.normalize(jnp.asarray(q)))
    close(tquat.quat_to_rotmat(T(q)), jquat.quat_to_rotmat(jnp.asarray(q)))
    close(tquat.quat_to_rotmat(T(q), normalize_q=False),
          jquat.quat_to_rotmat(jnp.asarray(q), normalize_q=False))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    k = tsh.num_sh_bases(deg)
    assert k == jsh.num_sh_bases(deg)
    sh = rng.normal(size=(50, k, 3)).astype(np.float32)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    campos = rng.normal(size=3).astype(np.float32)
    dirs = means / np.linalg.norm(means, axis=1, keepdims=True)
    close(tsh.eval_sh(deg, T(sh), T(dirs), channel_minor=True),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs),
                      channel_minor=True))
    sh_cm = np.ascontiguousarray(sh.transpose(0, 2, 1))
    close(tsh.eval_sh(deg, T(sh_cm), T(dirs)),
          jsh.eval_sh(deg, jnp.asarray(sh_cm), jnp.asarray(dirs)))
    close(tsh.sh_to_rgb(deg, T(sh), T(means), T(campos)),
          jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(means),
                        jnp.asarray(campos)))
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(T(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def test_covariance_matches_jax():
    rng = np.random.default_rng(1)
    scales = np.exp(rng.uniform(-3, 0, size=(64, 3))).astype(np.float32)
    quats = rng.normal(size=(64, 4)).astype(np.float32)
    close(tcov.covariance_6(T(scales), T(quats), 0.7),
          jcov.covariance_6(jnp.asarray(scales), jnp.asarray(quats), 0.7))
    close(tcov.covariance_3d(T(scales), T(quats)),
          jcov.covariance_3d(jnp.asarray(scales), jnp.asarray(quats)))

    means = np.c_[rng.uniform(-3, 3, (64, 2)),
                  rng.uniform(0.5, 5, 64)].astype(np.float32)
    means[0] = [50.0, -40.0, 1.0]  # far off-axis: exercises the fov clamp
    cov6 = np.asarray(jcov.covariance_6(jnp.asarray(scales),
                                        jnp.asarray(quats)))
    jc = jcamera.make_camera(np.eye(3), np.array([0.1, -0.2, 0.5]), 0.9,
                             0.7, 160, 96)
    tc = tcamera.make_camera(np.eye(3), np.array([0.1, -0.2, 0.5]), 0.9,
                             0.7, 160, 96, device="cpu")
    got = tcov.project_cov2d(T(means), T(cov6), tc.view, tc.focal_x,
                             tc.focal_y, tc.tan_fovx, tc.tan_fovy)
    want = jcov.project_cov2d(jnp.asarray(means), jnp.asarray(cov6), jc.view,
                              jc.focal_x, jc.focal_y, jc.tan_fovx,
                              jc.tan_fovy)
    for g, w in zip(got, want):
        close(g, w)


def test_camera_matches_jax():
    rng = np.random.default_rng(2)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t = rng.normal(size=3)
    kw = dict(translate=np.array([0.3, 0.0, -0.1]), scale=1.5)
    for extra in ({}, dict(principal_point=(70.0, 40.0)),
                  dict(principal_point=(70.0, 40.0),
                       focal_px=(120.0, 118.0))):
        jc = jcamera.make_camera(R, t, 0.9, 0.7, 160, 90, **kw, **extra)
        tc = tcamera.make_camera(R, t, 0.9, 0.7, 160, 90, **kw, **extra,
                                 device="cpu")
        for name in ("view", "full_proj", "cam_pos", "tan_fovx",
                     "tan_fovy"):
            np.testing.assert_array_equal(
                getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                err_msg=name)
        # width / (2 tan): XLA's float32 division may round 1 ulp apart
        close(tc.focal_x, jc.focal_x)
        close(tc.focal_y, jc.focal_y)
        assert (tc.width, tc.height) == (jc.width, jc.height)
    assert tcamera.fov2focal(0.9, 160) == jcamera.fov2focal(0.9, 160)
    assert tcamera.focal2fov(120.0, 160) == jcamera.focal2fov(120.0, 160)
    v = rng.uniform(-1, 1, 10).astype(np.float32)
    close(tcamera.ndc_to_pix(T(v), 160), jcamera.ndc_to_pix(jnp.asarray(v),
                                                            160))
    assert math.isclose(tcamera.ZNEAR, jcamera.ZNEAR)


def jax_state(par, n_alive, deg):
    return jgauss.GaussianState(
        xyz=jnp.asarray(par["xyz"]), features_dc=jnp.asarray(par["f_dc"]),
        features_rest=jnp.asarray(par["f_rest"]),
        scaling=jnp.asarray(par["scaling"]),
        rotation=jnp.asarray(par["rotation"]),
        opacity=jnp.asarray(par["opacity"]),
        n_alive=jnp.asarray(n_alive, jnp.int32), max_sh_degree=deg)


def test_state_from_numpy_matches_jax_activations():
    par = make_params()
    js = jax_state(par, 300, 1)
    ts = tgauss.state_from_numpy(par, 300, 1, "cpu")
    assert ts.capacity == js.capacity == 400
    np.testing.assert_array_equal(ts.alive_mask.numpy(),
                                  np.asarray(js.alive_mask))
    close(ts.get_scaling(), js.get_scaling())
    close(ts.get_rotation(), js.get_rotation())
    close(ts.get_opacity(), js.get_opacity())
    close(ts.get_features(), js.get_features())
    close(ts.get_covariance(0.5), js.get_covariance(0.5))
    with pytest.raises(ValueError):
        tgauss.state_from_numpy(par, 401, 1, "cpu")


@pytest.mark.parametrize("variant", ["sh", "precomp", "no_alive"])
def test_preprocess_matches_jax(variant):
    par = make_params(seed=3)
    js = jax_state(par, 300, 1)
    ts = tgauss.state_from_numpy(par, 300, 1, "cpu")
    jc = jcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 128, 96)
    tc = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 128, 96,
                             device="cpu")
    jkw, tkw = dict(alive=js.alive_mask), dict(alive=ts.alive_mask)
    if variant == "precomp":
        rgb = np.random.default_rng(4).uniform(size=(400, 3))
        cov6 = np.asarray(js.get_covariance(1.3))
        jkw.update(colors_precomp=jnp.asarray(rgb, jnp.float32),
                   cov3d_precomp=jnp.asarray(cov6))
        tkw.update(colors_precomp=T(rgb.astype(np.float32)),
                   cov3d_precomp=T(cov6))
    if variant == "no_alive":
        jkw, tkw = dict(scale_modifier=0.8), dict(scale_modifier=0.8)
    jp = jproject.preprocess(js.xyz, js.get_scaling(), js.get_rotation(),
                             js.get_opacity()[:, 0], js.get_features(), jc,
                             1, **jkw)
    tp = tproject.preprocess(ts.xyz, ts.get_scaling(), ts.get_rotation(),
                             ts.get_opacity()[:, 0], ts.get_features(), tc,
                             1, **tkw)
    np.testing.assert_array_equal(tp.visible.numpy(), np.asarray(jp.visible))
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    assert tp.radius.dtype == torch.int32
    vis = np.asarray(jp.visible)
    assert vis.sum() > 100
    for name in ("xy", "depth", "conic", "rgb", "opacity"):
        t_v = getattr(tp, name).numpy()
        j_v = np.asarray(getattr(jp, name))
        # culled rows: depth is +inf in both; xy/conic may be any value
        np.testing.assert_allclose(t_v[vis], j_v[vis], **TOL, err_msg=name)
    assert np.all(np.isinf(tp.depth.numpy()[~vis]))

    np.testing.assert_array_equal(
        trasterize.mark_visible(ts.xyz, tc).numpy(),
        np.asarray(j_mark_visible(js.xyz, jc)))

    rects_t = tproject.tile_rect(tp.xy, tp.radius, 16, 16, 8, 6)
    rects_j = jproject.tile_rect(jp.xy, jp.radius, 16, 16, 8, 6)
    for a, b in zip(rects_t, rects_j):
        np.testing.assert_array_equal(a.numpy()[vis], np.asarray(b)[vis])
