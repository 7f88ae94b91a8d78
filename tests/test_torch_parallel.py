"""gsplat_tpu_torch's parallel modes against the JAX package on the CPU.

The port runs as one 4-rank gloo job on the CPU for the whole file
(tests/torch_parallel_ranks.py, spawned once by a module fixture through
``parallel/launch.py``); JAX runs on the conftest's fake CPU devices with
its Pallas kernels in interpret mode. Inputs are seeded numpy, at 32 x 32
or 32 x 64 images and 16 x 16 tiles.

- ``rasterize(band_h, band_y0)``: each band vs the port's full render rows
  (2e-5) and vs JAX's band render (5e-5); band-local radii, is_used and
  num_dup exact;
- tileshard (2 ranks) vs the port's single-device frame (2e-5) and JAX's
  tileshard (5e-5);
- dp and swin-dp (2 ranks, noise off) vs the single-device camera mean
  (loss rel 1e-5, params 1e-6) and vs JAX's dp steps (loss rel 1e-5,
  params 2e-4 over the entries whose mean gradient is at least 2e-4 of the
  leaf's max: Adam's first step is lr * sign(g), ROADMAP Queue C); after
  three noisy steps with a densification the replicated state is
  bit-equal on both ranks;
- pshard render and train (2 ranks) and dp x ps (2 x 2) vs single device
  (5e-3, PARITY.md's round-5 gates; the trained params also within 2e-4
  over the masked entries and Adam's first moment within 1e-4 of the
  leaf's largest), the 2 x 2 shards bit-equal across dp rows; the
  all-gather's backward under the /n loss gives 3 x^2 for sum(x^3)
  (tests/test_parallel.py:164's scaling);
- pshard train (2 ranks) and dp x ps (2 x 2) vs JAX's
  make_pshard_train_step on 2 and 2 x 2 fake devices: loss rel 1e-5,
  Adam's first moment (the gradient's scale and shard block) within 1e-4
  of the leaf's largest, params 2e-4 over the masked entries; a one-rank
  ps axis reproduces the single-device step (loss rel 1e-6, params 1e-5,
  JAX's n_dev = 1 gates);
- the CLIs: train_static --data_parallel 2 and eval.render --tileshard 2 /
  --pshard 2, each starting its own two CPU ranks, write the files the
  JAX CLIs write.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.model import optim as joptim
from gsplat_tpu.parallel import mesh as jmesh
from gsplat_tpu.parallel.dp import make_dp_train_step as j_dp_step
from gsplat_tpu.parallel.dp import stack_cameras
from gsplat_tpu.parallel.swin_dp import make_dp_swin_train_step as j_sdp
from gsplat_tpu.parallel.tileshard import make_tileshard_render as j_ts
from gsplat_tpu.raster.rasterize import RasterizeSettings as JSettings
from gsplat_tpu.raster.rasterize import rasterize as jrasterize
from gsplat_tpu.train.config import OptimizationConfig as JOpt
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.model import optim as toptim
from gsplat_tpu_torch.parallel import launch
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.raster.rasterize import rasterize as trasterize
from gsplat_tpu_torch.train import step as tstep
from gsplat_tpu_torch.train import swin_step as tsstep
from gsplat_tpu_torch.train.config import OptimizationConfig
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import make_params
from tests.test_torch_swin import state_pair, swin_leaves
from tests.torch_parallel_ranks import run_cases

T = torch.from_numpy
SH = 1
# one chunk per grid step: the interpret-mode programs compile ~2.5x
# faster than at the default 8, and the results do not depend on it
JS = JSettings(k_dup=4096, tile_x=16, tile_y=16, chunk=128, super_chunks=1,
               interpret=True)
TS = RasterizeSettings(k_dup=4096, tile_x=16, tile_y=16, chunk=128)
BG = np.array([0.3, 0.2, 0.1], np.float32)


def cam_spec(i, n, w=32, h=32, radius=3.0):
    th = 2 * np.pi * i / n
    fwd = np.array([-np.sin(th), 0.0, np.cos(th)])
    up = np.array([0.0, 1.0, 0.0])
    r_cw = np.stack([np.cross(up, fwd), up, fwd], 1)
    t = -r_cw.T @ (-fwd * radius)
    return (r_cw, t, 0.9, 0.9, w, h)


def jcam(spec):
    return jcamera.make_camera(*spec)


def tcam(spec):
    return tcamera.make_camera(*spec, device="cpu")


def cloud(p, seed):
    """Activated rasterizer inputs (numpy) in front of the cameras."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (p, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(-1.0, 1.0, p)
    q = rng.normal(size=(p, 4))
    return {"means": means,
            "scales": np.exp(rng.uniform(-2.5, -1.5, (p, 3))).astype(
                np.float32),
            "quats": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
                np.float32),
            "opa": (1 / (1 + np.exp(-rng.uniform(0, 3, p)))).astype(
                np.float32),
            "shs": np.concatenate([rng.uniform(-0.5, 1.5, (p, 1, 3)),
                                   0.1 * rng.normal(size=(p, 3, 3))],
                                  axis=1).astype(np.float32),
            "alive": np.ones(p, bool)}


def _cloud_args(c, conv):
    return tuple(conv(c[k]) for k in ("means", "scales", "quats", "opa",
                                      "shs", "alive"))


def _gt(spec, state, scale, seed):
    """A target image: the port's render of the state, scaled, plus
    noise ([3, H, W])."""
    s = dataclasses.replace(TS, layout="chw")
    img = trasterize(state.xyz, state.get_scaling(), state.get_rotation(),
                     state.get_opacity()[:, 0], state.get_features(),
                     tcam(spec), SH, torch.zeros(3), s,
                     alive=state.alive_mask).image.detach().numpy()
    rng = np.random.default_rng(seed)
    return np.clip(img * scale + 0.05 * rng.normal(size=img.shape), 0,
                   1).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = {"bg": BG, "gg_x": (np.arange(64, dtype=np.float32) / 7.0)}
    ts, ps = cloud(96, 12), cloud(128, 5)
    for pre, c in (("ts", ts), ("ps", ps)):
        inp.update({f"{pre}_{k}": v for k, v in c.items()})
    inp["ts_cam"] = cam_spec(0, 1, w=32, h=64)
    inp["ps_cam"] = cam_spec(0, 1, w=48, h=32)
    par = make_params(p=96, cap=128, deg=SH, seed=4)
    par["xyz"][:96] = np.random.default_rng(4).uniform(-1, 1, (96, 3))
    inp.update({f"st_{k}": v for k, v in par.items()})
    inp["st_n"] = 96
    state = tgauss.state_from_numpy(par, 96, SH, "cpu")
    inp["dp_cams"] = [cam_spec(0, 4), cam_spec(1, 4)]
    inp["dp_gts"] = [_gt(c, state, s, i) for i, (c, s) in
                     enumerate(zip(inp["dp_cams"], (0.5, 0.8)))]
    inp["ps_gt"] = _gt(inp["ps_cam"], state, 0.7, 9)
    lv = swin_leaves(seed=3, cap=48, buf=32, n=40, m_count=20, lifespan=4)
    inp.update({f"sw_{k}": v for k, v in lv.items()})
    inp["swin_n"], inp["swin_m"] = 40, 20
    inp["swin_frames"] = [1.0, 2.0]
    out = tmp_path_factory.mktemp("ranks")
    launch.run(run_cases, 4, "cpu", (inp, str(out)))
    res = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
           for r in range(4)]
    return inp, state, res


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


# ---------------------------------------------------------------- bands ----

def test_band_rasterize_matches_full_rows_and_jax():
    c = cloud(96, 11)
    spec = cam_spec(0, 1)
    targs, jargs = _cloud_args(c, T), _cloud_args(c, jnp.asarray)
    full = trasterize(*targs[:5], tcam(spec), SH, T(BG), TS,
                      alive=targs[5])
    # one compiled program for both bands (band_y0 is traced)
    jband = jax.jit(lambda y0: jrasterize(
        *jargs[:5], jcam(spec), SH, jnp.asarray(BG), JS, alive=jargs[5],
        band_h=16, band_y0=y0))
    for y0 in (0, 16):
        tb = trasterize(*targs[:5], tcam(spec), SH, T(BG), TS,
                        alive=targs[5], band_h=16, band_y0=float(y0))
        jb = jband(jnp.float32(y0))
        assert tb.image.shape == (16, 32, 3)
        np.testing.assert_allclose(tb.image.numpy(),
                                   full.image[y0:y0 + 16].numpy(), atol=2e-5)
        np.testing.assert_allclose(tb.image.numpy(), np.asarray(jb.image),
                                   atol=5e-5)
        np.testing.assert_array_equal(tb.radii.numpy(), np.asarray(jb.radii))
        np.testing.assert_array_equal(tb.is_used.numpy(),
                                      np.asarray(jb.is_used))
        assert int(tb.num_dup) == int(jb.num_dup) < int(full.num_dup)


# ------------------------------------------------------------ tileshard ----

def test_tileshard_matches_single_device_and_jax(ranks):
    inp, _, res = ranks
    c = {k: inp[f"ts_{k}"] for k in ("means", "scales", "quats", "opa",
                                      "shs", "alive")}
    targs = _cloud_args(c, T)
    ref = trasterize(*targs[:5], tcam(inp["ts_cam"]), SH, T(BG), TS,
                     alive=targs[5])
    mesh = jmesh.make_mesh(2, axis_name="sp")
    jimg = j_ts(mesh, JS, SH, axis="sp")(*_cloud_args(c, jnp.asarray),
                                        jcam(inp["ts_cam"]),
                                        jnp.asarray(BG))
    for r in (0, 1):
        img = res[r]["ts_image"]
        assert img.shape == (64, 32, 3)
        np.testing.assert_allclose(img, ref.image.numpy(), atol=2e-5)
        np.testing.assert_allclose(img, np.asarray(jimg), atol=5e-5)
    assert 0 < int(res[0]["ts_num_dup"]) < int(ref.num_dup)


# ------------------------------------------------------------------- dp ----

def _mean_grad_step(state, adam, grads_list, opt, lr_fn, iteration=1.0):
    mean = {k: sum(g[k] for g in grads_list) / len(grads_list)
            for k in grads_list[0]}
    _, lrs = lr_fn(opt, 1.0, iteration)
    return toptim.step(state.params(), mean, adam, lrs)[0], mean


def _masked_close(got, want, grad, atol):
    keep = np.abs(grad) >= 2e-4 * np.abs(grad).max()
    np.testing.assert_allclose(got[keep], want[keep], atol=atol)


def test_dp_step_matches_camera_mean_and_jax(ranks):
    inp, state, res = ranks
    opt = OptimizationConfig(noise_lr=0.0)
    chw = dataclasses.replace(TS, layout="chw")
    grads, losses = [], []
    for spec, gt in zip(inp["dp_cams"], inp["dp_gts"]):
        g, m = tstep._loss_and_grads(opt, chw, state, tcam(spec), T(gt),
                                     torch.zeros(3), SH)
        grads.append(g)
        losses.append(float(m.loss))
    ref, mean = _mean_grad_step(state, toptim.init(state.params()), grads,
                                opt, tstep.learning_rates)
    par = {k: inp[f"st_{k}"] for k in tgauss.PARAM_KEYS}
    js = jax_state(par, 96, SH)
    jnew, _, jm = j_dp_step(jmesh.make_mesh(2), JOpt(noise_lr=0.0), JS,
                            1.0)(SH)(
        js, joptim.init(js.params()), jax.random.PRNGKey(0),
        stack_cameras([jcam(c) for c in inp["dp_cams"]]),
        jnp.stack([jnp.asarray(g) for g in inp["dp_gts"]]), jnp.zeros(3),
        1.0)
    for r in (0, 1):
        assert _rel(res[r]["dp_loss"], np.mean(losses)) <= 1e-5
        assert _rel(res[r]["dp_loss"], jm.loss) <= 1e-5
        for k, v in ref.items():
            np.testing.assert_allclose(res[r][f"dp_{k}"], v.numpy(),
                                       atol=1e-6, err_msg=k)
            _masked_close(res[r][f"dp_{k}"], np.asarray(jnew.params()[k]),
                          mean[k].numpy(), 2e-4)
    for key in res[0]:
        if key.startswith("dpn_"):
            np.testing.assert_array_equal(res[0][key], res[1][key],
                                          err_msg=key)
    assert int(res[0]["dpn_n_alive"]) > 96          # the densification grew


def test_swin_dp_step_matches_camera_mean_and_jax(ranks):
    inp, _, res = ranks
    ts, js = state_pair(seed=3, cap=48, buf=32, n=40, m_count=20,
                        lifespan=4)
    opt = OptimizationConfig(noise_lr=0.0)
    chw = dataclasses.replace(TS, layout="chw")
    grads, losses = [], []
    for spec, gt, f in zip(inp["dp_cams"], inp["dp_gts"],
                           inp["swin_frames"]):
        g, m = tsstep._loss_and_grads(opt, chw, ts, tcam(spec), T(gt),
                                      torch.zeros(3), f, SH)
        grads.append(g)
        losses.append(float(m.loss))
    ref, mean = _mean_grad_step(ts, toptim.init(ts.params()), grads, opt,
                                tsstep.swin_learning_rates)
    jnew, _, jm = j_sdp(jmesh.make_mesh(2), JOpt(noise_lr=0.0), JS, 1.0)(
        SH)(js, joptim.init(js.params()), jax.random.PRNGKey(0),
            stack_cameras([jcam(c) for c in inp["dp_cams"]]),
            jnp.stack([jnp.asarray(g) for g in inp["dp_gts"]]),
            jnp.asarray(inp["swin_frames"]), jnp.zeros(3), 1.0)
    for r in (0, 1):
        assert _rel(res[r]["sdp_loss"], np.mean(losses)) <= 1e-5
        assert _rel(res[r]["sdp_loss"], jm.loss) <= 1e-5
        for k, v in ref.items():
            np.testing.assert_allclose(res[r][f"sdp_{k}"], v.numpy(),
                                       atol=1e-6, err_msg=k)
            _masked_close(res[r][f"sdp_{k}"], np.asarray(jnew.params()[k]),
                          mean[k].numpy(), 2e-4)
    for key in res[0]:
        if key.startswith("sdpn_"):
            np.testing.assert_array_equal(res[0][key], res[1][key],
                                          err_msg=key)


# --------------------------------------------------------------- pshard ----

def test_pshard_render_matches_single_device(ranks):
    inp, _, res = ranks
    c = {k: inp[f"ps_{k}"] for k in ("means", "scales", "quats", "opa",
                                      "shs", "alive")}
    targs = _cloud_args(c, T)
    ref = trasterize(*targs[:5], tcam(inp["ps_cam"]), SH, T(BG), TS,
                     alive=targs[5]).image.numpy()
    for r in (0, 1):
        np.testing.assert_allclose(res[r]["ps_image"], ref, atol=5e-3)


def test_pshard_gather_grad_scaling(ranks):
    inp, _, res = ranks
    x = inp["gg_x"]
    got = np.concatenate([res[0]["gg_grad"], res[1]["gg_grad"]])
    np.testing.assert_allclose(got, 3 * x ** 2, rtol=1e-6)


@pytest.mark.parametrize("case", ["pst", "dps"])
def test_pshard_train_matches_single_device(ranks, case):
    """2-rank pshard (one camera) and 2 x 2 dp x ps (the dp cameras): the
    loss within 5e-3 of the single-device loss (mean over the cameras),
    finite params whose update stays within 2x the single-device one, and
    within 2e-4 of the single-device step's over the masked entries, with
    Adam's first moment within 1e-4 of the leaf's largest (the slab
    compositing differs only where a slab's T falls below 1e-4); the
    2 x 2 job's shards equal across its dp rows."""
    inp, state, res = ranks
    opt = OptimizationConfig(noise_lr=0.0)
    step = tstep.make_train_step(opt, TS, 1.0)
    if case == "pst":
        samples = [(inp["ps_cam"], inp["ps_gt"])]
        members = (0, 1)
    else:
        samples = list(zip(inp["dp_cams"], inp["dp_gts"]))
        members = (0, 1, 2, 3)
    losses, deltas, grads = [], [], []
    chw = dataclasses.replace(TS, layout="chw")
    for spec, gt in samples:
        s, _, m = step(state, toptim.init(state.params()), None, tcam(spec),
                       T(gt), torch.zeros(3), 1.0, SH)
        losses.append(float(m.loss))
        deltas.append({k: np.abs(v.numpy() - state.params()[k].numpy()).max()
                       for k, v in s.params().items()})
        grads.append(tstep._loss_and_grads(opt, chw, state, tcam(spec),
                                           T(gt), torch.zeros(3), SH)[0])
    ref, mean = _mean_grad_step(state, toptim.init(state.params()), grads,
                                opt, tstep.learning_rates)
    for r in members:
        assert _rel(res[r][f"{case}_loss"], np.mean(losses)) <= 5e-3
        for k, v in state.params().items():
            got = res[r][f"{case}_{k}"]
            assert np.isfinite(got).all(), k
            du = np.abs(got - v.numpy()).max()
            assert du <= 2.0 * max(d[k] for d in deltas) + 1e-7, (k, du)
            g = mean[k].numpy()
            _masked_close(got, ref[k].numpy(), g, 2e-4)
            np.testing.assert_allclose(res[r][f"{case}_mu_{k}"], 0.1 * g,
                                       atol=1e-4 * 0.1 * np.abs(g).max(),
                                       err_msg=k)
    if case == "dps":
        for key in res[0]:
            if key.startswith("dps_"):
                np.testing.assert_array_equal(res[0][key], res[2][key])
                np.testing.assert_array_equal(res[1][key], res[3][key])


@pytest.mark.parametrize("case", ["pst", "dps"])
def test_pshard_train_matches_jax(ranks, case):
    """2-rank pshard and 2 x 2 dp x ps against JAX's make_pshard_train_step
    on 2 and 2 x 2 fake devices, noise off: loss rel <= 1e-5; Adam's first
    moment (0.1 x the gradient, so its scale, shard block and regulariser
    sums) within 1e-4 of the leaf's largest; params within 2e-4 over the
    entries whose gradient is at least 2e-4 of the leaf's max."""
    from gsplat_tpu.parallel.pshard import make_pshard_train_step as j_ps

    inp, _, res = ranks
    par = {k: inp[f"st_{k}"] for k in tgauss.PARAM_KEYS}
    js = jax_state(par, 96, SH)
    opt = JOpt(noise_lr=0.0)
    if case == "pst":
        step = j_ps(jmesh.make_mesh(2, axis_name="ps"), opt, JS, 1.0, SH)
        cam, gt = jcam(inp["ps_cam"]), jnp.asarray(inp["ps_gt"])
        members = (0, 1)
    else:
        step = j_ps(jmesh.make_mesh_2d(2, 2), opt, JS, 1.0, SH,
                    dp_axis="dp")
        cam = stack_cameras([jcam(c) for c in inp["dp_cams"]])
        gt = jnp.stack([jnp.asarray(g) for g in inp["dp_gts"]])
        members = (0, 1, 2, 3)
    params = {k: jnp.asarray(v) for k, v in js.params().items()}
    jp, ja, jm = step(params, js.alive_mask, joptim.init(js.params()),
                      jax.random.PRNGKey(0), cam, gt, jnp.zeros(3), 1.0, 96)
    for r in members:
        assert _rel(res[r][f"{case}_loss"], jm.loss) <= 1e-5
        for k in tgauss.PARAM_KEYS:
            mu = np.asarray(ja.mu[k])
            np.testing.assert_allclose(res[r][f"{case}_mu_{k}"], mu,
                                       atol=1e-4 * np.abs(mu).max(),
                                       err_msg=k)
            _masked_close(res[r][f"{case}_{k}"], np.asarray(jp[k]), mu,
                          2e-4)


def test_pshard_step_on_one_shard_equals_single_device():
    """A one-rank ps axis (no process group: every collective is the
    identity) reproduces the single-device step, as JAX's n_dev = 1 case
    (tests/test_parallel.py:198) does: loss rel 1e-6, params 1e-5."""
    from gsplat_tpu_torch.parallel.mesh import Axis, Mesh
    from gsplat_tpu_torch.parallel.pshard import make_pshard_train_step

    par = make_params(p=96, cap=128, deg=SH, seed=4)
    state = tgauss.state_from_numpy(par, 96, SH, "cpu")
    spec = cam_spec(0, 1, w=48, h=32)
    gt = T(_gt(spec, state, 0.7, 9))
    opt = OptimizationConfig(noise_lr=0.0)
    ref, _, rm = tstep.make_train_step(opt, TS, 1.0)(
        state, toptim.init(state.params()), None, tcam(spec), gt,
        torch.zeros(3), 1.0, SH)
    mesh = Mesh({"ps": Axis(None, 1, 0)}, torch.device("cpu"))
    gen = torch.Generator()
    gen.manual_seed(0)
    p, _, m = make_pshard_train_step(mesh, opt, TS, 1.0, SH)(
        state.params(), state.alive_mask, toptim.init(state.params()), gen,
        tcam(spec), gt, torch.zeros(3), 1.0, state.n_alive)
    assert _rel(m.loss, rm.loss) <= 1e-6
    for k, v in ref.params().items():
        np.testing.assert_allclose(p[k].detach().numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)


# ----------------------------------------------------------------- CLIs ----

def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_parallel_clis_write_what_jax_writes(tmp_path, monkeypatch):
    """train_static --data_parallel 2 on two CPU ranks writes the files
    the JAX CLI writes (tests/test_cli_pipeline.py:91-105); eval.render
    --tileshard 2 and --pshard 2 write the single-device render's PNGs
    within one and two 8-bit levels (test_cli_pipeline.py:150-200)."""
    from PIL import Image

    from gsplat_tpu_torch.eval import render as trender
    from gsplat_tpu_torch.train import train_static as ttrain

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    blender = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "quality_blender")
    out = str(tmp_path / "model_dp")
    common = ["-s", blender, "-m", out, "-w", "--cap_max", "320",
              "--dup_budget", "16384", "--tile_x", "16", "--tile_y", "16",
              "--data_device", "cpu"]
    res = ttrain.main(common + [
        "--iterations", "6", "--test_iterations", "4",
        "--save_iterations", "6", "--densify_from_iter", "2",
        "--densify_until_iter", "5", "--densification_interval", "2",
        "--data_parallel", "2"])
    assert _tree(out) == ["cameras.json", "cfg_args",
                          "point_cloud/iteration_6/point_cloud.ply"]
    assert res["state"].n_alive > 256                # densified
    ply = tgauss.load_ply(os.path.join(out, "point_cloud/iteration_6/"
                                       "point_cloud.ply"), 320, 3, "cpu")
    assert torch.equal(ply.xyz, res["state"].xyz)
    renders = os.path.join(out, "test", "ours_6", "renders")
    imgs = {}
    for name, flag in (("single", []), ("tileshard", ["--tileshard", "2"]),
                       ("pshard", ["--pshard", "2"])):
        trender.main(common + ["--iteration", "6", "--skip_train"] + flag)
        imgs[name] = [np.asarray(Image.open(os.path.join(renders, f)),
                                 np.float32)
                      for f in sorted(os.listdir(renders))]
    assert len(imgs["single"]) == 2
    assert _tree(os.path.join(out, "test")) == [
        f"ours_6/{d}/{i:05d}.png" for d in ("gt", "renders")
        for i in range(2)]
    for name, tol in (("tileshard", 1.0), ("pshard", 2.0)):
        for a, b in zip(imgs[name], imgs["single"]):
            assert np.abs(a - b).max() <= tol, name
