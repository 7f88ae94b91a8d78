"""gsplat_tpu_torch training slice against the JAX package on the CPU.

- losses (L1, PSNR with the per-channel quirk, separable SSIM and its
  gradient), Adam and its moment surgery, ``expon_lr``, the
  duplicate-budget policy: vs the JAX functions, float32 tolerance;
- both 3-NN paths (exact blocked, Morton window + certificate + rescan)
  vs JAX and a brute-force float64 oracle; ``create_from_points``;
- MCMC with injected draws (the ``*_forced`` variants, ``raw_noise``) vs
  JAX, and the sampler's zero-probability guarantee;
- one grad step + one apply step of the hardware-parity golden
  (tests/fixtures/hw_parity_golden.npz, 8192 Gaussians at 256x256) with
  JAX's PRNGKey(7) noise fed as ``raw_noise``: image, loss, num_dup and the
  xyz / opacity / scaling deltas;
- the trainer CLI on the committed Blender fixture: ~30 iterations with a
  densification, a finite falling loss and a PLY that loads back.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import schedule as jschedule
from gsplat_tpu.model import gaussians as jgauss
from gsplat_tpu.model import knn as jknn
from gsplat_tpu.model import mcmc as jmcmc
from gsplat_tpu.model import optim as joptim
from gsplat_tpu.train import losses as jlosses
from gsplat_tpu.train import train_static as jtrain_static
from gsplat_tpu_torch.core import schedule as tschedule
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.model import knn as tknn
from gsplat_tpu_torch.model import mcmc as tmcmc
from gsplat_tpu_torch.model import optim as toptim
from gsplat_tpu_torch.train import losses as tlosses
from gsplat_tpu_torch.train import step as tstep
from gsplat_tpu_torch.train import train_static as ttrain_static
from gsplat_tpu_torch.train.config import OptimizationConfig
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import make_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---------------------------------------------------------------- losses ----

@pytest.mark.parametrize("chw", [True, False])
def test_losses_match_jax(chw):
    rng = np.random.default_rng(0)
    shape = (3, 40, 56) if chw else (40, 56, 3)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    ax = 0 if chw else -1
    np.testing.assert_allclose(_np(tlosses.l1_loss(T(a), T(b))),
                               _np(jlosses.l1_loss(a, b)), rtol=1e-6)
    np.testing.assert_allclose(_np(tlosses.psnr(T(a), T(b))),
                               _np(jlosses.psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(_np(tlosses.psnr(T(a), T(b), channel_axis=ax)),
                               _np(jlosses.psnr(a, b, channel_axis=ax)),
                               rtol=1e-6)
    ta = T(a).requires_grad_(True)
    s = tlosses.ssim(ta, T(b))
    s.backward()
    js, jg = jax.value_and_grad(jlosses.ssim)(jnp.asarray(a),
                                              jnp.asarray(b))
    np.testing.assert_allclose(_np(s), _np(js), rtol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), _np(jg), rtol=1e-4,
                               atol=1e-9)


# ---------------------------------------------------- optimizer, schedule ----

def test_adam_and_moment_surgery_match_jax():
    rng = np.random.default_rng(1)
    shapes = {"xyz": (6, 3), "f_rest": (6, 3, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lrs = {"xyz": 1.6e-4, "f_rest": 1.25e-4}
    tp, ts = {k: T(v) for k, v in p0.items()}, None
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    ts, js = toptim.init(tp), joptim.init(jp)
    for i in range(4):
        g = {k: rng.normal(size=s).astype(np.float32) * (i + 1)
             for k, s in shapes.items()}
        tp, ts = toptim.step(tp, {k: T(v) for k, v in g.items()}, ts, lrs)
        jp, js = joptim.step(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, lrs)
        if i == 1:
            mask = np.array([1, 0, 1, 0, 0, 1], bool)
            ts = toptim.zero_moments_at(ts, T(mask))
            js = joptim.zero_moments_at(js, jnp.asarray(mask))
    assert ts.count == int(js.count) == 4
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(ts.nu[k].numpy(), _np(js.nu[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 7, 500, 15_000, 30_000, 40_000])
def test_expon_lr_matches_jax(step):
    kw = dict(lr_init=1.6e-4 * 4.0, lr_final=1.6e-6 * 4.0,
              lr_delay_mult=0.01, max_steps=30_000)
    np.testing.assert_allclose(tschedule.expon_lr(step, **kw),
                               _np(jschedule.expon_lr(step, **kw)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tschedule.expon_lr(step, 1e-3, 1e-5, lr_delay_steps=100,
                           lr_delay_mult=0.1),
        _np(jschedule.expon_lr(step, 1e-3, 1e-5, lr_delay_steps=100,
                               lr_delay_mult=0.1)), rtol=1e-6)


def test_next_dup_budget_matches_jax():
    cases = [(980, 1000, 10, 0, False), (100, 200_000, 2000, 0, False),
             (5000, 80_000, 25_400, 6000, False), (5000, 80_000, 25_400,
                                                   6000, True)]
    for c in cases:
        assert (ttrain_static.next_dup_budget(*c, 25_000, 128)
                == jtrain_static.next_dup_budget(*c, 25_000, 128))


# ------------------------------------------------------------------- kNN ----

def _brute_3nn(pts):
    d = ((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return np.sort(d, axis=1)[:, :3].mean(1)


def test_knn_exact_matches_jax_and_brute_force():
    pts = np.random.default_rng(2).uniform(-1, 1, (900, 3)).astype(
        np.float32)
    got = tknn.mean_sq_dist_3nn(T(pts), block=256).numpy()
    np.testing.assert_allclose(got, _brute_3nn(pts), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        got, _np(jknn._mean_sq_dist_3nn_exact(jnp.asarray(pts), block=256)),
        rtol=1e-4, atol=1e-7)


def test_knn_morton_window_path_is_exact():
    """The large-P path at a small size (block 128): certified answers
    plus the rescanned violators equal the brute force and JAX's path."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(0, 0.05, (700, 3)),
                          rng.uniform(-2, 2, (500, 3))]).astype(np.float32)
    _, viol = tknn._windowed_3nn(T(pts), 128)
    assert 0 < int(viol.sum()) < len(pts)  # the rescan path runs
    got = tknn._mean_sq_dist_3nn_large(T(pts), 128).numpy()
    np.testing.assert_allclose(got, _brute_3nn(pts), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        got, _np(jknn._mean_sq_dist_3nn_large(jnp.asarray(pts), 128)),
        rtol=1e-4, atol=1e-7)


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    ts = tgauss.create_from_points(pts, cols, 640, 2, device="cpu")
    js = jgauss.create_from_points(pts, cols, 640, 2)
    assert ts.n_alive == int(js.n_alive) == 500
    for k, v in ts.params().items():
        np.testing.assert_allclose(v.numpy(), _np(js.params()[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_state_from_numpy_carries_adam():
    par = make_params(cap=50, p=40)
    mu = {k: v + 1.0 for k, v in par.items()}
    nu = {k: v * v for k, v in par.items()}
    state, adam = tgauss.state_from_numpy(par, 40, 1, "cpu", adam=(mu, nu,
                                                                   7))
    assert state.n_alive == 40 and adam.count == 7
    for k in par:
        np.testing.assert_array_equal(adam.mu[k].numpy(), mu[k])
        np.testing.assert_array_equal(adam.nu[k].numpy(), nu[k])


# ------------------------------------------------------------------ MCMC ----

def _states(seed=5, cap=64, n=40):
    rng = np.random.default_rng(seed)
    par = make_params(p=n, cap=cap, deg=1, seed=seed)
    par["opacity"][:n, 0] = rng.uniform(-7, 3, n)   # some dead (<= 0.005)
    ts = tgauss.state_from_numpy(par, n, 1, "cpu")
    js = jax_state(par, n, 1)
    g = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in par.items()}
    tadam = toptim.step(ts.params(), {k: T(v) for k, v in g.items()},
                        toptim.init(ts.params()), {k: 0.0 for k in g})[1]
    jadam = joptim.step(js.params(), {k: jnp.asarray(v)
                                      for k, v in g.items()},
                        joptim.init(js.params()), {k: 0.0 for k in g})[1]
    return ts, js, tadam, jadam, rng


def _assert_same(ts, js, tadam, jadam):
    assert ts.n_alive == int(js.n_alive)
    for k, v in ts.params().items():
        np.testing.assert_allclose(v.numpy(), _np(js.params()[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(tadam.mu[k].numpy() == 0,
                                      _np(jadam.mu[k]) == 0)


def test_compute_relocation_matches_jax():
    rng = np.random.default_rng(6)
    o = rng.uniform(0.01, 0.99, 50).astype(np.float32)
    s = rng.uniform(0.01, 1, (50, 3)).astype(np.float32)
    n = rng.integers(1, 60, 50).astype(np.int32)
    to, tsc = tmcmc.compute_relocation(T(o), T(s), T(n))
    jo, jsc = jmcmc.compute_relocation(jnp.asarray(o), jnp.asarray(s),
                                       jnp.asarray(n))
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-5)
    np.testing.assert_allclose(tsc.numpy(), _np(jsc), rtol=1e-4)


def test_forced_relocation_and_growth_match_jax():
    ts, js, tadam, jadam, rng = _states()
    opa = 1 / (1 + np.exp(-ts.opacity[:, 0].numpy()))
    dead = (np.arange(64) < 40) & (opa <= 0.005)
    assert dead.any()
    live = np.flatnonzero((np.arange(64) < 40) & ~dead)
    tmpl = rng.choice(live, 64).astype(np.int32)
    ts, tadam = tmcmc.relocate_gs_forced(ts, tadam, T(dead), T(tmpl))
    js, jadam = jmcmc.relocate_gs_forced(js, jadam, jnp.asarray(dead),
                                         jnp.asarray(tmpl))
    _assert_same(ts, js, tadam, jadam)
    tmpl = rng.choice(np.arange(40), 64).astype(np.int32)
    ts, tadam = tmcmc.add_new_gs_forced(ts, tadam, T(tmpl), 42)
    js, jadam = jmcmc.add_new_gs_forced(js, jadam, jnp.asarray(tmpl), 42)
    _assert_same(ts, js, tadam, jadam)
    assert ts.n_alive == 42


def test_inject_noise_with_raw_noise_matches_jax():
    ts, js, *_ = _states(seed=8)
    raw = np.random.default_rng(9).normal(size=(64, 3)).astype(np.float32)
    tn = tmcmc.inject_noise(ts, None, 5e4, 1e-4, raw_noise=T(raw))
    jn = jmcmc.inject_noise(js, None, 5e4, 1e-4, raw_noise=jnp.asarray(raw))
    np.testing.assert_allclose(tn.xyz.numpy(), _np(jn.xyz), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(tn.xyz[40:], ts.xyz[40:])   # dead rows untouched


def test_sampled_densify_never_picks_zero_probability_rows():
    ts, _, tadam, _, _ = _states(seed=10)
    gen = torch.Generator().manual_seed(0)
    probs = torch.zeros(64)
    probs[[3, 17]] = torch.tensor([0.2, 0.7])
    idx = tmcmc._sample_templates(gen, probs, 64)
    assert set(idx.tolist()) <= {3, 17}
    n = ts.n_alive
    dead = int((ts.alive_mask & (ts.get_opacity()[:, 0] <= 0.005)).sum())
    ts2, adam2 = tstep.make_densify_step(64)(ts, tadam, gen)
    assert ts2.n_alive == int(1.05 * n)
    opa2 = ts2.get_opacity()[:, 0]
    assert int((ts2.alive_mask & (opa2 <= 0.005)).sum()) < dead
    for tree in (adam2.mu, adam2.nu):
        for v in tree.values():
            assert float(v[n:ts2.n_alive].abs().max()) == 0.0


# ------------------------------------------------ the hw-parity golden ----

def test_grad_and_apply_step_match_hw_parity_golden():
    """scripts/gen_hw_parity_golden.py's train step through the port on
    the CPU, with JAX's PRNGKey(7) noise as raw_noise. Adam's first step
    moves each entry by lr * sign(grad), so entries whose gradient is
    below 2e-4 of the leaf's largest (a sign the golden's bf16-split dots
    do not resolve) are left out of the delta comparison."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gen_hw_parity_golden as gold

    import bench_torch

    golden = np.load(gold.OUT)
    from gsplat_tpu_torch.core import camera as tcamera
    from gsplat_tpu_torch.raster import rasterize as trast
    from __graft_entry__ import _orbit_cameras

    jcam = _orbit_cameras(3, gold.W, gold.H)[1]
    cam = tcamera.camera_from_matrices(
        np.asarray(jcam.view), np.asarray(jcam.full_proj),
        np.asarray(jcam.cam_pos), float(jcam.tan_fovx), float(jcam.tan_fovy),
        gold.W, gold.H, device="cpu")
    rng = np.random.default_rng(gold.SEED + 1)
    pts = rng.uniform(-1.2, 1.2, (gold.P_MODEL, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2.0, 6.0, gold.P_MODEL)
    cols = rng.uniform(0, 1, (gold.P_MODEL, 3)).astype(np.float32)
    state = tgauss.create_from_points(pts, cols, gold.P_MODEL,
                                      gold.SH_DEGREE, device="cpu")
    yy, xx = np.meshgrid(np.linspace(0, 1, gold.H), np.linspace(0, 1, gold.W),
                         indexing="ij")
    gt = T(np.stack([xx, yy, 0.5 * (xx + yy)], 0).astype(np.float32))
    settings = trast.RasterizeSettings(k_dup=gold.K_DUP, tile_x=gold.TILE_X,
                                       tile_y=gold.TILE_Y, chunk=gold.CHUNK)
    opt = OptimizationConfig()
    bg = torch.zeros(3)
    grads, m = tstep.make_grad_step(opt, settings, 4.0)(
        state, cam, gt, bg, gold.TRAIN_SH_DEGREE)
    raw = T(np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                         (gold.P_MODEL, 3))))
    new, adam = tstep.make_apply_step(opt, 4.0, external_noise=True)(
        state, toptim.init(state.params()), grads, None, gold.ITERATION,
        True, raw)
    assert adam.count == 1
    assert int(m.num_dup) == int(golden["num_dup"])
    assert abs(float(m.loss) - float(golden["loss"])) <= 1e-4 * abs(
        float(golden["loss"]))
    for key, leaf in (("dxyz", "xyz"), ("dopacity", "opacity"),
                      ("dscaling", "scaling")):
        delta = (getattr(new, leaf) - getattr(state, leaf)).numpy()
        _, det_rel, n_undet = bench_torch.delta_rel_l2(
            delta, golden[key], grads[leaf].numpy())
        assert det_rel <= 3e-2, (key, det_rel)
        assert n_undet <= 0.01 * delta.size, (key, n_undet)


# ----------------------------------------------------------- trainer CLI ----

def test_trainer_cli_trains_and_saves(tmp_path, monkeypatch):
    """~30 iterations with one densification on the Blender fixture: the
    loss is finite and falls, and the PLY loads back."""
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.raster.rasterize import RasterizeSettings

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    fixture = os.path.join(ROOT, "tests", "fixtures", "quality_blender")
    out = str(tmp_path / "model")
    args = ["-s", fixture, "-m", out, "--eval", "-w", "--cap_max", "512",
            "--init_pts", "256", "--iterations", "30",
            "--densify_from_iter", "10", "--densify_until_iter", "28",
            "--densification_interval", "20", "--test_iterations", "30",
            "--save_iterations", "-1", "--dup_budget", "16384",
            "--data_device", "cpu"]
    res = ttrain_static.main(args)
    assert np.isfinite(res["final_loss"])
    ply = os.path.join(out, "point_cloud", "iteration_30",
                       "point_cloud.ply")
    state = tgauss.load_ply(ply, capacity=512, max_sh_degree=3,
                            device="cpu")
    assert state.n_alive > 256          # the densification grew the model
    assert torch.allclose(state.xyz[:state.n_alive],
                          res["state"].xyz[:state.n_alive])
    scene = Scene(fixture, "", eval_split=True, white_background=True,
                  init_type="random", num_pts=8, shuffle=False, device="cpu")
    init = tgauss.create_from_points(scene.info.points[:256],
                                     scene.info.colors[:256], 512, 3,
                                     device="cpu")
    eval_step = tstep.make_eval_step(RasterizeSettings(k_dup=16384,
                                                       tile_x=64, tile_y=16))
    l1 = {"init": [], "trained": []}
    for cam_obj in scene.train_cameras:
        cam, gt = cam_obj.load()
        for name, st in (("init", init), ("trained", state)):
            l1[name].append(float(eval_step(st, cam, T(gt), torch.ones(3),
                                            0)[1]))
    assert np.mean(l1["trained"]) < 0.9 * np.mean(l1["init"]), l1
