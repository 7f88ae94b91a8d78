"""gsplat_tpu_torch SwinGS model and steps against the JAX package on the
CPU.

Every case feeds the same seeded numpy inputs to the JAX function (jitted;
its Pallas kernels in interpret mode) and its port, at capacity <= 256,
64x48 images and 16x16 tiles, each with its tolerance:

- ``union_params_at``: active mask exact, values 1e-5;
- ``decay_genesis`` with opacity ties: exact;
- ``mature_and_rollover`` over three rounds (a ring that wraps, a round
  larger than the ring): the Adam moments, lifespans and ring copies
  exact, the rolled-over poses 1e-6 (XLA contracts the deformation into
  FMAs);
- ``relocate_immature`` and ``add_new_gs`` with the same template draws on
  both sides (``_sample_templates`` replaced in the test): moments exact,
  values 2e-6 (the relocation's power series);
- ``inject_noise_active`` with the same normal draw: 1e-6;
- one fused swin step and one grad / apply pair with noise_lr 0: loss rel
  1e-5, image 5e-5, gradients 2e-4 of each leaf's max, and the Adam deltas
  rel 1e-3 over the entries whose gradient is at least 2e-4 of the leaf's
  max (Adam's first step is lr * sign(g); ROADMAP Queue C).

The rotation helpers, the stream, the data layer, ``multi_cummax`` and the
CLIs are in tests/test_torch_swin_support.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.model import mcmc as jmcmc
from gsplat_tpu.model import optim as joptim
from gsplat_tpu.model import swin as jswin
from gsplat_tpu.raster.rasterize import RasterizeSettings as JSettings
from gsplat_tpu.train import losses as jlosses
from gsplat_tpu.train import swin_step as jsstep
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import mcmc as tmcmc
from gsplat_tpu_torch.model import optim as toptim
from gsplat_tpu_torch.model import swin as tswin
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import swin_step as tsstep
from gsplat_tpu_torch.train.config import OptimizationConfig
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import make_params
from tests.torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
W, H, TILE = 64, 48, 16
DEG = 1


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ------------------------------------------------------------ the states ----

def swin_leaves(seed=0, cap=48, buf=32, n=40, m_count=20, lifespan=4):
    """Numpy leaves of a SwinState: ``n`` alive immature rows (a few dead,
    a few at rotvec 1e-10), ``min(m_count, buf)`` filled ring rows."""
    rng = np.random.default_rng(seed)
    lv = make_params(p=n, cap=cap, deg=DEG, seed=seed)
    lv["opacity"][:4, 0] = -7.0                       # dead rows
    z3 = np.zeros((cap, 3), np.float32)
    lv["rigid_v"] = z3.copy()
    lv["rigid_v"][:n] = 0.05 * rng.normal(size=(n, 3))
    lv["rigid_rotvec"] = z3.copy()
    lv["rigid_rotvec"][:n] = 0.2 * rng.normal(size=(n, 3))
    lv["rigid_rotvec"][n - 4:n] = [1e-10, 0.0, 0.0]
    lv["rigid_rotcen"] = z3.copy()
    lv["rigid_rotcen"][:n] = lv["xyz"][:n] + 0.1 * rng.normal(size=(n, 3))
    birth = np.zeros(cap, np.float32)
    birth[:n] = rng.integers(0, 3, n)
    lv["frame_birth"] = birth
    lv["frame_start"] = birth.copy()
    lv["frame_end"] = np.where(np.arange(cap) < n,
                               birth + rng.integers(1, lifespan + 1, cap),
                               0).astype(np.float32)
    ring = make_params(p=buf, cap=buf, deg=DEG, seed=seed + 1)
    filled = min(m_count, buf)
    for k, src in (("m_xyz", "xyz"), ("m_features_dc", "f_dc"),
                   ("m_features_rest", "f_rest"), ("m_scaling", "scaling"),
                   ("m_rotation", "rotation"), ("m_opacity", "opacity")):
        lv[k] = ring[src].copy()
        lv[k][filled:] = 0
    for k in ("m_rigid_v", "m_rigid_rotvec", "m_rigid_rotcen"):
        lv[k] = np.zeros((buf, 3), np.float32)
        lv[k][:filled] = 0.05 * rng.normal(size=(filled, 3))
    mstart = np.zeros(buf, np.float32)
    mstart[:filled] = rng.integers(0, 3, filled)
    lv["m_frame_birth"] = mstart.copy()
    lv["m_frame_start"] = mstart
    lv["m_frame_end"] = np.where(np.arange(buf) < filled,
                                 mstart + rng.integers(1, 4, buf),
                                 0).astype(np.float32)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in lv.items()}


def state_pair(seed=0, cap=48, buf=32, n=40, m_count=20, lifespan=4,
               deform=True, adam=False):
    """The same SwinState in JAX and in the port (through
    ``swin_state_from_numpy``); with ``adam``, one Adam step of random
    gradients on both sides gives nonzero moments."""
    lv = swin_leaves(seed, cap, buf, n, m_count, lifespan)
    J = jnp.asarray
    js = jswin.SwinState(
        im=jax_state(lv, n, DEG),
        **{k: J(lv[k]) for k in ("rigid_v", "rigid_rotvec", "rigid_rotcen",
                                 "frame_birth", "frame_start", "frame_end")
           + tswin.RING_KEYS},
        m_count=J(m_count, jnp.int32), max_lifespan=lifespan, deform=deform)
    ts = tswin.swin_state_from_numpy(lv, n, m_count, DEG, lifespan, deform,
                                     device="cpu")
    if not adam:
        return ts, js
    rng = np.random.default_rng(seed + 7)
    g = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in ts.params().items()}
    zero = {k: 0.0 for k in g}
    tadam = toptim.step(ts.params(), {k: T(v) for k, v in g.items()},
                        toptim.init(ts.params()), zero)[1]
    jadam = joptim.step(js.params(), {k: J(v) for k, v in g.items()},
                        joptim.init(js.params()), zero)[1]
    return ts, js, tadam, jadam


SWIN_FIELDS = ("rigid_v", "rigid_rotvec", "rigid_rotcen", "frame_birth",
               "frame_start", "frame_end") + tswin.RING_KEYS


def assert_states_equal(ts, js, rtol=0.0, atol=0.0):
    assert ts.im.n_alive == int(js.im.n_alive)
    assert ts.m_count == int(js.m_count)
    for k, v in ts.params().items():
        np.testing.assert_allclose(_np(v), _np(js.params()[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    for k in SWIN_FIELDS:
        np.testing.assert_allclose(_np(getattr(ts, k)), _np(getattr(js, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


def assert_moments_equal(tadam, jadam):
    assert tadam.count == int(jadam.count)
    for tree, jtree in ((tadam.mu, jadam.mu), (tadam.nu, jadam.nu)):
        assert set(tree) == set(jtree)
        for k in tree:
            np.testing.assert_array_equal(_np(tree[k]), _np(jtree[k]),
                                          err_msg=k)


# ------------------------------------------------------------ the model ----

@pytest.mark.parametrize("deform", [True, False])
@pytest.mark.parametrize("frame", [0.0, 1.0, 2.5])
def test_union_params_at_matches_jax(deform, frame):
    ts, js = state_pair(seed=3, deform=deform)
    tk = tswin.union_params_at(ts, frame)
    jk = jax.jit(jswin.union_params_at)(js, jnp.asarray(frame))
    np.testing.assert_array_equal(tk["alive"].numpy(), np.asarray(jk["alive"]))
    assert 0 < int(tk["alive"].sum()) < tk["alive"].numel()
    assert bool(tk["alive"][ts.capacity:].any())     # the ring takes part
    for k in ("means3d", "scales", "quats", "opacities", "shs"):
        np.testing.assert_allclose(tk[k].numpy(), np.asarray(jk[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_decay_genesis_matches_jax_with_ties():
    ts, js = state_pair(seed=4, cap=64, n=41, lifespan=5)
    opa = ts.im.opacity.clone()
    opa[:41:3] = 1.25                                 # tied opacities
    ts = dataclasses.replace(ts, im=dataclasses.replace(ts.im, opacity=opa))
    js = dataclasses.replace(js, im=dataclasses.replace(
        js.im, opacity=jnp.asarray(opa.numpy())))
    got = tswin.decay_genesis(ts).frame_end.numpy()
    want = np.asarray(jax.jit(jswin.decay_genesis)(js).frame_end)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:41] - ts.frame_end[:41].numpy())) == 5


@pytest.mark.parametrize("deform", [True, False])
def test_mature_and_rollover_matches_jax(deform):
    """Three rounds on a 16-row ring: the second wraps it, the third
    matures more rows than the ring holds."""
    ts, js, tadam, jadam = state_pair(seed=5, buf=16, m_count=5,
                                      deform=deform, adam=True)
    rng = np.random.default_rng(6)
    jmature = jax.jit(jswin.mature_and_rollover)
    for size in (6, 9, 20):
        mask = np.zeros(ts.capacity, bool)
        mask[rng.choice(40, size, replace=False)] = True
        np.testing.assert_allclose(
            tswin.extract_rows_host(ts, T(mask))["xyz"],
            jswin.extract_rows_host(js, mask)["xyz"], rtol=1e-6, atol=1e-7)
        ts, tadam = tswin.mature_and_rollover(ts, tadam, T(mask))
        js, jadam = jmature(js, jadam, jnp.asarray(mask))
        assert_states_equal(ts, js, rtol=1e-6, atol=1e-7)
        assert_moments_equal(tadam, jadam)
    assert ts.m_count == 5 + 6 + 9 + 20
    assert bool(ts.matured_valid().all())
    for tree in (tadam.mu, tadam.nu):
        zero_rows = (tree["xyz"] == 0).all(dim=1)
        assert bool(zero_rows[T(mask)].all()) == deform


def test_mature_mask_matches_jax():
    ts, js = state_pair(seed=7)
    for end in (1.0, 2.0, 4.0):
        np.testing.assert_array_equal(
            tswin.mature_mask(ts, end).numpy(),
            np.asarray(jax.jit(jswin.mature_mask)(js, end)))


class _Draws:
    """Stands in for ``_sample_templates`` on one side: returns the given
    template arrays in turn."""

    def __init__(self, draws, wrap):
        self.draws, self.wrap, self.calls = list(draws), wrap, 0

    def __call__(self, key, probs, capacity):
        self.calls += 1
        return self.wrap(self.draws.pop(0))


def test_relocate_and_add_match_jax(monkeypatch):
    ts, js, tadam, jadam = state_pair(seed=8, cap=64, n=48, lifespan=3,
                                      adam=True)
    rng = np.random.default_rng(9)
    opa = 1 / (1 + np.exp(-ts.im.opacity[:, 0].numpy()))
    dead_born = ts.frame_birth.numpy()[(np.arange(64) < 48) & (opa <= 0.005)]
    assert dead_born.size >= 3 and len(set(dead_born)) >= 2
    draws = [rng.integers(0, 48, 64) for _ in range(4)]
    tdraws = _Draws(draws, lambda d: T(d.astype(np.int64)))
    jdraws = _Draws(draws, lambda d: jnp.asarray(d, jnp.int32))
    monkeypatch.setattr(tmcmc, "_sample_templates", tdraws)
    monkeypatch.setattr(jmcmc, "_sample_templates", jdraws)
    ts, tadam = tswin.relocate_immature(ts, tadam, None, 0.0, window_size=3)
    js, jadam = jax.jit(jswin.relocate_immature,
                        static_argnames=("window_size",))(
        js, jadam, jax.random.PRNGKey(0), jnp.asarray(0.0), window_size=3)
    assert tdraws.calls == jdraws.calls == 3
    assert_states_equal(ts, js, rtol=2e-6, atol=1e-7)
    assert_moments_equal(tadam, jadam)
    ts, tadam = tswin.add_new_gs(ts, tadam, None, cap_max=60)
    js, jadam = jax.jit(jswin.add_new_gs, static_argnames=("cap_max",))(
        js, jadam, jax.random.PRNGKey(1), cap_max=60)
    assert ts.im.n_alive == 50
    assert_states_equal(ts, js, rtol=2e-6, atol=1e-7)
    assert_moments_equal(tadam, jadam)


def test_inject_noise_active_matches_jax(monkeypatch):
    ts, js = state_pair(seed=10)
    raw = np.random.default_rng(11).normal(size=(48, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(raw))
    got = tswin.inject_noise_active(ts, None, 5e4, 1e-4, 1.0,
                                    raw_noise=T(raw))
    want = jax.jit(jswin.inject_noise_active)(
        js, jax.random.PRNGKey(0), 5e4, 1e-4, jnp.asarray(1.0))
    np.testing.assert_allclose(got.im.xyz.numpy(), np.asarray(want.im.xyz),
                               rtol=1e-6, atol=1e-6)
    moved = (got.im.xyz != ts.im.xyz).any(dim=1)
    assert torch.equal(moved & ~tswin.active_immature_mask(ts, 1.0),
                       torch.zeros_like(moved))


def test_swin_state_from_numpy_carries_adam():
    lv = swin_leaves(seed=12)
    groups = list(tswin.swin_state_from_numpy(lv, 40, 20, DEG, 4, True,
                                              "cpu").params())
    assert len(groups) == 9
    mu = {k: lv[k] + 1.0 for k in groups}
    nu = {k: lv[k] * lv[k] for k in groups}
    state, adam = tswin.swin_state_from_numpy(lv, 40, 20, DEG, 4, True,
                                              "cpu", adam=(mu, nu, 3))
    assert adam.count == 3 and state.m_count == 20
    for k in groups:
        np.testing.assert_array_equal(adam.mu[k].numpy(), mu[k])
        np.testing.assert_array_equal(adam.nu[k].numpy(), nu[k])


# ------------------------------------------------------------- one step ----

@pytest.fixture(scope="module")
def step_pair():
    """One fused step and one grad / apply pair on both sides (noise_lr 0).
    JAX's side is one jitted value_and_grad of ``swin_loss`` (the body of
    its grad step, which also yields the image) and its apply step; their
    composition is its fused step."""
    opt = OptimizationConfig(noise_lr=0.0)
    ts, js = state_pair(seed=13, cap=128, buf=64, n=110, m_count=40)
    rng = np.random.default_rng(14)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    jcam = jcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    tcam = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H,
                               device="cpu")
    jset = JSettings(k_dup=1 << 13, tile_x=TILE, tile_y=TILE,
                     interpret=True, layout="chw")
    tset = RasterizeSettings(k_dup=1 << 13, tile_x=TILE, tile_y=TILE)
    frame, it = 1.0, 3.0
    (jloss, (jl1, jdup, jimg, jact)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsstep.swin_loss(opt, jset, js, p, jcam, jnp.asarray(gt),
                                   jnp.zeros(3), jnp.asarray(frame), DEG),
        has_aux=True))(js.params())
    jm = tsstep.SwinMetrics(
        loss=np.asarray(jloss), l1=np.asarray(jl1), num_dup=np.asarray(jdup),
        psnr=np.asarray(jlosses.psnr(jnp.clip(jimg, 0, 1),
                                     jnp.clip(jnp.asarray(gt), 0, 1),
                                     channel_axis=0)),
        n_active=np.asarray(jact))
    host = {k: np.asarray(v) for k, v in jgrads.items()}
    jimg = np.asarray(jimg)
    # the apply step donates the state and the gradients
    jnew, jadam = jsstep.make_swin_apply_step(opt, 4.0)(
        js, joptim.init(js.params()), jgrads, jax.random.PRNGKey(0),
        jnp.asarray(it), jnp.asarray(frame), jnp.asarray(True))
    jnew = {k: np.asarray(v) for k, v in jnew.params().items()}
    bg = torch.zeros(3)
    tgrads, tm = tsstep.make_swin_grad_step(opt, tset, 4.0)(
        ts, tcam, T(gt), bg, frame, DEG)
    tsplit, tadam = tsstep.make_swin_apply_step(opt, 4.0)(
        ts, toptim.init(ts.params()), tgrads, None, it, frame, True)
    tfused, fadam, fm = tsstep.make_swin_train_step(opt, tset, 4.0)(
        ts, toptim.init(ts.params()), None, tcam, T(gt), bg, it, frame, DEG)
    with torch.no_grad():
        timg = tsstep.swin_loss(opt, dataclasses.replace(tset, layout="chw"),
                                ts, ts.params(), tcam, T(gt), bg, frame,
                                DEG)[1][2]
    tevimg = tsstep.make_swin_eval_step(dataclasses.replace(
        tset, layout="chw"))(ts, tcam, T(gt), bg, frame, DEG)[0]
    return dict(ts=ts, jgrads=host, jm=jm, jnew=jnew, jadam=jadam,
                tgrads=tgrads, tm=tm, tsplit=tsplit, tadam=tadam,
                tfused=tfused, fadam=fadam, fm=fm, jimg=jimg, timg=timg,
                tevimg=tevimg)


def test_swin_step_metrics_match_jax(step_pair):
    p = step_pair
    for m in (p["tm"], p["fm"]):
        assert abs(float(m.loss) - float(p["jm"].loss)) <= 1e-5 * abs(
            float(p["jm"].loss))
        assert int(m.num_dup) == int(p["jm"].num_dup)
        assert int(m.n_active) == int(p["jm"].n_active)
        np.testing.assert_allclose(float(m.l1), float(p["jm"].l1),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m.psnr), float(p["jm"].psnr),
                                   rtol=1e-5)
    np.testing.assert_allclose(p["timg"].numpy(), p["jimg"], atol=5e-5)
    np.testing.assert_allclose(p["tevimg"].numpy(),
                               np.clip(p["jimg"], 0, 1), atol=5e-5)


@pytest.mark.parametrize("name", ["xyz", "f_dc", "f_rest", "opacity",
                                  "scaling", "rotation", "rigid_v",
                                  "rigid_rotvec", "rigid_rotcen"])
def test_swin_step_gradients_and_adam_match_jax(step_pair, name):
    p = step_pair
    got, want = p["tgrads"][name].numpy(), np.asarray(p["jgrads"][name])
    assert np.isfinite(got).all()
    scale = np.abs(want).max() + 1e-20
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)
    # Adam's first step moves each entry by lr * sign(g): compare the
    # deltas where the sign is determined (|g| >= 2e-4 of the max)
    det = np.abs(want) >= 2e-4 * scale
    before = p["ts"].params()[name].numpy()
    want_d = p["jnew"][name] - before
    for new in (p["tsplit"], p["tfused"]):
        got_d = new.params()[name].numpy() - before
        np.testing.assert_allclose(got_d[det], want_d[det], rtol=1e-3,
                                   atol=1e-9)
    assert p["tadam"].count == p["fadam"].count == int(p["jadam"].count)


def test_swin_densify_iteration_keeps_adam_count():
    """The split densify iteration as the trainer runs it: grad ->
    relocate (+ growth in genesis) -> apply with do_adam False leaves the
    Adam count and the untouched rows' moments alone."""
    ts, _, tadam, _ = state_pair(seed=15, cap=64, n=48, adam=True)
    gen = torch.Generator().manual_seed(0)
    densify = tsstep.make_swin_densify_step(64, 3)
    new, adam = densify(ts, tadam, gen, 0.0, True)
    assert new.im.n_alive == int(1.05 * 48)
    new, adam2 = tsstep.make_swin_apply_step(OptimizationConfig(), 4.0)(
        new, adam, None, gen, 10.0, 1.0, False)
    assert adam2.count == tadam.count
    opa = new.im.get_opacity()[:48, 0]
    assert int((opa <= 0.005).sum()) < 4


