"""bench_torch.py (gsplat_tpu_torch's bench) against bench.py on the CPU.

- Every stage's inputs at bench.py's CPU sizes, built on the JAX side by
  bench.py's own functions (``bench.trained_stats_state``,
  ``__graft_entry__._make_scene`` / ``_orbit_cameras``,
  ``gsplat_tpu``'s ``create_from_points``) and on the port's by
  bench_torch's recipes, each from ``default_rng(0)`` drawn in bench.py's
  order: numpy-drawn leaves bit-equal, leaves activated in float32 (exp,
  sigmoid, normalize) within 1e-6 and the 3-NN log-scales of
  ``create_from_points`` within 1e-5 relative (the tolerance of
  test_torch_train's ``create_from_points`` comparison), camera view and
  projection matrices within 1e-6, the generator left in one state.
- The probed num_dup of every stage's cameras equal to JAX's binning on the
  same inputs (it sets each stage's budget).
- ``trained_stats_state`` in each of bench.py's paths (uniform and
  clustered positions, the pooled-marginal scales of a stats file without
  the sorted-triple table, no stats file): the same state and source.
- ``bench_torch.main(["--device", "cpu"])``: one JSON line with bench.py's
  keys (read from bench.py's AST) and ``device``, finite numbers, the
  parity fields; with the default device and no CUDA, bench.py's failure
  line and exit 1 with no stage run.
"""

import ast
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from __graft_entry__ import _make_scene, _orbit_cameras
from gsplat_tpu.core.quaternion import normalize as jnormalize
from gsplat_tpu.model import gaussians as jgauss
from gsplat_tpu.model import swin as jswin
from gsplat_tpu.raster import binning as jbinning
from gsplat_tpu.raster import project as jproject

REPO = pathlib.Path(__file__).resolve().parents[1]
TILE = (64, 16)   # bench.py's default BENCH_TILE_X x BENCH_TILE_Y
# bench.py's CPU sizes (bench.py:254-255, 260, 341-346, 365, 384-385, 395,
# 440-441, 455)
CPU = dict(p_gt=500, p=1000, width=128, height=128, wit=2, k=1 << 15,
           render=(256, 128, 1000, (32, 16), 2), m=(2000, 160, 96, 2),
           s=(1, 2000, 160, 96, 2))


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


def _same(got, want, exact, rtol=1e-6):
    if exact:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol,
                                   atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread in this module: the test run shares the cores
    among its workers, and under that load torch's own thread pool made
    the CPU bench run many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    """bench.py's stage inputs at its CPU sizes, drawn in its order: the
    ground-truth scene (a copy of bench.py:266-274, which is inline in its
    main), the 100k stage's state (:281-284), the render scene and cameras
    (:359-360), the 1M stage's state (:391) and the swin stage's
    (:446-457)."""
    rng = np.random.default_rng(0)
    p_gt, p = CPU["p_gt"], CPU["p"]
    gt = (
        jnp.asarray(rng.uniform(-0.9, 0.9, (p_gt, 3)).astype(np.float32)),
        jnp.asarray(np.exp(rng.uniform(-3.2, -2.0, (p_gt, 3))).astype(
            np.float32)),
        jnormalize(jnp.asarray(rng.normal(size=(p_gt, 4)).astype(
            np.float32))),
        jax.nn.sigmoid(jnp.asarray(rng.uniform(0, 3, p_gt).astype(
            np.float32))),
        jnp.asarray(np.concatenate(
            [rng.uniform(-0.5, 1.5, (p_gt, 1, 3)),
             np.zeros((p_gt, 15, 3))], 1).astype(np.float32)),
    )
    pts = rng.uniform(-1, 1, (p, 3)).astype(np.float32)
    state = jgauss.create_from_points(
        pts, rng.uniform(0, 1, (p, 3)).astype(np.float32), capacity=p,
        max_sh_degree=3)
    rw, rh, rp, _, _ = CPU["render"]
    mp, mw, mh, _ = CPU["m"]
    mstate, m_src = bench.trained_stats_state(mp, 3, rng)
    s_sh, s_cap, s_w, s_h, _ = CPU["s"]
    sstate = jswin.create_from_points(
        rng.uniform(-1, 1, (s_cap, 3)).astype(np.float32),
        rng.uniform(0, 1, (s_cap, 3)).astype(np.float32), capacity=s_cap,
        max_sh_degree=s_sh, max_lifespan=8, buffer_size=s_cap, deform=True)
    return dict(
        gt=gt, state=state, mstate=mstate, m_src=m_src, sstate=sstate,
        rscene=_make_scene(rp, 3, seed=0),
        sscene=_make_scene(p_gt, s_sh, seed=1),
        cams={"train": _orbit_cameras(8, CPU["width"], CPU["height"]),
              "render": _orbit_cameras(8, rw, rh),
              "train_1m": _orbit_cameras(4, mw, mh),
              "swin": _orbit_cameras(4, s_w, s_h)},
        rng=rng.bit_generator.state)


@pytest.fixture(scope="module")
def port_side():
    """The same through bench_torch's recipes, in bench_torch.run's order."""
    rng = np.random.default_rng(0)
    size = bench_torch.SIZES["cpu"]
    gt = bench_torch.bench_gt_scene(rng, size["p_gt"], "cpu")
    cfg = size["train"]
    st = bench_torch.static_setup(
        "cpu", gt, bench_torch.uniform_state(rng, cfg["p"], "cpu"), cfg,
        cfg["k_probe"], TILE)
    rs = bench_torch.render_setup("cpu", size["render"])
    mstate, m_src = bench_torch.trained_stats_state(
        size["train_1m"]["p"], 3, rng, "cpu")
    k_gt = st["settings"].k_dup
    mst = bench_torch.static_setup("cpu", gt, mstate, size["train_1m"],
                                   k_gt, TILE)
    sw = bench_torch.swin_setup("cpu", rng, size["swin"], size["p_gt"],
                                k_gt, TILE)
    return dict(gt=gt, st=st, rs=rs, mst=mst, m_src=m_src, sw=sw,
                cams={"train": st["cams"], "render": rs["cams"],
                      "train_1m": mst["cams"], "swin": sw["cams"]},
                rng=rng.bit_generator.state)


def test_cpu_sizes_are_bench_py_s():
    size = bench_torch.SIZES["cpu"]
    rw, rh, rp, rtile, frames = CPU["render"]
    mp, mw, mh, mwit = CPU["m"]
    s_sh, s_cap, s_w, s_h, s_wit = CPU["s"]
    assert size["p_gt"] == CPU["p_gt"]
    assert size["train"] == dict(p=CPU["p"], width=CPU["width"],
                                 height=CPU["height"], cams=8, wit=CPU["wit"],
                                 k_probe=CPU["k"])
    assert size["render"] == dict(p=rp, width=rw, height=rh, tile=rtile,
                                  cams=8, frames=frames)
    assert size["train_1m"] == dict(p=mp, width=mw, height=mh, cams=4,
                                    wit=mwit, k_probe=CPU["k"])
    assert size["swin"] == dict(cap=s_cap, sh=s_sh, lifespan=8, width=s_w,
                                height=s_h, cams=4, wit=s_wit,
                                k_probe=CPU["k"])
    assert bench_torch.bench_tile() == TILE


@pytest.mark.parametrize("i,name,exact", [
    (0, "means", True), (1, "scales", True), (2, "quats", False),
    (3, "opacities", False), (4, "shs", True)])
def test_gt_scene_matches_bench_py(jax_side, port_side, i, name, exact):
    _same(port_side["gt"][i], jax_side["gt"][i], exact)


@pytest.mark.parametrize("scene", ["rscene", "sscene"])
def test_make_scene_matches_graft_entry(jax_side, port_side, scene):
    """The render stage's scene and the swin stage's ground-truth scene:
    means and SH bit-equal, the activated leaves within 1e-6."""
    if scene == "rscene":
        got = port_side["rs"]["scene"]
    else:
        got = bench_torch.make_scene_params(CPU["p_gt"], 1, 1, "cpu")
    for i, exact in enumerate((True, False, False, False, True)):
        _same(got[i], jax_side[scene][i], exact)


@pytest.mark.parametrize("stage", ["train", "render", "train_1m", "swin"])
def test_cameras_match_bench_py(jax_side, port_side, stage):
    got, want = port_side["cams"][stage], jax_side["cams"][stage]
    assert len(got) == len(want)
    for c, j in zip(got, want):
        assert (c.width, c.height) == (j.width, j.height)
        for key in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy"):
            _same(getattr(c, key), getattr(j, key), exact=False)


# create_from_points' log-scales come from each package's own 3-NN
# search: held at tests/test_torch_train.py::
# test_create_from_points_matches_jax's rtol
KNN_RTOL = 1e-5


def _state_leaves(port, jx):
    """(name, port leaf, JAX leaf, numpy-drawn) of a GaussianState."""
    tp, jp = port.params(), jx.params()
    return [(k, tp[k], jp[k], k == "xyz") for k in tp]


def _rtol(name, exact):
    return KNN_RTOL if name == "scaling" and not exact else 1e-6


@pytest.mark.parametrize("stage", ["train", "train_1m", "swin"])
def test_states_match_bench_py(jax_side, port_side, stage):
    if stage == "train":
        pairs = _state_leaves(port_side["st"]["state"], jax_side["state"])
    elif stage == "train_1m":
        pairs = [(k, a, b, exact or k in ("opacity", "scaling"))
                 for k, a, b, exact in _state_leaves(
                     port_side["mst"]["state"], jax_side["mstate"])]
        assert port_side["m_src"] == jax_side["m_src"]
    else:
        ps, js = port_side["sw"]["state"], jax_side["sstate"]
        pairs = _state_leaves(ps.im, js.im) + [
            (k, getattr(ps, k), getattr(js, k), False)
            for k in ("rigid_v", "rigid_rotvec", "rigid_rotcen",
                      "frame_birth", "frame_start", "frame_end")]
    for name, got, want, exact in pairs:
        assert got.shape == want.shape, name
        _same(got, want, exact, _rtol(name, exact))


def test_rng_draws_in_bench_py_order(jax_side, port_side):
    assert port_side["rng"] == jax_side["rng"]


@pytest.fixture(scope="module")
def jax_num_dup():
    """num_dup of JAX's preprocess + binning (its true demand, whatever
    the budget: a small budget keeps the interpret-mode expansion cheap)."""
    fns = {}

    def run(params, cam, sh, tile, alive=None):
        key = (sh, tile, cam.width, cam.height)
        if key not in fns:
            gx = -(-cam.width // tile[0])
            gy = -(-cam.height // tile[1])

            def f(params, cam, alive):
                proc = jproject.preprocess(*params, cam, sh, alive=alive)
                return jbinning.bin_gaussians(
                    proc, tile_x=tile[0], tile_y=tile[1], grid_x=gx,
                    grid_y=gy, k_dup=1024, chunk=128, align=8,
                    interpret=True).num_dup
            fns[key] = jax.jit(f)
        return int(fns[key](params, cam, alive))
    return run


def _jparams(state):
    return (state.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], state.get_features())


@pytest.mark.parametrize("stage", ["train", "render", "train_1m", "swin"])
def test_probed_num_dup_matches_jax(jax_side, port_side, jax_num_dup, stage):
    """The probe that sets each stage's budget, camera by camera (the
    render stage keeps the max), against JAX's binning on bench.py's own
    inputs."""
    cams = jax_side["cams"][stage]
    if stage == "train":
        st = jax_side["state"]
        want = [jax_num_dup(_jparams(st), c, 3, TILE, st.alive_mask)
                for c in cams]
        got = port_side["st"]["need"]
    elif stage == "train_1m":
        st = jax_side["mstate"]
        want = [jax_num_dup(_jparams(st), c, 3, TILE, st.alive_mask)
                for c in cams]
        got = port_side["mst"]["need"]
    elif stage == "swin":
        u = jswin.union_params_at(jax_side["sstate"], jnp.asarray(0.0))
        params = (u["means3d"], u["scales"], u["quats"], u["opacities"],
                  u["shs"])
        want = [jax_num_dup(params, c, 1, TILE, u["alive"]) for c in cams]
        got = port_side["sw"]["need"]
    else:
        tile = CPU["render"][3]
        want = max(jax_num_dup(jax_side["rscene"], c, 3, tile)
                   for c in cams)
        got = port_side["rs"]["need"]
    assert got == want


def _stats_file(kind, tmp_path):
    if kind == "fixture":
        return None
    if kind == "missing":
        return str(tmp_path / "no_trained_stats.npz")
    st = dict(np.load(bench_torch.TRAINED_STATS))
    del st["logscale_sorted_quantiles"]     # a pre-round-5 stats file
    path = tmp_path / "pooled_stats.npz"
    np.savez(path, **st)
    return str(path)


@pytest.mark.parametrize("positions,kind", [
    ("uniform", "fixture"), ("clustered", "fixture"), ("uniform", "pooled"),
    ("clustered", "missing")])
def test_trained_stats_state_matches_bench_py(tmp_path, positions, kind):
    path = _stats_file(kind, tmp_path)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    js, jsrc = bench.trained_stats_state(300, 3, jr, stats_path=path,
                                         positions=positions)
    ts, tsrc = bench_torch.trained_stats_state(
        300, 3, tr, "cpu", stats_path=path, positions=positions)
    assert tsrc == jsrc
    assert tr.bit_generator.state == jr.bit_generator.state
    drawn = ("xyz",) if kind == "missing" else ("xyz", "opacity", "scaling")
    for name, got, want, _ in _state_leaves(ts, js):
        _same(got, want, name in drawn, _rtol(name, name in drawn))


def _bench_py_keys():
    """bench.py's result-line keys from its AST (bench.py:495-525): the
    top level, the config dict and the hw_parity_stage fields it spreads
    into it."""
    tree = ast.parse((REPO / "bench.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def dict_keys(d):
        return [k.value for k in d.keys if k is not None]

    top = config = None
    for node in ast.walk(funcs["main"]):
        if isinstance(node, ast.Dict) and "metric" in dict_keys(node):
            top = dict_keys(node)
            config = dict_keys(node.values[top.index("config")])
    parity = [dict_keys(n.value) for n in ast.walk(funcs["hw_parity_stage"])
              if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return top, config + parity[0]


def test_cpu_run_prints_bench_py_line(capsys):
    assert bench_torch.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    top, config = _bench_py_keys()
    assert list(out) == top
    assert set(out["config"]) == set(config) | {
        "device", "hw_parity_param_delta_rel_masked"}
    cfg = out["config"]
    assert cfg["backend"] == cfg["device"] == "cpu"
    assert out["metric"] == "train_iters_per_sec" and out["unit"] == "it/s"
    rates = [out["value"], cfg["ms_per_iter"], cfg["render_fps_1080p"],
             cfg["render_ms"], cfg["train_1m_ms_per_iter"],
             cfg["swin_ms_per_iter"]] + cfg["windows_it_per_s"] + \
        cfg["train_1m_windows_ms"] + cfg["swin_windows_ms"]
    assert all(math.isfinite(x) and x > 0 for x in rates)
    assert len(cfg["windows_it_per_s"]) == 3
    assert cfg["hw_parity_train_psnr"] >= 85.0
    assert cfg["hw_parity_infer_psnr"] >= bench_torch.INFER_GATE_DB
    assert cfg["hw_parity_loss_rel"] <= 1e-4
    assert math.isfinite(cfg["hw_parity_param_delta_rel"])
    assert cfg["hw_parity_param_delta_rel_masked"] <= 3e-2
    assert (cfg["gaussians"], cfg["image"], cfg["tile"]) == (
        CPU["p"], "128x128", "64x16")
    assert (cfg["render_image"], cfg["train_1m_image"], cfg["swin_cap"]) == (
        "256x128", "160x96", 2000)
    stages = [ln for ln in captured.err.splitlines()
              if ln.startswith("stage: ")]
    assert stages[0].startswith("stage: hw parity")


def test_no_card_prints_failure_line_and_exits_1(monkeypatch, capsys):
    """In process with CUDA reported absent (no stage may run), and the
    script itself where no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **k):
        raise AssertionError("a stage ran without a card")
    monkeypatch.setattr(bench_torch, "run", refuse)
    assert bench_torch.main([]) == 1
    want = {"metric": "train_iters_per_sec", "value": 0.0, "unit": "it/s",
            "vs_baseline": 0.0}
    out = json.loads(capsys.readouterr().out)
    assert {k: out[k] for k in want} == want
    assert "unavailable" in out["config"]["error"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(REPO / "bench_torch.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1
    lines = res.stdout.splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] == 0.0
    assert "stage:" not in res.stderr
