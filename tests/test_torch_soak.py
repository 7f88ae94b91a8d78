"""The port's long-run soaks and run scripts against the JAX side's on the
CPU.

- Recipe: at soak_30k.py's CPU sizes, the ground truths of the held-out
  cameras within 1e-5 of JAX's rasterize (interpret mode) and the initial
  state within 1e-6 of the one JAX's ``soak_30k.main`` builds from the
  same draws; soak_swin.py's GT motion arrays bit-equal.
- Loop control: JAX's own ``soak_30k.main`` over all 30,010 iterations
  and ``soak_swin.main`` over its CPU schedule, beside the port's loops,
  with the step factories (and the renders, evolve and playback) replaced
  by recording stubs that return one scripted num_dup trace: the camera,
  frame and SH degree of every iteration, the densify iterations, every
  budget change, the report and dump iterations and the generator's final
  state identical.
- A real ``--device cpu`` run of each script: the swin soak's maturation
  cadence and record count, the result keys of both against the JAX
  scripts' ``json.dumps`` dicts (read from their AST), the stats file.
- ``_dump_stats`` of both packages on one state's arrays.
- The no-card line and exit 1; the run scripts' modules have a ``main``
  that accepts every flag they pass.
"""

import argparse
import ast
import importlib.util
import json
import pathlib
import re
import shlex
import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gsplat_tpu.core import quaternion as jquat
from gsplat_tpu.eval import render_stream as jrender_stream
from gsplat_tpu.model import gaussians as jgauss
from gsplat_tpu.model import swin as jswin
from gsplat_tpu.train import step as jstep
from gsplat_tpu.train import swin_step as jsstep
from gsplat_tpu.train import train_swin as jtrain_swin

# the modules themselves (the packages' ``rasterize`` attribute is the
# function)
jrast = importlib.import_module("gsplat_tpu.raster.rasterize")
trast = importlib.import_module("gsplat_tpu_torch.raster.rasterize")
REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak_30k = _load("soak_30k")
soak_swin = _load("soak_swin")
tsoak_30k = _load("torch_soak_30k")
tsoak_swin = _load("torch_soak_swin")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread in this module: the test run shares the cores
    among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Metrics(NamedTuple):
    loss: np.float32
    num_dup: np.int64
    n_active: np.int64 = np.int64(0)
    l1: np.float32 = np.float32(0)
    psnr: np.float32 = np.float32(0)


class Recorder:
    """Stub step factories that log what the loops ask of them and return
    ``trace(n)`` as num_dup, n counting the rendering steps."""

    def __init__(self, trace, cam_index):
        self.trace, self.cam_index = trace, cam_index
        self.log, self.builds, self.calls, self.it = [], [], 0, 0

    def _metrics(self):
        self.calls += 1
        return _Metrics(np.float32(0.5), np.int64(self.trace(self.calls)))

    # -- static soak
    def make_train_step(self, opt, s, spatial_lr_scale):
        self.builds.append(s.k_dup)

        def step(state, adam, key, cam, gt, bg, it, sh):
            self.it = int(it)
            self.log.append(("step", self.it, self.cam_index(cam), int(sh)))
            return state, adam, self._metrics()
        return step

    def make_densify_step(self, cap):
        def densify(state, adam, key):
            self.log.append(("densify", self.it))
            return state, adam
        return densify

    def make_eval_step(self, settings):
        def ev(state, cam, gt, bg, sh):
            self.log.append(("eval", self.it, self.cam_index(cam), int(sh)))
            return None, None, np.float32(20.0)
        return ev

    def dump(self, state, path, source):
        self.log.append(("dump", self.it))

    # -- swin soak
    def make_swin_train_step(self, opt, s, scale, *a, **kw):
        self.builds.append(s.k_dup)

        def step(state, adam, key, cam, gt, bg, it, frame, sh, *a):
            self.log.append(("train", int(it), int(frame),
                             self.cam_index(cam)))
            return state, adam, self._metrics()
        return step

    def make_swin_grad_step(self, opt, s, scale):
        def grad(state, cam, gt, bg, frame, sh):
            self.log.append(("grad", int(frame), self.cam_index(cam)))
            return None, self._metrics()
        return grad

    def make_swin_apply_step(self, opt, scale):
        def apply_(state, adam, grads, key, it, frame, do_adam, *a):
            self.log.append(("apply", int(it), int(frame), bool(do_adam)))
            return state, adam
        return apply_

    def make_swin_densify_step(self, cap, window):
        def densify(state, adam, key, window_start, genesis):
            self.log.append(("densify", int(window_start), bool(genesis)))
            return state, adam
        return densify

    def make_swin_eval_step(self, s):
        return None

    def evolve(self, state, adam, mgr, dump_path, sh):
        self.log.append(("evolve", str(mgr)))
        open(dump_path, "ab").close()
        return state, adam

    def mature_rest(self, state, adam, dump_path, sh):
        self.log.append(("mature_rest",))
        return state, adam


def _stub_raster(num_dup, shape):
    class Out(NamedTuple):
        image: object
        num_dup: object

    def rasterize(*args, **kw):
        return Out(jnp.zeros(shape, jnp.float32), jnp.int32(num_dup))
    return rasterize


@pytest.fixture
def default_rngs(monkeypatch):
    """Every np.random.default_rng(seed) made while it is active, as (seed,
    generator): the soaks' main generator is the first seeded 0."""
    made, orig = [], np.random.default_rng

    def recorder(seed=None):
        g = orig(seed)
        made.append((seed, g))
        return g
    monkeypatch.setattr(np.random, "default_rng", recorder)
    return made


def _main_rng(made):
    return next(g for s, g in made if s == 0).bit_generator.state


# ------------------------------------------------------------ 30k soak ----

def _dup_30k(it):
    """A num_dup trace over the 30k schedule that takes every branch of
    the budget policy: an overflow and growth (x2-damped) at 2,000, shrink
    suggestions held back before 25,000, a shrink at 25,000, the one
    tighten at 25,400, and a shrink at 27,000."""
    if it < 2000:
        return 100_000
    if it < 9000:
        return 600_000
    if it < 25_000:
        return 700_000
    return 600_000 if it < 27_000 else 200_000


@pytest.fixture(scope="module")
def port_30k():
    """The port's set-up at soak_30k.py's CPU sizes (real renders and
    probe) and the generator's state after it."""
    rng = np.random.default_rng(0)
    su = tsoak_30k.setup("cpu", rng)
    return su, rng.bit_generator.state


def _run_jax_30k(monkeypatch, tmp_path, need):
    rec = Recorder(None, int)
    rec.trace = lambda n: _dup_30k(rec.it)
    states = []
    orig_create = jgauss.create_from_points

    def create(*a, **kw):
        states.append(orig_create(*a, **kw))
        return states[-1]

    monkeypatch.setattr(graft, "_orbit_cameras",
                        lambda n, w, h: list(range(n)))
    monkeypatch.setattr(jrast, "rasterize", _stub_raster(need, (3, 4, 4)))
    monkeypatch.setattr(jgauss, "create_from_points", create)
    for name in ("make_train_step", "make_densify_step", "make_eval_step"):
        monkeypatch.setattr(jstep, name, getattr(rec, name))
    monkeypatch.setattr(soak_30k, "_dump_stats", rec.dump)
    monkeypatch.setattr(jax.random, "split", lambda k: (k, k))
    monkeypatch.setattr("sys.argv", ["soak_30k.py", "--stats_out",
                                     str(tmp_path / "jax_stats.npz")])
    soak_30k.main()
    return rec, states[0]


def test_30k_loop_control_matches_jax(monkeypatch, tmp_path, port_30k,
                                      default_rngs, capsys):
    """soak_30k.main and the port's loop over all 30,010 iterations on one
    scripted num_dup trace: every logged decision and the generator's
    final state identical; the initial state within 1e-6 (its 3-NN
    log-scales 1e-5 relative)."""
    su, after_setup = port_30k
    rng = np.random.default_rng()
    rng.bit_generator.state = after_setup
    cams = {id(c): i for i, c in enumerate(su["cams"])}
    rec = Recorder(None, lambda c: cams[id(c)])
    rec.trace = lambda n: _dup_30k(rec.it)
    monkeypatch.setattr(tsoak_30k, "step_lib", rec)
    monkeypatch.setattr(tsoak_30k, "dump_stats", rec.dump)
    res, _, _ = tsoak_30k.run(su, rng, 30_010, 1000,
                              str(tmp_path / "s.npz"), say=lambda s: None)
    n_made = len(default_rngs)
    jrec, jstate = _run_jax_30k(monkeypatch, tmp_path, su["need"])
    assert len(rec.log) == len(jrec.log) > 30_010
    assert rec.log == jrec.log
    assert rec.builds == jrec.builds == [524_288, 1_800_192, 960_000,
                                         784_000, 320_000]
    assert rng.bit_generator.state == _main_rng(default_rngs[n_made:])
    assert res["recompiles"] == 4 and res["dup_peak"] == 700_000
    assert [o["it"] for o in res["overflows"]] == [2000]
    assert [e["it"] for e in res["eval_log"]] == list(
        range(1000, 30_001, 1000)) + [30_010]
    # the 3-NN log-scales carry each package's distance arithmetic: 1e-5
    # relative, test_torch_train's create_from_points tolerance
    for k, v in jstate.params().items():
        tol = dict(rtol=1e-5, atol=0) if k == "scaling" else dict(
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(su["state"].params()[k].numpy(),
                                   np.asarray(v), err_msg=k, **tol)
    assert su["state"].n_alive == int(jstate.n_alive) == 50
    capsys.readouterr()


def test_30k_ground_truth_matches_jax(port_30k):
    """The held-out cameras' ground truths (``_make_scene(500, 3, seed=5)``
    at 128x128 through the training path) within 5e-5 of JAX's rasterize
    in interpret mode: the training rasterizer's image tolerance against
    JAX (test_torch_train_raster). They sit 1.4e-5 to 1.7e-5 apart, as
    far on JAX's own leaves as on the port's."""
    su, _ = port_30k
    cfg = tsoak_30k.SIZES["cpu"]
    scene = graft._make_scene(cfg["p_gt"], 3, seed=5)
    cams = graft._orbit_cameras(24, cfg["width"], cfg["height"])
    settings = jrast.RasterizeSettings(k_dup=cfg["k_gt"], tile_x=64,
                                       tile_y=16, chunk=128, interpret=True,
                                       layout="chw", super_chunks=1)
    render = jax.jit(lambda c: jrast.rasterize(*scene, c, 3, jnp.zeros(3),
                                               settings).image)
    for i in tsoak_30k.TEST_IDX:
        np.testing.assert_allclose(su["gts"][i].numpy(),
                                   np.asarray(render(cams[i])), atol=5e-5,
                                   err_msg=f"camera {i}")


# ----------------------------------------------------------- swin soak ----

# the flags the loop-control test gives both soaks (JAX's on a backend it
# takes for a chip, so that it keeps them): soak_swin.py's CPU cap, frames
# and window, with genesis and windows long enough to densify (the CPU
# schedule's 60 and 30 iterations never reach an interval of 100)
SWIN_FLAGS = dict(cap=2000, frames=12, swin_size=8, genesis_iters=700,
                  window_iters=250)
SWIN_NEED = 20_000


def _dup_swin(k0):
    """num_dup rising by 1% of the first budget a rendering step: the
    budget regrows (x1.5 at 95%) several times over the schedule."""
    return lambda n: int(k0 * (0.5 + 0.01 * n))


def test_swin_loop_control_matches_jax(monkeypatch, tmp_path, default_rngs,
                                       capsys):
    """soak_swin.main and the port's windows on one scripted num_dup trace,
    the frame-0 probe stubbed on both sides: each iteration's frame,
    camera and split, every densification, evolve and budget regrow, and
    the generator's final state identical; the GT motion arrays
    bit-equal."""
    class Probe(NamedTuple):
        num_dup: torch.Tensor

    monkeypatch.setattr(trast, "rasterize",
                        lambda *a, **kw: Probe(torch.tensor(SWIN_NEED)))
    args = argparse.Namespace(**SWIN_FLAGS, out=str(tmp_path / "port"),
                              device="cpu")
    rng = np.random.default_rng(0)
    su = tsoak_swin.setup("cpu", rng, args, cfg=tsoak_swin.SIZES["cuda"])
    k0 = su["settings"].k_dup
    cams = {id(c): i for i, c in enumerate(su["cams"])}
    rec = Recorder(_dup_swin(k0), lambda c: cams[id(c)])
    monkeypatch.setattr(tsoak_swin, "sstep", rec)
    monkeypatch.setattr(tsoak_swin, "train_swin", types.SimpleNamespace(
        StepBox=tsoak_swin.train_swin.StepBox,
        densify_due=tsoak_swin.train_swin.densify_due,
        evolve=rec.evolve, mature_rest=rec.mature_rest))
    su["gt_at"] = lambda f, ci: None
    soak = tsoak_swin.Soak(su, rng, args, say=lambda s: None)
    tsoak_swin.train(soak, args.out)
    port_rng = rng.bit_generator.state

    jrec = Recorder(_dup_swin(k0), int)
    motion = []

    def deform(means, quats, v, rotvec, rotcen, frame):
        motion.append([np.asarray(a) for a in (v, rotvec, rotcen)])
        return means, quats

    shape = (3, 2, 2)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "jit", lambda f=None, **kw: f)
    monkeypatch.setattr(graft, "_orbit_cameras",
                        lambda n, w, h: list(range(n)))
    monkeypatch.setattr(jrast, "rasterize", _stub_raster(SWIN_NEED, shape))
    monkeypatch.setattr(jquat, "rigid_deform", deform)
    for name in ("make_swin_train_step", "make_swin_grad_step",
                 "make_swin_apply_step", "make_swin_densify_step",
                 "make_swin_eval_step"):
        monkeypatch.setattr(jsstep, name, getattr(jrec, name))
    monkeypatch.setattr(jtrain_swin, "evolve", jrec.evolve)
    monkeypatch.setattr(jtrain_swin, "mature_rest", jrec.mature_rest)
    monkeypatch.setattr(jswin, "decay_genesis", lambda s: s)
    monkeypatch.setattr(jrender_stream, "load_stream_state",
                        lambda out: {"xyz": np.zeros((1, 3))})
    monkeypatch.setattr(jrender_stream, "render_stream_frame",
                        lambda *a: np.zeros(shape[1:] + (3,)))
    monkeypatch.setattr(jax.random, "split", lambda k: (k, k))
    monkeypatch.setattr("sys.argv", ["soak_swin.py", "--out",
                                     str(tmp_path / "jax")] + [
        f"--{k}={v}" for k, v in SWIN_FLAGS.items()])
    soak_swin.main()

    assert rec.log == jrec.log
    assert [e for e in rec.log if e[0] == "densify"] == [
        ("densify", 0, True)] * 2 + [
        ("densify", s, False) for s in range(1, 5) for _ in range(2)]
    assert [e for e in rec.log if e[0] == "evolve"] == [
        ("evolve", f"window[{s}:{s + 8}]") for s in range(1, 5)]
    assert rec.builds == jrec.builds and len(rec.builds) == 1 + soak.regrows
    assert soak.regrows >= 3
    assert [(c["from"], c["to"]) for c in soak.budget_changes] == list(
        zip(rec.builds, rec.builds[1:]))
    assert port_rng == _main_rng(default_rngs)
    for got, want in zip(su["motion"], motion[0], strict=True):
        np.testing.assert_array_equal(got, want)
    capsys.readouterr()


def _json_keys(path):
    """The keys of the dict literal passed to the script's json.dumps."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps dict in {path}")


PORT_KEYS = {"config", "peak_mem_gb", "kernel_launches"}


def test_swin_cpu_run(tmp_path, capsys):
    """``torch_soak_swin.py --device cpu``: the first evolve streams every
    genesis row, each later tick cap / swin rows, mature_rest the rest,
    and the stream holds their sum; soak_swin.py's keys and the port's."""
    out = tmp_path / "swin"
    assert tsoak_swin.main(["--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _json_keys(SCRIPTS / "soak_swin.py") | PORT_KEYS | {
        "matured_per_tick", "budget_changes"} == set(res)
    cap, swin = 2000, 8
    assert res["matured_per_tick"] == [cap] + [cap // swin] * 3 + [cap]
    assert res["stream_records"] == sum(res["matured_per_tick"]) == 4750
    assert res["stream_bytes"] == (out / "streamable.dat").stat().st_size
    assert res["config"]["device"] == "cpu" and res["peak_mem_gb"] is None
    assert len(res["windows"]) == 5 and all(
        np.isfinite(w["loss"]) for w in res["windows"])
    assert [f for f, _ in res["playback_psnr"]] == list(range(12))
    assert all(np.isfinite(p) for _, p in res["playback_psnr"])


def test_30k_cpu_run(tmp_path, capsys):
    """``torch_soak_30k.py --device cpu`` for a few iterations: soak_30k.py's
    keys and the port's, one report, and a stats file with _dump_stats's
    keys."""
    stats = tmp_path / "stats.npz"
    assert tsoak_30k.main(["--device", "cpu", "--iterations", "3",
                           "--stats_out", str(stats)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _json_keys(SCRIPTS / "soak_30k.py") | PORT_KEYS | {
        "budget_changes", "overflows", "densify_ms"} == set(res)
    assert [e["it"] for e in res["eval_log"]] == [3]
    assert np.isfinite(res["final_psnr"]) and res["final_k_dup"] == 524_288
    with np.load(stats) as got:
        assert set(got.files) == {
            "opacity_quantiles", "logscale_quantiles",
            "logscale_sorted_quantiles", "aniso_quantiles", "xyz_std",
            "xyz_sample", "n_alive", "source"}
        assert int(got["n_alive"]) == 50


def test_dump_stats_matches_jax(tmp_path):
    """Both packages' stats dumps of one state's arrays: bit-equal, but the
    opacity quantiles, which carry each package's sigmoid (XLA's and
    torch's round 0.4% of float32 logits to neighbouring values) and are
    held to one float32 ulp."""
    rng = np.random.default_rng(3)
    cap, n = 3000, 2600
    leaves = dict(xyz=rng.normal(size=(cap, 3)),
                  f_dc=rng.normal(size=(cap, 1, 3)),
                  f_rest=rng.normal(size=(cap, 15, 3)),
                  scaling=rng.uniform(-6, -1, (cap, 3)),
                  rotation=rng.normal(size=(cap, 4)),
                  opacity=rng.uniform(-6, 6, (cap, 1)))
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    from gsplat_tpu_torch.model import gaussians as tgauss

    tstate = tgauss.state_from_numpy(leaves, n, 3, device="cpu")
    jstate = jgauss.GaussianState(
        xyz=jnp.asarray(leaves["xyz"]), features_dc=jnp.asarray(
            leaves["f_dc"]), features_rest=jnp.asarray(leaves["f_rest"]),
        scaling=jnp.asarray(leaves["scaling"]),
        rotation=jnp.asarray(leaves["rotation"]),
        opacity=jnp.asarray(leaves["opacity"]), n_alive=jnp.int32(n),
        max_sh_degree=3)
    soak_30k._dump_stats(jstate, str(tmp_path / "jax.npz"), "src")
    tsoak_30k.dump_stats(tstate, str(tmp_path / "port.npz"), "src")
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k == "opacity_quantiles":
                np.testing.assert_allclose(b[k], a[k], rtol=0,
                                           atol=np.spacing(np.float32(1)))
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("script", ["torch_soak_30k", "torch_soak_swin"])
def test_no_card_prints_failure_line_and_exits_1(monkeypatch, capsys,
                                                 script):
    mod = {"torch_soak_30k": tsoak_30k, "torch_soak_swin": tsoak_swin}[script]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "CUDA device unavailable" in line["config"]["error"]


# --------------------------------------------------------- run scripts ----

RUN_SCRIPTS = ["eval", "run_swin", "run_exp1", "run_deform",
               "run_hyperTuning"]


class _Parsed(Exception):
    pass


def _calls(text):
    """(module, argv) of every ``python -m`` line, shell variables given a
    value (${X:-default} its default, loop variables "1")."""
    text = re.sub(r"\\\n\s*", " ", text)
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("python -m "):
            continue
        line = re.sub(r"\$\{?(\w+)\}?", "1", line)
        words = shlex.split(line)
        out.append((words[2], words[3:]))
    return out


@pytest.mark.parametrize("name", RUN_SCRIPTS)
def test_run_script_is_the_jax_one_on_the_port(monkeypatch, name):
    """scripts/torch_<name>.sh is scripts/<name>.sh with gsplat_tpu.
    replaced by gsplat_tpu_torch.; every module it runs has a main whose
    parser takes every flag the script passes."""
    jax_text = (SCRIPTS / f"{name}.sh").read_text()
    text = (SCRIPTS / f"torch_{name}.sh").read_text()
    want = jax_text.replace("gsplat_tpu.", "gsplat_tpu_torch.").replace(
        "the gsplat_tpu equivalent", "the gsplat_tpu_torch equivalent")
    assert text == want
    assert not re.search(r"gsplat_tpu(?!_torch)", text)
    calls = _calls(text)
    assert calls and len(calls) == len(_calls(jax_text))
    orig = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    for module, argv in calls:
        assert module.startswith("gsplat_tpu_torch.")
        mod = importlib.import_module(module)
        with pytest.raises(_Parsed) as got:
            mod.main(argv)
        parsed = vars(got.value.args[0])
        for flag in (a for a in argv if a.startswith("--")):
            assert flag[2:] in parsed, (module, flag)


def test_scripts_call_nothing_of_the_jax_side():
    for path in [*SCRIPTS.glob("torch_soak_*.py"),
                 *SCRIPTS.glob("torch_*.sh")]:
        text = path.read_text()
        assert not re.search(r"\bgsplat_tpu\.|import gsplat_tpu\b"
                             r"|\bjax\b|__graft_entry__|\bimport bench\b",
                             text), path.name




def test_trained_stats_diff(tmp_path, capsys):
    """scripts/torch_trained_stats_diff.py: zero against itself; a shifted
    copy's differences where they were put."""
    diff = _load("torch_trained_stats_diff")
    fixture = REPO / "tests" / "fixtures" / "trained_stats.npz"
    with np.load(fixture) as st:
        arrays = dict(st)
    arrays["opacity_quantiles"] = arrays["opacity_quantiles"] + 0.25
    arrays["logscale_sorted_quantiles"][0] -= 2.0
    arrays["logscale_sorted_quantiles"][5, 1] += 0.5
    np.savez(tmp_path / "shifted.npz", **arrays)
    assert diff.main([str(fixture)]) == 0
    same = json.loads(capsys.readouterr().out)
    assert same["opacity_quantiles_max_abs_diff"] == 0.0
    assert same["logscale_sorted_quantiles_max_abs_diff"] == 0.0
    got = diff.compare(str(tmp_path / "shifted.npz"), str(fixture))
    assert got["opacity_quantiles_max_abs_diff"] == pytest.approx(0.25)
    assert got["logscale_sorted_quantiles_max_abs_diff"] == pytest.approx(2)
    assert got["logscale_sorted_quantiles_max_abs_diff_inner"] == \
        pytest.approx(0.5)
    assert got["median_opacity"][0] == pytest.approx(
        got["median_opacity"][1] + 0.25)
