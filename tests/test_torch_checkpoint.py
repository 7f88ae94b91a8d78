"""Checkpoints, resume, RNG replay, profiling and --frame in
gsplat_tpu_torch against the JAX package on the CPU.

- ``utils/checkpoint``: a JAX-written .npz (``save`` and the SwinGS
  ``save_pytree``) loads in the port and a port-written one in JAX: the
  same key set, every array bit-equal, the same meta;
- ``step.make_densify_replay_step`` vs JAX's on the same injected draws:
  moments and untouched rows exact, the relocated values within the
  forced-relocation tolerance of tests/test_torch_train.py;
- ``--replay_rng`` on the committed Blender fixture with a schedule the
  test writes in train/replay.py's format (random cameras by name, noise,
  three densification events): the port CLI vs the JAX CLI per-iteration
  loss rel <= 4.1e-4 (the JAX-vs-reference bound); the port resumed from
  its own checkpoint at iteration 5 repeats every later loss and the final
  parameters bit for bit; the port resumed from JAX's checkpoint at 5
  follows JAX's run after that checkpoint within 4.1e-4. Neither package
  saves its random streams, so only a replayed run resumes exactly;
- ``--profile_iterations`` writes a trace that holds the training step's
  spans by name;
- ``--frame`` on the committed dynamic fixture: the same train and test
  cameras as JAX's trainer and the first iterations' losses within
  4.1e-4.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.model import optim as joptim
from gsplat_tpu.train import step as jstep
from gsplat_tpu.train import train_static as jtrain
from gsplat_tpu.utils import checkpoint as jckpt
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.model import optim as toptim
from gsplat_tpu_torch.train import step as tstep
from gsplat_tpu_torch.train import train_static as ttrain
from gsplat_tpu_torch.utils import checkpoint as tckpt
from gsplat_tpu_torch.utils import profiling
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import make_params
from tests.test_torch_swin import state_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLENDER = os.path.join(ROOT, "tests", "fixtures", "quality_blender")
DYN = os.path.join(ROOT, "tests", "fixtures", "quality_cudaport_dyn")
T = torch.from_numpy
LOSS_REL = 4.1e-4


def _one_chunk_per_step(mp):
    """JAX's CLI settings with one chunk per grid step: its interpret-mode
    programs compile ~2.5x faster than at the default 8, and the results
    do not depend on it."""
    real = jtrain.make_settings
    mp.setattr(jtrain, "make_settings", lambda *a: dataclasses.replace(
        real(*a), super_chunks=1))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _adam_pair(par, seed=1):
    """Nonzero moments: one Adam step of random gradients on both sides."""
    rng = np.random.default_rng(seed)
    g = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in par.items()}
    zero = {k: 0.0 for k in g}
    ts = tgauss.state_from_numpy(par, 300, 1, "cpu")
    js = jax_state(par, 300, 1)
    tadam = toptim.step(ts.params(), {k: T(v) for k, v in g.items()},
                        toptim.init(ts.params()), zero)[1]
    jadam = joptim.step(js.params(), {k: jnp.asarray(v)
                                      for k, v in g.items()},
                        joptim.init(js.params()), zero)[1]
    return ts, js, tadam, jadam


def _same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert set(za.files) == set(zb.files)
    for k in za.files:
        if k == "__meta__":
            assert json.loads(str(za[k])) == json.loads(str(zb[k]))
        else:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_checkpoint_interchanges_with_jax(tmp_path):
    par = make_params(p=300, cap=400, deg=1, seed=2)
    ts, js, tadam, jadam = _adam_pair(par)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jpath, js, jadam, 1234, extra={"note": "x"})
    tckpt.save(tpath, ts, tadam, 1234, extra={"note": "x"})
    _same_npz(jpath, tpath)
    st, ad, it, extra = tckpt.load(jpath, "cpu")
    assert (it, extra, st.n_alive, st.max_sh_degree, ad.count) == (
        1234, {"note": "x"}, 300, 1, 1)
    for k, v in js.params().items():
        np.testing.assert_array_equal(_np(st.params()[k]), np.asarray(v))
        np.testing.assert_array_equal(_np(ad.mu[k]), np.asarray(jadam.mu[k]))
        np.testing.assert_array_equal(_np(ad.nu[k]), np.asarray(jadam.nu[k]))
    jst, jad, jit_, _ = jckpt.load(tpath)
    assert (jit_, int(jst.n_alive), int(jad.count)) == (1234, 300, 1)
    for k, v in ts.params().items():
        np.testing.assert_array_equal(np.asarray(jst.params()[k]), _np(v))


def test_swin_pytree_checkpoint_interchanges_with_jax(tmp_path):
    ts, js, tadam, jadam = state_pair(seed=5, adam=True)
    meta = {"iteration": 7, "swin": {"frame_start": 2, "frame_end": 6}}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_pytree(jpath, {"state": js, "adam": jadam}, meta=meta)
    tckpt.save_pytree(tpath, {"state": ts, "adam": tadam}, meta=meta)
    _same_npz(jpath, tpath)
    # load into zeroed templates of the other package
    zt = {"state": ts.replace_params({k: torch.zeros_like(v) for k, v in
                                      ts.params().items()}),
          "adam": toptim.init(ts.params())}
    tree, m = tckpt.load_pytree(jpath, zt)
    assert m == meta
    tckpt.save_pytree(str(tmp_path / "t2.npz"), tree, meta=m)
    _same_npz(jpath, str(tmp_path / "t2.npz"))
    jtree, m = jckpt.load_pytree(tpath, {"state": js, "adam": jadam})
    jckpt.save_pytree(str(tmp_path / "j2.npz"), jtree, meta=m)
    _same_npz(tpath, str(tmp_path / "j2.npz"))


def test_densify_replay_step_matches_jax():
    par = make_params(p=300, cap=400, deg=1, seed=6)
    ts, js, tadam, jadam = _adam_pair(par, seed=3)
    rng = np.random.default_rng(8)
    dead = np.zeros(400, bool)
    dead[rng.choice(300, 12, replace=False)] = True
    reloc = np.arange(400, dtype=np.int32)
    reloc[dead] = rng.choice(np.nonzero(~dead[:300])[0], 12)
    add = np.arange(400, dtype=np.int32)
    add[300:315] = rng.integers(0, 300, 15)
    got_s, got_a = tstep.make_densify_replay_step()(
        ts, tadam, T(dead), T(reloc), T(add), 315)
    want_s, want_a = jstep.make_densify_replay_step(400)(
        js, jadam, jnp.asarray(dead), jnp.asarray(reloc), jnp.asarray(add),
        jnp.asarray(315, jnp.int32))
    assert got_s.n_alive == int(want_s.n_alive) == 315
    # the relocated opacity and scale come from the relocation's power
    # series, which XLA evaluates in another order: 1 ulp apart at a few
    # entries (test_torch_train's forced-relocation tolerance); every
    # other value and both moments are exact
    moved = np.zeros(400, bool)
    moved[dead] = moved[reloc[dead]] = True
    moved[300:315] = moved[add[300:315]] = True
    for k, v in want_s.params().items():
        got, want = _np(got_s.params()[k]), np.asarray(v)
        np.testing.assert_array_equal(got[~moved], want[~moved], err_msg=k)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(_np(got_a.mu[k]),
                                      np.asarray(want_a.mu[k]))
        np.testing.assert_array_equal(_np(got_a.nu[k]),
                                      np.asarray(want_a.nu[k]))


# ------------------------------------------------------ the replay runs ----

ITERS, CKPT, CAP = 10, 5, 320
DENSIFY_AT = (3, 6, 9)


def write_schedule(path, names, n_init=256, seed=0):
    """A schedule in train/replay.py's format: a random camera name per
    iteration, standard normal noise, and at each densification a few dead
    rows relocated onto live ones and ~5% growth."""
    rng = np.random.default_rng(seed)
    z = {"camera_names": np.array([names[i] for i in
                                   rng.integers(0, len(names), ITERS)])}
    n = n_init
    for j, it in enumerate(DENSIFY_AT):
        dead = np.zeros(n, bool)
        dead[rng.choice(n, 4, replace=False)] = True
        z[f"densify_iter_{j}"] = np.asarray(it)
        z[f"dead_{j}"] = dead
        z[f"reloc_t_{j}"] = rng.choice(np.nonzero(~dead)[0], 4).astype(
            np.int32)
        z[f"add_p_{j}"] = np.asarray(n)
        grow = min(CAP, int(1.05 * n)) - n
        z[f"add_t_{j}"] = rng.integers(0, n, grow).astype(np.int32)
        n += grow
    for it in range(1, ITERS):
        z[f"noise_{it:05d}"] = rng.normal(size=(CAP, 3)).astype(np.float32)
    np.savez(path, **z)
    return n


def _flags(dataset, out, schedule, extra=()):
    return ["-s", dataset, "-m", out, "-w", "--cap_max", str(CAP),
            "--iterations", str(ITERS), "--densify_from_iter", "2",
            "--densify_until_iter", "10", "--densification_interval", "3",
            "--test_iterations", "-1", "--save_iterations", "-1",
            "--dup_budget", "16384", "--tile_x", "16", "--tile_y", "16",
            "--replay_rng", schedule] + list(extra)


def _losses(out):
    with open(os.path.join(out, "parity_ours.json")) as f:
        return {it: loss for it, _, loss in json.load(f)["losses"]}


@pytest.fixture(scope="module")
def replay_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("replay")
    dataset = str(root / "dataset")
    shutil.copytree(BLENDER, dataset)
    schedule = str(root / "schedule.npz")
    n_final = write_schedule(schedule, [f"r_{i}" for i in range(8)])
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    _one_chunk_per_step(mp)
    try:
        runs = {}
        for name, main, extra in (
                ("jax", jtrain.main, ["--checkpoint_iterations", str(CKPT)]),
                ("port", ttrain.main, ["--checkpoint_iterations", str(CKPT),
                                       "--data_device", "cpu"])):
            out = str(root / name)
            runs[name] = (out, main(_flags(dataset, out, schedule, extra)))
        for name, src in (("port_resumed", "port"), ("from_jax", "jax")):
            out = str(root / name)
            ckpt = os.path.join(runs[src][0], f"chkpnt{CKPT}.npz")
            runs[name] = (out, ttrain.main(_flags(
                dataset, out, schedule,
                ["--start_checkpoint", ckpt, "--data_device", "cpu"])))
    finally:
        mp.undo()
    runs["n_final"] = n_final
    return runs


def test_replay_cli_matches_jax(replay_runs):
    jl, tl = _losses(replay_runs["jax"][0]), _losses(replay_runs["port"][0])
    assert sorted(tl) == sorted(jl) == list(range(1, ITERS + 1))
    for it in jl:
        assert abs(tl[it] - jl[it]) <= LOSS_REL * abs(jl[it]), it
    with open(os.path.join(replay_runs["port"][0], "parity_ours.json")) as f:
        diag = json.load(f)["densify_diagnostics"]
    assert [d["iteration"] for d in diag] == list(DENSIFY_AT)
    assert replay_runs["port"][1]["state"].n_alive == \
        replay_runs["n_final"] > 256


def test_resume_under_replay_is_exact(replay_runs):
    full, resumed = replay_runs["port"], replay_runs["port_resumed"]
    fl, rl = _losses(full[0]), _losses(resumed[0])
    assert sorted(rl) == list(range(CKPT + 1, ITERS + 1))
    assert all(rl[it] == fl[it] for it in rl)
    a, b = full[1]["state"], resumed[1]["state"]
    assert a.n_alive == b.n_alive
    for k, v in a.params().items():
        assert torch.equal(v, b.params()[k]), k
    for k, v in full[1]["adam"].mu.items():
        assert torch.equal(v, resumed[1]["adam"].mu[k]), k


def test_resume_from_jax_checkpoint_follows_jax(replay_runs):
    jl, tl = _losses(replay_runs["jax"][0]), \
        _losses(replay_runs["from_jax"][0])
    assert sorted(tl) == list(range(CKPT + 1, ITERS + 1))
    for it in tl:
        assert abs(tl[it] - jl[it]) <= LOSS_REL * abs(jl[it]), it


# ------------------------------------------------------------ profiling ----

def test_profile_iterations_write_a_trace(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "model")
    ttrain.main(["-s", BLENDER, "-m", out, "-w", "--cap_max", "256",
                 "--iterations", "4", "--test_iterations", "-1",
                 "--save_iterations", "-1", "--dup_budget", "16384",
                 "--profile_iterations", "2", "4", "--data_device", "cpu"])
    trace = os.path.join(out, "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("index_add" in n or "sort" in n for n in names)
    assert {"train.step", "train.loss", "train.backward", "raster.binning",
            "raster.reduce", "train.adam", "train.noise"} <= names
    assert profiling.spans() == []          # the trace's stop empties them
    with profiling.trace(str(tmp_path / "p")) as t:
        with profiling.span("tagged"):
            torch.ones(8).sum()
    assert os.path.exists(t.path)
    with open(t.path) as f:
        assert "tagged" in {e.get("name") for e in json.load(f)["traceEvents"]}


# ---------------------------------------------------------------- frame ----

def _record(monkeypatch, mod, step_mod):
    """Per-iteration (view matrix, loss) of the trainer's fused step and
    the camera names handed to its eval report."""
    seen = {"steps": [], "eval": None}
    real = step_mod.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def wrapped(*args, **kwargs):
            out = step(*args, **kwargs)
            seen["steps"].append((np.asarray(_np(args[3].view)),
                                  float(out[2].loss)))
            return out
        return wrapped

    monkeypatch.setattr(step_mod, "make_train_step", make)
    monkeypatch.setattr(mod, "_report_eval", lambda _tb, _ev, _st, test,
                        *a, train_cams=(), **kw: seen.__setitem__(
                            "eval", ([c.image_name for c in test],
                                     [c.image_name for c in train_cams])))
    return seen


def test_frame_trains_one_frame_like_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    dataset = str(tmp_path / "dyn")
    shutil.copytree(DYN, dataset)
    flags = ["-s", dataset, "--frame", "1", "--max_frame", "3",
             "--init_type", "sfm",
             "--cap_max", "1024", "--iterations", "4",
             "--test_iterations", "4", "--save_iterations", "-1",
             "--dup_budget", "8192", "--tile_x", "16", "--tile_y", "16"]
    _one_chunk_per_step(monkeypatch)
    jseen = _record(monkeypatch, jtrain, jtrain.step_lib)
    jtrain.main(flags + ["-m", str(tmp_path / "jax")])
    tseen = _record(monkeypatch, ttrain, ttrain.step_lib)
    ttrain.main(flags + ["-m", str(tmp_path / "port"),
                         "--data_device", "cpu"])
    assert tseen["eval"] == jseen["eval"] and tseen["eval"][0]
    assert len(tseen["steps"]) == len(jseen["steps"]) == 4
    for (tv, tl), (jv, jl) in zip(tseen["steps"], jseen["steps"]):
        np.testing.assert_array_equal(tv, jv)
        assert abs(tl - jl) <= LOSS_REL * abs(jl)
