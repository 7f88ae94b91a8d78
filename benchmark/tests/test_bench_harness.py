"""CPU tests of the benchmark's harness: BENCHMARK.json against its
format's rules (names, units, sizes, bounds), every file of a cell found
by name, the import rules, the no-card exit, and the loops at tiny sizes
against the reference, with the control and planted faults failing the
check.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import ast
import copy
import glob
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, ROOT)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "gsplat_tpu"}
VIEW = "mcmc-1m.view-1080p"
# The 1M training cell is not committed: its limits wait until the
# program's sort + scan gradient reduction keeps small gradients
# (PERF.md). Its loop, reference, readers and control are held here at
# tiny sizes, under limits of these tests' own (CPU readings 4.9e-6,
# 1.4e-5 and 9.9e-8).
TRAIN = "mcmc-1m.train"
TINY_TRAIN_LIMITS = {"loss_rel": 1e-4, "grad_norm_gap": 1e-3,
                     "change_norm_gap": 1e-3}
TRAIN_LAYER = ("densify_ms.train", "launches_per_step.train",
               "idle_share.train", "peak_device_gb.train",
               "torch_ops_device_ms.train", "step_mfu.train",
               "blend_fwd_roofline.train", "blend_bwd_roofline.train")


def with_training(bench):
    """``bench`` with the 1M training cell and its metrics added."""
    b = copy.deepcopy(bench)
    b["workloads"].append({"name": TRAIN, "config": "mcmc-1m",
                           "traffic": "train", "chips": 1, "why": "tests"})
    b["end_to_end"].append({"name": "train_ms_per_step", "unit": "ms",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock", "workloads": [TRAIN]})
    b["per_layer"] += [{"name": n, "unit": "x", "better": "lower",
                        "source": "device_trace", "layer": "x",
                        "moves": "train_ms_per_step", "workloads": [TRAIN]}
                       for n in TRAIN_LAYER]
    return b


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_check_time_fits(bench):
    """2 + 14 runs a cell at run_seconds + 60 s each, 180 s of compiles a
    cell and 1,200 s spare fit 43,200 s with all 24 cells."""
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_every_file_found_by_name(bench):
    from benchmark import harness

    for w in bench["workloads"]:
        assert set(harness.load_cell(w["name"], bench)["mix"]["check"])
    full = with_training(bench)
    for w in full["workloads"]:
        cell = harness.load_cell(w["name"], full)
        assert hasattr(cell["loop"], "Loop")
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(harness.reader(m["name"]).read)
    for m in full["end_to_end"] + full["per_layer"]:
        assert os.path.exists(harness.reader_path(m["name"]))


def test_a_split_metric_falls_back_to_its_base_reader():
    from benchmark import harness

    assert harness.reader_path("idle_share.view").endswith(
        os.path.join("metrics", "idle_share.py"))
    assert harness.reader_path("step_mfu.train").endswith(
        os.path.join("metrics", "step_mfu.train.py"))


def test_moves_is_reported_where_the_metric_is(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        where = m.get("workloads", cells)
        assert set(where) <= cells
        for cell in where:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_layers_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


def _loaded_in_fresh_process(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_imports_jax_or_the_jax_package():
    code = (
        "import glob, json, os, sys; sys.path.insert(0, '.');"
        "from benchmark import harness, inputs, control, trace;"
        "import benchmark.reference.train, benchmark.reference.view;"
        "import benchmark.counts.train_step, benchmark.counts.view_frame;"
        "[harness.load_module(p, 'm%d' % i) for i, p in enumerate("
        "sorted(glob.glob('benchmark/loops/*.py')"
        " + glob.glob('benchmark/metrics/*.py')))];"
        "import gsplat_tpu_torch.train.step, gsplat_tpu_torch.viewer.serve;"
        "import gsplat_tpu_torch.viewer.network_gui;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _loaded_in_fresh_process(code)
    assert "gsplat_tpu_torch" in tops        # the port is loaded ...
    assert not tops & FORBIDDEN              # ... and nothing forbidden


def test_top_level_names_compared_whole():
    from benchmark import harness

    assert harness.forbidden_modules({"gsplat_tpu_torch.raster": 1,
                                      "jaxtyping": 1}) == []
    assert harness.forbidden_modules({"gsplat_tpu.raster": 1,
                                      "jax.numpy": 1}) == ["gsplat_tpu",
                                                           "jax"]


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, '.');"
            "import benchmark.reference.raster, benchmark.reference.train;"
            "import benchmark.reference.view, benchmark.inputs;"
            "print(json.dumps(sorted({m.split('.')[0]"
            " for m in sys.modules})))")
    tops = _loaded_in_fresh_process(code)
    assert not tops & (FORBIDDEN | {"gsplat_tpu_torch"})
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")) + [
            os.path.join(BENCH, "inputs.py")]:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""])
                for mod in mods:
                    assert mod.split(".")[0] not in FORBIDDEN | {
                        "gsplat_tpu_torch"}, (path, mod)


def test_no_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", VIEW,
         "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_alone_without_the_program_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", VIEW,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout


# ------------------------------------------------- loops at tiny sizes ----

def tiny(name):
    """The cell at a size the CPU runs in seconds: 3,000 Gaussians, a few
    frames; everything else as committed (the training cell as
    ``with_training`` adds it)."""
    import torch

    from benchmark import harness

    torch.set_num_threads(2)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.load_cell(name, with_training(json.load(f)))
    if name == TRAIN:
        cell["mix"] = dict(cell["mix"], check=TINY_TRAIN_LIMITS)
    cfg = copy.deepcopy(cell["cfg"])
    cfg["gaussians"] = cfg["cap_max"] = 3000
    cfg["train"].update(width=160, height=96)
    cfg["gt"]["gaussians"] = 500
    cell["cfg"] = cfg
    if cell["mix"]["loop"] == "view":
        cell["mix"].update(width=256, height=128, samples=2,
                           probe_every_deg=90)
    return cell


def run_tiny(name, seconds=1.0):
    import time

    from benchmark import harness

    return harness.measure(tiny(name), 3000000019, seconds, False, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("name", [TRAIN, VIEW])
def test_loop_agrees_with_the_reference(name):
    out = run_tiny(name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) >= {"setup_s"}


def test_control_fails_the_check():
    from benchmark import control

    for name in (TRAIN, VIEW):
        cell = tiny(name)
        limits = cell["mix"]["check"]
        for reading, nums in control.readings(cell, 5, "cpu",
                                              frames=4).items():
            assert any(nums[k] > limits[k] for k in limits), (name, reading,
                                                              nums)


def _unchanged_step(monkeypatch):
    from gsplat_tpu_torch.train import step as step_lib

    real = step_lib.make_train_step

    def make(*a, **k):
        inner = real(*a, **k)

        def train_step(state, adam, *rest):
            _, _, m = inner(state, adam, *rest)
            return state, adam, m
        return train_step
    monkeypatch.setattr(step_lib, "make_train_step", make)


def _half_batch(monkeypatch):
    from gsplat_tpu_torch.train import losses

    l1, ssim = losses.l1_loss, losses.ssim
    monkeypatch.setattr(losses, "l1_loss",
                        lambda a, b: l1(a[:, : a.shape[1] // 2],
                                        b[:, : b.shape[1] // 2]))
    monkeypatch.setattr(losses, "ssim",
                        lambda a, b: ssim(a[:, : a.shape[1] // 2],
                                          b[:, : b.shape[1] // 2]))


def _altered_frame(monkeypatch):
    import numpy as np

    from gsplat_tpu_torch.viewer import network_gui

    real = network_gui.image_to_bytes

    def altered(img):
        data = np.frombuffer(real(img), np.uint8).copy()
        data[: data.size // 8] = 255 - data[: data.size // 8]
        return data.tobytes()
    monkeypatch.setattr(network_gui, "image_to_bytes", altered)


@pytest.mark.parametrize("name,fault", [
    (TRAIN, _unchanged_step),
    (TRAIN, _half_batch),
    (VIEW, _altered_frame),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """The rest of a run, with the timed path broken underneath (a state
    left unchanged; half of the image left out of the loss; a served
    frame altered where it is produced): ``correct`` comes out false.
    The cells run on one chip, so no exchange between chips exists to
    leave out."""
    fault(monkeypatch)
    out = run_tiny(name)
    assert not out["correct"], out["check"]



class _Event:
    def __init__(self, name, start, dur, annotation=False):
        self._n, self._s, self._d, self._a = name, start, dur, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_trace_summary_busy_gaps_and_names():
    from benchmark import trace

    ev = [_Event("void at::native::vectorized_elementwise_kernel<4>(x)",
                 1000, 100),                       # the marker
          _Event("void blend_forward_kernel<false>(float const*)", 1200, 300),
          _Event("Memcpy DtoH (Device -> Pinned)", 1400, 200),
          _Event("step", 1000, 2000, annotation=True),
          _Event("void blend_backward_kernel<true>(float const*)", 2000,
                 500)]
    # host spans in another clock, 10,000 ns behind the device's
    spans = [("step", -9000, -8300), ("densify", -8300, -7500)]
    s = trace.Summary(ev, spans, marker_ns=-9000, window_s=2e-6)
    assert s.launches == 3
    assert s.hand_n("blend_forward_kernel") == 1
    assert s.hand_s("blend_backward_kernel") == pytest.approx(5e-7)
    assert s.busy_s == pytest.approx((100 + 400 + 500) * 1e-9)
    assert s.gaps == pytest.approx({"step": 100e-9, "densify": 400e-9})
    b = s.breakdown()
    assert b["device_ops"][0][0] == "blend_backward_kernel"


@pytest.mark.parametrize("name", [TRAIN, VIEW])
def test_traced_run_has_an_untraced_then_a_traced_stretch(monkeypatch,
                                                          name):
    """A ``--trace 1`` run at tiny size, the profiler recording the CPU
    (the CPU build has no CUDA activity): the rates read the first,
    untraced stretch, the trace the second, and both count as
    attempted."""
    import time

    import torch

    from benchmark import harness

    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    seen = {}
    run = harness.run_window

    def spy(loop, seconds, device, trace, start=0):
        out = run(loop, seconds, device, trace, start)
        seen[trace] = (start, out[0], loop.timed, loop.span.on)
        return out
    monkeypatch.setattr(harness, "run_window", spy)
    cell = tiny(name)
    out = harness.measure(cell, 3000000023, 5.0, True, "cpu",
                          time.perf_counter())
    assert out["correct"], out["check"]
    (s0, n0, timed0, spans0), (s1, n1, timed1, spans1) = seen[False], \
        seen[True]
    assert (s0, s1) == (0, n0) and n0 >= 1 and n1 >= 1
    assert timed0 and not spans0 and spans1 and not timed1
    assert out["attempted"] == n0 + n1
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["metrics"]) <= {m["name"] for m in cell["per_layer"]}
