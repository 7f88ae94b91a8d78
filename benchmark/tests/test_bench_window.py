"""CPU tests of the SwinGS window cell (``swin-100k-deform.window-1014p``)
at a tiny size: the loop against the reference, planted faults (the age
one frame too old, the rigid motion skipped, an altered frame) and the
control failing the check, the generator against the trainer's own
maturation run step by step, its checkpoint against the trainer's
layout, and the cell's readers.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, windows  # noqa: E402
from benchmark.reference import window as ref_window  # noqa: E402

CELL = "swin-100k-deform.window-1014p"
SEED = 3000000000211


def tiny():
    """The cell at a size the CPU runs in seconds: cap 1,200, swin 4,
    window [8, 12), 256x128; everything else as committed."""
    torch.set_num_threads(2)
    cell = harness.load_cell(CELL)
    cell["cfg"] = dict(copy.deepcopy(cell["cfg"]), cap_max=1200,
                       buffer_size=1200, swin_size=4, window_start=8,
                       frames=20)
    cell["mix"] = dict(cell["mix"], width=256, height=128, samples=2,
                       probe_every_deg=90, probe_every_frames=2)
    return cell


def run_tiny(seconds=1.0, trace=False):
    return harness.measure(tiny(), SEED, seconds, trace, "cpu",
                           time.perf_counter())


def test_loop_agrees_with_the_reference():
    out = run_tiny()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"view_frames_per_s", "setup_s"}


def test_control_fails_the_check():
    from benchmark import control

    cell = tiny()
    limits = cell["mix"]["check"]
    for reading, nums in control.readings(cell, 5, "cpu", frames=4).items():
        assert any(nums[k] > limits[k] for k in limits), (reading, nums)


def _age_one_frame_older(monkeypatch):
    from gsplat_tpu_torch.model import swin

    real = swin.rigid_deform
    monkeypatch.setattr(swin, "rigid_deform", lambda xyz, rot, v, rv, rc, t,
                        **k: real(xyz, rot, v, rv, rc, t + 1.0, **k))


def _motion_skipped(monkeypatch):
    from gsplat_tpu_torch.model import swin

    monkeypatch.setattr(swin, "rigid_deform",
                        lambda xyz, rot, *a, **k: (xyz, rot))


def _altered_frame(monkeypatch):
    from gsplat_tpu_torch.viewer import network_gui

    real = network_gui.image_to_bytes

    def altered(img):
        data = np.frombuffer(real(img), np.uint8).copy()
        data[: data.size // 8] = 255 - data[: data.size // 8]
        return data.tobytes()
    monkeypatch.setattr(network_gui, "image_to_bytes", altered)


@pytest.mark.parametrize("fault", [_age_one_frame_older, _motion_skipped,
                                   _altered_frame])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The window frame with its rows aged one frame too much, with the
    rigid motion left out, or altered where it is produced: ``correct``
    comes out false."""
    fault(monkeypatch)
    out = run_tiny()
    assert not out["correct"], out["check"]


def trainer_run(cfg, seed):
    """The port's own trainer rules from the generator's genesis draws:
    a SwinState after ``decay_genesis``, then ``mature_and_rollover`` at
    every window end from L + 1 to w + L (``train_swin.evolve``)."""
    from gsplat_tpu_torch.model import optim, swin
    from gsplat_tpu_torch.model.gaussians import GaussianState

    p, rigid, end0 = windows.genesis(cfg, "cpu", seed)
    cap, b, life = cfg["cap_max"], cfg["buffer_size"], cfg["swin_size"]
    im = GaussianState(xyz=p["xyz"], features_dc=p["f_dc"],
                       features_rest=p["f_rest"], scaling=p["scaling"],
                       rotation=p["rotation"], opacity=p["opacity"],
                       n_alive=cap, max_sh_degree=cfg["sh_degree"])

    def zeros(*shape):
        return torch.zeros(shape)

    state = swin.SwinState(im=im, **rigid, frame_birth=zeros(cap),
                           frame_start=zeros(cap), frame_end=end0.float(),
                           **{k: zeros(0) for k in swin.RING_KEYS},
                           m_count=0, max_lifespan=life,
                           deform=cfg["deform"])
    state = dataclasses.replace(state, **{
        k: zeros(b, *v.shape[1:])
        for k, v in swin._immature_leaves(state).items()})
    adam = optim.init(state.params())
    for w_end in range(life + 1, cfg["window_start"] + life + 1):
        state, adam = swin.mature_and_rollover(
            state, adam, swin.mature_mask(state, float(w_end)))
    return state


@pytest.mark.parametrize("cap,buffer,life,w", [(96, 96, 4, 9), (120, 50, 4, 6),
                                               (64, 64, 8, 8), (48, 48, 4, 2)])
def test_window_follows_the_trainer(cap, buffer, life, w):
    """The generator's state equals the port's maturation and rollover run
    window by window (``mature_and_rollover``: the ring's slots, the
    lifespans, the rollover poses up to float rounding of the two screw
    motions); at every frame of the window, integer or not, no identity
    lives twice, and exactly ``cap`` rows live where the ring holds each
    row's previous generation (a ring as large as the pool, w >= L; the
    committed cell's case)."""
    cfg = dict(tiny()["cfg"], cap_max=cap, buffer_size=buffer,
               swin_size=life, window_start=w)
    got = windows.window_state(cfg, "cpu", SEED)
    want = trainer_run(cfg, SEED)
    assert got["m_count"] == want.m_count
    for part, pre in ((got["im"], ""), (got["ring"], "m_")):
        for k in ("frame_birth", "frame_start", "frame_end") + windows.RIGID:
            np.testing.assert_array_equal(part[k].numpy(), getattr(
                want, pre + k).numpy(), err_msg=pre + k)
    for part, name in ((got["im"], None), (got["ring"], "m_")):
        for k, leaf in windows.IM_LEAVES.items():
            w_leaf = (getattr(want.im, leaf[3:]) if name is None
                      else getattr(want, "m_" + leaf[3:]))
            np.testing.assert_allclose(part[k].numpy(), w_leaf.numpy(),
                                       rtol=0, atol=2e-5, err_msg=k)
    union = windows.union(got)
    assert union["valid"].all()
    for f in np.arange(w, w + life, 0.25):
        live = ref_window.live_mask(union, float(f))
        ids = union["identity"][live]
        assert ids.unique().numel() == ids.numel(), f
        # the ring holds every row's generation before its immature one
        # once it is as large as the pool and the window follows L of them
        if buffer >= cap and w >= life:
            assert ids.numel() == cap, f
        else:
            assert ids.numel() <= cap, f


def test_checkpoint_has_the_trainers_layout(tmp_path):
    """The benchmark's writer gives the file ``ckpt_lib.save_pytree``
    writes for the same state: the same keys, leaves and meta."""
    from gsplat_tpu_torch.model import optim, swin
    from gsplat_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = tiny()["cfg"]
    st = windows.window_state(cfg, "cpu", SEED)
    path = str(tmp_path / "chkpnt_8_1000.npz")
    windows.write_checkpoint(st, path, cfg, 1000)
    state, window = swin.load_window(path, "cpu")
    assert window == {"frame_start": 8, "frame_end": 12, "max_frame": 20,
                      "_sampled_frames": None}
    assert state.deform
    adam = optim.init(state.params())
    adam = optim.AdamState(mu=adam.mu, nu=adam.nu, count=1000)
    again = str(tmp_path / "again.npz")
    ckpt_lib.save_pytree(again, {"state": state, "adam": adam},
                         meta={"iteration": 1000, "deform": state.deform,
                               "swin": window})
    with np.load(path) as a, np.load(again) as b:
        assert list(a.files) == list(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


MS = 1_000_000


def _planted():
    from gsplat_tpu_torch.utils import profiling

    return [profiling.Span(*t) for t in [
        ("swin.stage", 0, 1 * MS, "swin.render", 0),
        ("swin.render", 0, 3 * MS, None, 0),
        ("serve.bytes", 3 * MS, 5 * MS, None, 1),
        ("swin.stage", 20 * MS, 21 * MS, "swin.render", 2),
        ("swin.render", 20 * MS, 25 * MS, None, 2)]]


@pytest.mark.parametrize("metric,want", [
    ("dispatch_ms.window", 4.0), ("union_rows_per_frame.window", 200_000.0),
    ("active_rows_per_frame.window", 100_000.0)])
def test_span_readers(monkeypatch, metric, want):
    from gsplat_tpu_torch.utils import profiling

    read = harness.reader(metric).read
    monkeypatch.setattr(profiling, "spans", _planted)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"swin.union_rows": 400_000,
                                 "swin.active_rows": 200_000})
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({}) is None
    monkeypatch.delattr(profiling, "spans")      # a program without them
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None


def test_frame_mfu_adds_the_motion_to_the_frame():
    """``frame_mfu.window``: the served frame's bytes and operations plus
    the screw motion's, at the larger bound, over the untraced time a
    frame; None without a trace or work."""
    from benchmark.counts import peaks, render, rigid_deform, view_frame

    work = {"pairs": 600_000, "slots": 400_000, "passing": 2e8,
            "pixels": 1352 * 1014, "gaussians": 400_000, "param_floats": 23}
    ctx = {"trace": object(), "units": 100, "wall_s": 1.0, "work": work}
    got = harness.reader("frame_mfu.window").read(ctx)
    nbytes = (work["gaussians"] * (23 * 4 + 18) + work["slots"] * 18
              + work["pixels"] * 6 + work["pixels"] * 3
              + work["gaussians"] * 40)
    ops = work["passing"] * 25 + work["gaussians"] * 118
    assert view_frame.nbytes(work) + rigid_deform.nbytes(work) == nbytes
    assert render.ops(work) + rigid_deform.ops(work) == ops
    assert got == pytest.approx(100 * peaks.least_s(nbytes, ops) / 0.01)
    assert got > harness.reader("frame_mfu.view").read(ctx)
    assert harness.reader("frame_mfu.window").read(
        dict(ctx, trace=None)) is None
    assert harness.reader("frame_mfu.window").read(dict(ctx, work={})) is None


def test_traced_run_reads_the_windows_spans(monkeypatch):
    """A ``--trace 1`` run at tiny size, the profiler recording the CPU:
    the window's span and counter readers read numbers (the union's rows,
    the cap's live rows); the others read or leave their metric out."""
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    cell = tiny()
    out = harness.measure(cell, SEED, 2.0, True, "cpu", time.perf_counter())
    assert out["correct"], out["check"]
    got = out["metrics"]
    assert set(got) <= {m["name"] for m in cell["per_layer"]}
    assert {"dispatch_ms.window", "union_rows_per_frame.window",
            "active_rows_per_frame.window", "d2h_copy_ms.window",
            "encode_ms.window", "d2h_mb_per_frame.window",
            "host_frame_ms.window"} <= set(got)
    assert got["d2h_mb_per_frame.window"]["value"] == 256 * 128 * 3 / 1e6
    assert got["union_rows_per_frame.window"]["value"] == 2400
    assert got["active_rows_per_frame.window"]["value"] == 1200
