"""CPU tests of the SIBR socket cell (``mcmc-1m.view-1080p-sibr``) at a
tiny size: the loop (the program's server in a thread, this loop the
viewer over loopback) against the view cell's reference, a planted fault
and the control failing the check, the request decoding to the view
loop's camera bit for bit, the server stopped at release, and the cell's
readers of the spans and counter the server records in its thread.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import copy
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, inputs  # noqa: E402

CELL = "mcmc-1m.view-1080p-sibr"
SEED = 3000000000233


def tiny():
    """The cell at a size the CPU runs in seconds: 3,000 Gaussians,
    256x128; everything else as committed."""
    torch.set_num_threads(2)
    cell = harness.load_cell(CELL)
    cfg = copy.deepcopy(cell["cfg"])
    cfg["gaussians"] = cfg["cap_max"] = 3000
    cell["cfg"] = cfg
    cell["mix"] = dict(cell["mix"], width=256, height=128, samples=2,
                       probe_every_deg=90)
    return cell


def run_tiny(seconds=1.0, trace=False):
    return harness.measure(tiny(), SEED, seconds, trace, "cpu",
                           time.perf_counter())


def server_threads():
    return [t for t in threading.enumerate()
            if getattr(t, "_target", None) is not None
            and getattr(t._target, "__name__", "") == "serve"]


def test_loop_agrees_with_the_reference():
    out = run_tiny()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"view_frames_per_s", "setup_s"}
    assert not server_threads()             # stopped at release


def test_control_fails_the_check():
    from benchmark import control

    cell = tiny()
    limits = cell["mix"]["check"]
    for reading, nums in control.readings(cell, 5, "cpu", frames=4).items():
        assert any(nums[k] > limits[k] for k in limits), (reading, nums)


def test_an_altered_frame_is_not_correct(monkeypatch):
    """The server's frame altered where it is produced: ``correct`` comes
    out false."""
    from gsplat_tpu_torch.viewer import network_gui

    real = network_gui.image_to_bytes

    def altered(img):
        data = np.frombuffer(real(img), np.uint8).copy()
        data[: data.size // 8] = 255 - data[: data.size // 8]
        return data.tobytes()
    monkeypatch.setattr(network_gui, "image_to_bytes", altered)
    out = run_tiny()
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("angle", [0.0, 1.234, 4.5])
def test_request_decodes_to_the_view_loops_camera(angle):
    """The request body the loop sends decodes (``network_gui``) to the
    camera the view loop builds from the same orbit matrices, every
    tensor bit for bit."""
    import json

    from benchmark.loops import sibr
    from gsplat_tpu_torch.core.camera import camera_from_matrices
    from gsplat_tpu_torch.viewer import network_gui

    m = inputs.orbit_matrices(angle, 1920, 1088, 6.0, [0, 0, 0], 0.9)
    body = sibr.request_body(m, 0.9)
    assert int.from_bytes(body[:4], "little") == len(body) - 4
    got, flags = network_gui.request_to_camera(json.loads(body[4:]), "cpu")
    want = camera_from_matrices(m["view"], m["full_proj"], m["cam_pos"],
                                m["tan_fovx"], m["tan_fovy"], m["width"],
                                m["height"], device="cpu")
    for f in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy"):
        assert torch.equal(torch.as_tensor(getattr(got, f)),
                           torch.as_tensor(getattr(want, f))), f
    assert (got.width, got.height) == (1920, 1088)
    assert flags["keep_alive"] and flags["scaling_modifier"] == 1.0


MS = 1_000_000


def _planted():
    from gsplat_tpu_torch.utils import profiling

    return [profiling.Span(*t) for t in [
        ("serve.render", 1 * MS, 3 * MS, "serve.request", 0),
        ("serve.wait", 3 * MS, 3 * MS + MS // 2, "serve.request", 0),
        ("serve.copy", 3 * MS + MS // 2, 4 * MS - MS // 4, "serve.request",
         0),
        ("serve.encode", 4 * MS - MS // 4, 4 * MS, "serve.request", 0),
        ("serve.bytes", 3 * MS, 4 * MS, "serve.request", 0),
        ("serve.send", 4 * MS, 5 * MS, "serve.request", 0),
        ("serve.request", 0, 6 * MS, None, 0),
        ("serve.send", 12 * MS, 15 * MS, "serve.request", 1),
        ("serve.request", 10 * MS, 20 * MS, None, 1),
        # cut off at the end: its reply never went
        ("serve.request", 20 * MS, 90 * MS, None, 2)]]


@pytest.mark.parametrize("metric,want", [
    ("request_ms.sibr", 8.0), ("send_ms.sibr", 2.0),
    ("dispatch_ms.sibr", 2.0), ("device_wait_ms.sibr", 0.5),
    ("d2h_copy_ms.sibr", 0.25), ("encode_ms.sibr", 0.25),
    ("d2h_mb_per_frame.sibr", 6.266880)])
def test_span_readers(monkeypatch, metric, want):
    """The server's spans, and the ``serve.bytes`` children and counter
    that ``image_to_bytes`` records in its thread, read per request; None
    where the buffers are empty or the program has none."""
    from gsplat_tpu_torch.utils import profiling

    read = harness.reader(metric).read
    monkeypatch.setattr(profiling, "spans", _planted)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"serve.d2h_bytes": 1920 * 1088 * 3})
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({}) is None
    monkeypatch.delattr(profiling, "spans")      # a program without them
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None


def test_traced_run_reads_the_servers_spans(monkeypatch):
    """A ``--trace 1`` run at tiny size, the profiler recording the CPU:
    the spans the server records in its own thread are read."""
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    cell = tiny()
    out = harness.measure(cell, SEED, 2.0, True, "cpu", time.perf_counter())
    assert out["correct"], out["check"]
    got = out["metrics"]
    assert set(got) <= {m["name"] for m in cell["per_layer"]}
    assert {"request_ms.sibr", "send_ms.sibr", "dispatch_ms.sibr",
            "d2h_copy_ms.sibr", "encode_ms.sibr",
            "d2h_mb_per_frame.sibr"} <= set(got)
    assert got["request_ms.sibr"]["value"] > got["send_ms.sibr"]["value"] > 0
    assert got["dispatch_ms.sibr"]["value"] > 0
    assert got["d2h_mb_per_frame.sibr"]["value"] == 256 * 128 * 3 / 1e6
