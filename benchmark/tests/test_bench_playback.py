"""CPU tests of the SwinGS playback cell (``swin-200k.playback-720p``) at a
tiny size: the loop against the reference, planted faults and the
control failing the check, the stream generator against a plain
simulation of the trainer, and the cell's readers.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, streams  # noqa: E402

CELL = "swin-200k.playback-720p"
SEED = 3000000000177


def tiny():
    """The cell at a size the CPU runs in seconds: cap 1,200, swin 4, 12
    video frames, 256x128; everything else as committed."""
    torch.set_num_threads(2)
    cell = harness.load_cell(CELL)
    cell["cfg"] = dict(copy.deepcopy(cell["cfg"]), cap_max=1200,
                       swin_size=4, frames=12)
    cell["mix"] = dict(cell["mix"], width=256, height=128, samples=2,
                       probe_every_deg=90, probe_every_frames=6)
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


def _altered_frame(monkeypatch):
    from gsplat_tpu_torch.viewer import network_gui

    real = network_gui.image_to_bytes

    def altered(img):
        data = np.frombuffer(real(img), np.uint8).copy()
        data[: data.size // 8] = 255 - data[: data.size // 8]
        return data.tobytes()
    monkeypatch.setattr(network_gui, "image_to_bytes", altered)


def _end_inclusive(monkeypatch):
    """The selection with end taken as inclusive: the rows that end at
    the frame are drawn too."""
    from gsplat_tpu_torch.eval import render_stream
    from gsplat_tpu_torch.utils.stream import stream_load

    real = render_stream.load_stream_state

    def load(path, device):
        data = real(path, device)
        end = np.sort(stream_load(os.path.join(path, "format.json"),
                                  os.path.join(path, "streamable.dat"))[
                                      "end_frame"])
        data["slice_lo"] = np.searchsorted(
            end, np.arange(len(data["slice_lo"])), side="left")
        return data
    monkeypatch.setattr(render_stream, "load_stream_state", load)


@pytest.mark.parametrize("fault", [_altered_frame, _end_inclusive])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """A served frame altered where it is produced, or the live set
    selected one frame too long: ``correct`` comes out false."""
    fault(monkeypatch)
    out = run_tiny()
    assert not out["correct"], out["check"]


def simulated(cfg, end0):
    """(row, generation) of each record in append order, by a plain loop
    over the trainer's windows: ``evolve`` at each window end W from
    L + 1 to ``frames`` appends the rows whose end is below W (by row)
    and rolls them over to [end, end + L); ``mature_rest`` appends the
    rest."""
    life, frames = cfg["swin_size"], cfg["frames"]
    end = end0.copy()
    gen = np.zeros_like(end)
    out = []
    for w in range(life + 1, frames + 1):
        for j in np.nonzero(end < w)[0]:
            out.append((j, gen[j]))
        mask = end < w
        end[mask] += life
        gen[mask] += 1
    out += [(j, gen[j]) for j in range(len(end))]
    return out


@pytest.mark.parametrize("cap,life,frames", [(1200, 4, 12), (96, 8, 300),
                                             (40, 5, 6)])
def test_stream_follows_the_trainer(cap, life, frames):
    cfg = dict(tiny()["cfg"], cap_max=cap, swin_size=life, frames=frames)
    cols = streams.stream_columns(cfg, "cpu", SEED)
    assert cols["xyz"].shape[0] == cap // life * (frames + life - 1)
    start, end = cols["start_frame"].numpy(), cols["end_frame"].numpy()
    # genesis: ends 1..L by opacity rank, descending, cap / L rows each
    gen0 = start == 0
    end0 = np.zeros(cap, np.int64)
    rows = np.nonzero(gen0)[0][:cap]
    end0[:] = end[rows]
    assert np.bincount(end0, minlength=life + 1)[1:].tolist() == \
        [cap // life] * life
    opa = cols["opacity"][rows, 0].numpy()
    assert (np.diff(end0[np.argsort(-opa, kind="stable")]) <= 0).all()
    j, g = streams.emit_order(torch.as_tensor(end0), life, frames)
    assert list(zip(j.tolist(), g.tolist())) == [
        (int(a), int(b)) for a, b in simulated(cfg, end0)]
    assert (end - start <= life).all() and (end > start).all()
    live = [int(((start <= f) & (end > f)).sum()) for f in range(frames)]
    assert live == [cap] * frames


def test_committed_size():
    cfg = harness.load_cell(CELL)["cfg"]
    assert cfg["records"] == cfg["cap_max"] // cfg["swin_size"] * (
        cfg["frames"] + cfg["swin_size"] - 1) == 7_675_000
    assert cfg["record_bytes"] == streams.record_dtype(
        cfg["sh_degree"]).itemsize == 100


def test_written_records_read_back(tmp_path):
    from gsplat_tpu_torch.utils.stream import stream_load

    cols = streams.stream_columns(tiny()["cfg"], "cpu", SEED)
    streams.write_stream(cols, str(tmp_path), 1)
    assert os.path.getsize(tmp_path / "streamable.dat") == \
        cols["xyz"].shape[0] * 100
    back = stream_load(str(tmp_path / "format.json"),
                       str(tmp_path / "streamable.dat"))
    for k in ("start_frame", "end_frame", "xyz", "f_dc", "f_rest",
              "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(back[k], cols[k].numpy().reshape(
            back[k].shape))


MS = 1_000_000


def _planted():
    from gsplat_tpu_torch.utils import profiling

    return [profiling.Span(*t) for t in [
        ("stream.select", 0, 1 * MS, "stream.render", 0),
        ("stream.render", 0, 10 * MS, None, 0),
        ("serve.bytes", 10 * MS, 12 * MS, None, 1),
        ("stream.select", 20 * MS, 23 * MS, "stream.render", 2),
        ("stream.render", 20 * MS, 34 * MS, None, 2)]]


@pytest.mark.parametrize("metric,want", [
    ("dispatch_ms.playback", 12.0), ("select_ms.playback", 2.0),
    ("slice_rows_per_frame.playback", 200_000.0)])
def test_span_readers(monkeypatch, metric, want):
    from gsplat_tpu_torch.utils import profiling

    read = harness.reader(metric).read
    monkeypatch.setattr(profiling, "spans", _planted)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"stream.slice_rows": 400_000,
                                 "stream.live_rows": 400_000})
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({}) is None
    monkeypatch.delattr(profiling, "spans")      # a program without them
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None


class _Trace:
    launches = 1268
    kernels = {"render_kernel": [2, 4e-4], "merge_expand_kernel": [2, 2e-5]}

    def hand_n(self, name):
        return self.kernels.get(name, [0, 0.0])[0]

    def hand_s(self, name):
        return self.kernels.get(name, [0, 0.0])[1]


@pytest.mark.parametrize("base", ["launches_per_frame", "render_roofline",
                                  "frame_mfu", "merge_expand_roofline"])
def test_shared_readers_read_as_the_view_cells(base):
    """The playback cell's trace readers are the view cell's: the same
    number on a planted trace and work, None on an empty one."""
    ctx = {"trace": _Trace(), "trace_units": 2, "units": 100,
           "wall_s": 1.0, "work": {"pairs": 300_000, "slots": 200_000,
                                   "passing": 5e8, "pixels": 1280 * 720,
                                   "gaussians": 200_000,
                                   "param_floats": 23}}
    got = harness.reader(base + ".playback").read(ctx)
    assert got == harness.reader(base + ".view").read(ctx)
    assert got is not None and got > 0
    empty = dict(ctx, trace=None, work={})
    assert harness.reader(base + ".playback").read(empty) is None


def test_traced_run_reads_the_players_spans(monkeypatch):
    """A ``--trace 1`` run at tiny size, the profiler recording the CPU:
    the player's span and counter readers read numbers, the slice rows
    the cap; the others read or leave their metric out."""
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    cell = tiny()
    out = harness.measure(cell, SEED, 2.0, True, "cpu", time.perf_counter())
    assert out["correct"], out["check"]
    got = out["metrics"]
    assert set(got) <= {m["name"] for m in cell["per_layer"]}
    assert {"dispatch_ms.playback", "select_ms.playback",
            "slice_rows_per_frame.playback"} <= set(got)
    assert got["slice_rows_per_frame.playback"]["value"] == 1200
