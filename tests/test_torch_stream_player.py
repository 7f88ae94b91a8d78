"""The stream player (``eval/render_stream``) on the CPU at a small size:
a SwinGS stream made from a seed by the benchmark's generator, written
by its own writer of the record format, loaded by ``load_stream_state``.

- Each played uint8 frame against ``benchmark/reference/playback.py``
  (the live rows selected over the whole stream, rendered as a served
  frame), frame by frame, by the benchmark cell's own comparison.
- The slice of a frame holds exactly its live rows, as a set, for the
  stream in the order the trainer appends it (genesis lifespans shorter
  than L among them) and shuffled.
- An end taken as inclusive (one frame too many) fails the comparison.
- The CLI's default budget follows the largest slice, not the stream.
- One played frame's spans and counters under a CPU profiler session.
- The player's slice staged into rows as wide as the widest slice, the
  rest dead, plays the bytes of the unpadded slice, frame by frame; on
  the card (``gpu``), the replayed graph plays the eager frames' bytes.
  Run the ``gpu`` test there with ``python -m pytest --noconftest -m gpu
  tests/test_torch_stream_player.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import inputs, streams
from benchmark.loops import view as view_loop
from benchmark.reference import playback as ref_playback, raster
from gsplat_tpu_torch.core.camera import camera_from_matrices
from gsplat_tpu_torch.eval import render_stream
from gsplat_tpu_torch.utils import profiling
from gsplat_tpu_torch.viewer import network_gui
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"cap_max": 2000, "swin_size": 4, "sh_degree": 1, "frames": 12,
       "drift": 0.01}
W, H = 128, 64
TILE = (128, 32)


def limits():
    """The cell's own limits (benchmark/traffic/playback-720p.json), set
    from the card's sound runs (lower end) and the bfloat16 control
    (upper end)."""
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "playback-720p.json")) as f:
        return json.load(f)["check"]


def config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "swin-200k.json")) as f:
        return dict(json.load(f), **CFG)


@pytest.fixture(scope="module")
def played(tmp_path_factory):
    """(the benchmark's columns, the player's loaded stream)."""
    cols = streams.stream_columns(config(), "cpu", 3000000000171)
    d = str(tmp_path_factory.mktemp("stream"))
    streams.write_stream(cols, d, 1)
    return cols, render_stream.load_stream_state(d, "cpu")


@pytest.fixture(scope="module")
def want(played):
    """The reference's bytes at every frame of the stream."""
    return reference(played[0], range(CFG["frames"]))


def matrices(i):
    return inputs.orbit_matrices(0.3 + 0.4 * i, W, H, 6.0, [0, 0, 0], 0.9)


def camera(i, device="cpu"):
    m = matrices(i)
    return camera_from_matrices(m["view"], m["full_proj"], m["cam_pos"],
                                m["tan_fovx"], m["tan_fovy"], W, H,
                                device=device)


def play(data, frames):
    render = render_stream.make_stream_render_fn(data, 1 << 15, W, H, "cpu")
    return {f: np.frombuffer(network_gui.image_to_bytes(
        render(camera(f), float(f))), np.uint8) for f in frames}


def reference(cols, frames):
    with raster.no_tf32():
        return {f: ref_playback.frame_bytes(
            cols, f, inputs.ref_camera(matrices(f), "cpu"), 1, TILE
        ).reshape(-1).numpy() for f in frames}


def test_records_follow_the_trainers_cadence(played):
    cols, data = played
    assert cols["xyz"].shape[0] == 2000 // 4 * (12 + 4 - 1)
    lives = data["live_rows"][:CFG["frames"]]
    assert (lives == CFG["cap_max"]).all()


def test_played_frames_equal_the_reference(played, want):
    frames = range(CFG["frames"])
    assert min(float(w.astype(np.float64).mean()) for w in want.values()) > 2
    for f, got in play(played[1], frames).items():
        nums = view_loop.compare({f: got}, {f: want[f]})
        assert all(nums[k] <= lim for k, lim in limits().items()), (f, nums)


def _ids(data, lo, hi, frame):
    alive = (data["start_frame"][lo:hi] <= frame).numpy()
    return set(data["xyz"][lo:hi, 0].numpy()[alive].astype(np.int64))


@pytest.mark.parametrize("shuffle", [False, True])
def test_slice_holds_exactly_the_live_rows(tmp_path, shuffle):
    """Every record carries its index in x; the slice's rows alive by
    start <= f are the rows with start <= f < end over the whole stream.
    The genesis rows live 1..L frames from frame 0."""
    cols = streams.stream_columns(config(), "cpu", 3000000000172)
    n = cols["xyz"].shape[0]
    cols["xyz"][:, 0] = torch.arange(n, dtype=torch.float32)
    if shuffle:
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))
        cols = {k: v[perm] for k, v in cols.items()}
    life = cols["end_frame"] - cols["start_frame"]
    genesis = cols["start_frame"] == 0
    assert set(life[genesis].tolist()) == {1, 2, 3, 4}
    streams.write_stream(cols, str(tmp_path), 1)
    data = render_stream.load_stream_state(str(tmp_path), "cpu")
    start, end = cols["start_frame"], cols["end_frame"]
    x = cols["xyz"][:, 0].long()
    for f in range(int(end.max()) + 2):
        lo, hi, live = render_stream.frame_rows(data, f)
        want = set(x[(start <= f) & (end > f)].tolist())
        assert _ids(data, lo, hi, f) == want and live == len(want), f
        assert hi - lo <= CFG["cap_max"]


def test_end_taken_as_inclusive_fails_the_comparison(played, want):
    cols, data = played
    frames = range(1, CFG["frames"], 3)
    end = np.sort(cols["end_frame"].numpy())
    wrong = dict(data, slice_lo=np.searchsorted(
        end, np.arange(len(data["slice_lo"])), side="left"))
    nums = view_loop.compare(play(wrong, frames),
                             {f: want[f] for f in frames})
    assert any(nums[k] > lim for k, lim in limits().items()), nums


def test_cli_default_budget_follows_the_largest_slice(tmp_path,
                                                      monkeypatch):
    from tests.test_data import _make_swings_fixture

    cfg = dict(config(), cap_max=10000)
    out = tmp_path / "model"
    out.mkdir()
    streams.write_stream(streams.stream_columns(cfg, "cpu", 11), str(out), 1)
    _make_swings_fixture(tmp_path, n_cams=3, n_frames=2)
    data = render_stream.load_stream_state(str(out), "cpu")
    assert render_stream.dup_budget(data) == 8 * 10000   # not 8 x 37,500
    seen = []

    def fake(data, camera, frame, bg, k_dup):
        seen.append(k_dup)
        return torch.zeros(camera.height, camera.width, 3, dtype=torch.uint8)
    monkeypatch.setattr(render_stream, "render_stream_frame", fake)
    render_stream.main(["-m", str(out), "-s", str(tmp_path), "--max_frame",
                        "2", "--skip_train", "--data_device", "cpu"])
    assert seen and set(seen) == {80000}
    seen.clear()
    render_stream.main(["-m", str(out), "-s", str(tmp_path), "--max_frame",
                        "2", "--skip_train", "--data_device", "cpu",
                        "--dup_budget", "1000"])
    assert set(seen) == {1024}


def test_played_frame_spans_and_counters(played):
    _, data = played
    render = render_stream.make_stream_render_fn(data, 1 << 15, W, H, "cpu")
    lo, hi, live = render_stream.frame_rows(data, 5.0)
    want = render(camera(5), 5.0)
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = render(camera(5), 5.0)
        spans, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.reset()
    assert torch.equal(got, want)
    root = [s for s in spans if s.name == "stream.render"]
    assert len(root) == 1 and root[0].parent is None
    under = sorted((s for s in spans if s is not root[0]),
                   key=lambda s: s.start_ns)
    assert [s.name for s in under] == [
        "stream.select", "stream.stage", "raster.preprocess", "raster.binning",
        "raster.gather", "raster.render", "raster.assemble",
        "raster.encode"]
    assert all(s.id == root[0].id and s.parent == "stream.render"
               for s in under)
    assert counters == {"stream.slice_rows": hi - lo,
                        "stream.live_rows": live}
    assert hi - lo == live == CFG["cap_max"]


def test_padded_slice_plays_the_unpadded_bytes(played):
    """The player stages each frame's slice into the first rows of buffers
    as wide as the widest slice, the rest dead (start = inf); frame by
    frame its bytes equal ``render_stream_frame``'s of the slice alone.
    Past the video's 12 frames rows end and none start, so frames 12-14
    have narrower slices (1,500, 1,000, 500 rows) and a wider frame's rows
    stay behind in the buffers; frame 0 is played again after them."""
    _, data = played
    widths = data["slice_hi"] - data["slice_lo"]
    wide = render_stream.widest_slice(data)
    assert widths.min() < wide and widths.max() == wide
    render = render_stream.make_stream_render_fn(data, 1 << 15, W, H, "cpu")
    bg = torch.zeros(3)
    for f in [*range(len(widths)), 0]:
        want = render_stream.render_stream_frame(data, camera(f), float(f),
                                                 bg, 1 << 15)
        assert torch.equal(render(camera(f), float(f)), want), f


@pytest.mark.gpu
def test_graphed_played_frames_equal_eager(played):
    """The player on the card over the stream's 15 frames (the video's 12
    and three narrower ones after it), its slice moving each frame: each
    replayed frame byte-equal to eager ``render_stream_frame`` of the
    slice alone, and unchanged by the later calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    data = {k: v.cuda() if torch.is_tensor(v) else v
            for k, v in played[1].items()}
    bg = torch.zeros(3, device="cuda")
    frames = range(len(data["slice_lo"]))
    cams = [camera(f, "cuda") for f in frames]
    want = [render_stream.render_stream_frame(data, cams[f], float(f), bg,
                                              1 << 15) for f in frames]
    render = render_stream.make_stream_render_fn(data, 1 << 15, W, H,
                                                 "cuda")
    got = [render(cams[f], float(f)) for f in frames]
    torch.cuda.synchronize()
    assert len(set(data["slice_lo"].tolist())) == len(frames)
    for f in frames:
        assert torch.equal(got[f], want[f]), f
