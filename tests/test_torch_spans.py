"""The program's spans and counters (``gsplat_tpu_torch/utils/profiling``)
and the benchmark readers that read them, on the CPU at tiny sizes.

- Off (no profiler session): a span records nothing, hands back its
  body's value and lets its exceptions through; counters stay empty.
- On (a CPU ``torch.profiler`` session): one 64x32 served frame through
  ``serve.make_render_fn`` and ``network_gui.image_to_bytes`` gives the
  frame's spans, nested under their roots with the roots' ids, and the
  ``serve.d2h_bytes`` counter; the bytes are those of the untraced path.
  A uint8 frame alone: its own bytes, the same spans, 3 B a pixel.
- Threads switching often lose no span and no count.
- One clock: each span lies within 50 us of its ``record_function`` event
  in the profiler's own events.
- The five readers of the served frame's metrics on a planted buffer, on
  an empty one and on a program without the buffers.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from benchmark import harness
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.utils import profiling
from gsplat_tpu_torch.viewer import network_gui, serve
from tests.test_torch_kernels import make_params
from tests.torch_threads import one_torch_thread  # noqa: F401

W, H = 64, 32
RENDER_CHILDREN = ["raster.preprocess", "raster.binning", "raster.gather",
                   "raster.render", "raster.assemble", "raster.assemble"]


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _body(x):
    with profiling.span("body"):
        return 2 * x


def test_off_records_nothing(clean):
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")   # nothing allocated
    assert _body(21) == 42
    with pytest.raises(ValueError, match="through"):
        with profiling.span("a"):
            raise ValueError("through")
    profiling.count("c", 5)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_on_records_nested_spans_and_counts(clean):
    with cpu_profile():
        assert profiling.enabled()
        assert _body(21) == 42
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError
        profiling.count("c", 5)
        profiling.count("c", 2)
    assert not profiling.enabled()
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [
        ("body", None), ("inner", "outer"), ("outer", None)]
    assert got[1].id == got[2].id != got[0].id
    assert got[2].start_ns <= got[1].start_ns <= got[1].end_ns \
        <= got[2].end_ns
    assert profiling.counters() == {"c": 7}
    assert profiling.spans() == got           # reading does not empty
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_threads_lose_no_record(clean):
    """The buffer and counters under threads that switch often: every
    span and every count arrives."""
    n_threads, n = 8, 200

    def work():
        for _ in range(n):
            with profiling.span("t"):
                profiling.count("c", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(profiling.spans()) == n_threads * n
    assert profiling.counters() == {"c": n_threads * n}


def test_served_frame_spans(clean):
    par = make_params(p=200, cap=256, deg=1, seed=6)
    state = tgauss.state_from_numpy(par, 200, 1, "cpu")
    render = serve.make_render_fn(state, 8 * state.capacity, W, H, "cpu")
    cam = tcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H,
                              device="cpu")
    want = network_gui.image_to_bytes(render(cam))
    assert profiling.spans() == []
    with cpu_profile():
        data = network_gui.image_to_bytes(render(cam))
    assert data == want
    got = profiling.spans()
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    frame, out = by_name["serve.render"][0], by_name["serve.bytes"][0]
    assert frame.parent is None and out.parent is None and frame.id != out.id
    under = {f.id: sorted((s for s in got if s.id == f.id and s is not f),
                          key=lambda s: s.start_ns) for f in (frame, out)}
    assert [s.name for s in under[frame.id]] == RENDER_CHILDREN
    assert [s.name for s in under[out.id]] == ["serve.copy", "serve.encode"]
    for root in (frame, out):
        for s in under[root.id]:
            assert s.parent == root.name
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert len(got) == 1 + len(RENDER_CHILDREN) + 3
    assert profiling.counters() == {"serve.d2h_bytes": W * H * 3}


def test_uint8_frame_bytes_and_spans(clean):
    """A uint8 frame (the served frame's type) goes out as its own bytes,
    through the same spans, counting its 3 B a pixel."""
    frame = torch.randint(0, 256, (H, W, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    with cpu_profile():
        data = network_gui.image_to_bytes(frame)
    assert data == frame.numpy().tobytes()
    got = profiling.spans()
    root = [s for s in got if s.name == "serve.bytes"]
    assert len(root) == 1 and root[0].parent is None
    assert [s.name for s in sorted(got, key=lambda s: s.start_ns)
            if s is not root[0]] == ["serve.copy", "serve.encode"]
    assert all(s.parent == "serve.bytes" for s in got if s is not root[0])
    assert profiling.counters() == {"serve.d2h_bytes": H * W * 3}


def _clock_offsets():
    """(start, end) distances in ns between five warm spans and their
    ``record_function`` events."""
    profiling.reset()
    with cpu_profile() as prof:
        with profiling.span("warm"):
            pass
        for i in range(5):
            with profiling.span(f"clock{i}"):
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = [s for s in profiling.spans() if s.name.startswith("clock")]
    assert len(spans) == 5
    return [(abs(events[s.name].start_ns() - s.start_ns),
             abs(events[s.name].start_ns() + events[s.name].duration_ns()
                 - s.end_ns)) for s in spans]


def test_spans_share_the_profilers_clock(clean):
    """Every span within 50 us of its event. A clock apart fails every
    try; a try may also fail when the test process is preempted between
    a span's clock read and its event, so three tries are allowed."""
    tries = [_clock_offsets() for _ in range(3)]
    assert any(max(max(o) for o in t) <= 50_000 for t in tries), tries


MS = 1_000_000
PLANTED = [profiling.Span(*t) for t in [
    ("serve.render", 0, 10 * MS, None, 0),
    ("serve.wait", 10 * MS, 11 * MS, "serve.bytes", 1),
    ("serve.copy", 11 * MS, 13 * MS, "serve.bytes", 1),
    ("serve.encode", 13 * MS, 83 * MS, "serve.bytes", 1),
    ("serve.bytes", 10 * MS, 83 * MS, None, 1),
    ("serve.render", 90 * MS, 102 * MS, None, 2),
    ("serve.wait", 102 * MS, 105 * MS, "serve.bytes", 3),
    ("serve.copy", 105 * MS, 109 * MS, "serve.bytes", 3),
    ("serve.encode", 109 * MS, 189 * MS, "serve.bytes", 3),
    ("serve.bytes", 102 * MS, 189 * MS, None, 3)]]
FRAME_BYTES = 1920 * 1088 * 3 * 4


@pytest.mark.parametrize("metric,want", [
    ("dispatch_ms.view", 11.0), ("device_wait_ms.view", 2.0),
    ("d2h_copy_ms.view", 3.0), ("encode_ms.view", 75.0),
    ("d2h_mb_per_frame.view", 25.06752)])
def test_view_readers(monkeypatch, metric, want):
    read = harness.reader(metric).read
    monkeypatch.setattr(profiling, "spans", lambda: PLANTED)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"serve.d2h_bytes": 2 * FRAME_BYTES})
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({}) is None
    monkeypatch.delattr(profiling, "spans")      # a program without them
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None
