"""A deforming SwinGS window served to a viewer (``viewer/serve``'s
``make_window_render_fn`` over ``model/swin.WindowUnion``), on the CPU at
a small size: a cap-2,000, SH 3, ``--deform`` state at window [8, 12)
made from a seed by the benchmark's generator (``benchmark/windows.py``),
written as the trainer's checkpoint by its own writer and loaded by
``swin.load_window``.

- Each window frame, at integer and fractional video times, against
  ``benchmark/reference/window.py`` (the whole union, its own screw
  motion and live mask) by the window cell's own comparison and limits.
- The same frames byte for byte equal to eager ``render_frame`` of
  ``union_params_at`` (the training-side union, held to JAX elsewhere),
  and ``WindowUnion.live_rows`` equal to the mask's count.
- The rows aged one frame too much, or left unmoved, fail the
  comparison.
- A state saved as ``train_swin`` saves it (``ckpt_lib.save_pytree``)
  loads through ``load_window`` and renders the same bytes; the file's
  ``deform`` sets the state's; a file without it, or without an SH
  degree, is refused; the server's CLI refuses a static model's options
  with ``--swin_checkpoint``.
- ``serve()`` answers a SIBR request over loopback for a ``SwinState``,
  at the video time of its wall clock.
- One frame's spans and counters under a CPU profiler session.
- On the card (``gpu``), the replayed graph gives the eager frames'
  bytes: ``python -m pytest --noconftest -m gpu
  tests/test_torch_swin_window.py``.
"""

import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from benchmark import inputs, windows
from benchmark.loops import view as view_loop
from benchmark.reference import raster, window as ref_window
from gsplat_tpu_torch.core.camera import camera_from_matrices
from gsplat_tpu_torch.model import optim, swin
from gsplat_tpu_torch.raster.rasterize import render_frame
from gsplat_tpu_torch.utils import checkpoint as ckpt_lib
from gsplat_tpu_torch.utils import profiling
from gsplat_tpu_torch.viewer import network_gui, serve
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3000000000191
W, H = 128, 64
TILE = (128, 32)
K_DUP = 1 << 14
FRAMES = (8.0, 9.25, 10.5, 11.0, 11.75)


def config():
    """The committed configuration, cut to a CPU size: cap 2,000 (the
    ring as large), swin 4, window [8, 12) of a 20-frame video."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "swin-100k-deform.json")) as f:
        cfg = json.load(f)
    return dict(cfg, cap_max=2000, buffer_size=2000, swin_size=4,
                window_start=8, frames=20)


def limits():
    """The window cell's own limits (benchmark/traffic/window-1014p.json),
    set from the card's sound runs (lower end) and the bfloat16 control
    (upper end)."""
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "window-1014p.json")) as f:
        return json.load(f)["check"]


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """(the generator's union columns, the checkpoint's path, the loaded
    state)."""
    cfg = config()
    st = windows.window_state(cfg, "cpu", SEED)
    path = str(tmp_path_factory.mktemp("window") / "chkpnt_8_1000.npz")
    windows.write_checkpoint(st, path, cfg, 1000)
    state, window = swin.load_window(path, "cpu")
    assert window["frame_start"] == 8 and state.max_lifespan == 4
    assert state.im.max_sh_degree == 3 and state.deform
    return windows.union(st), path, state


def matrices(f):
    return inputs.orbit_matrices(0.3 + 0.7 * f, W, H, 6.0, [0, 0, 0], 0.9)


def camera(f, device="cpu"):
    m = matrices(f)
    return camera_from_matrices(m["view"], m["full_proj"], m["cam_pos"],
                                m["tan_fovx"], m["tan_fovy"], W, H,
                                device=device)


def served(state, frames=FRAMES):
    render = serve.make_window_render_fn(state, K_DUP, W, H, "cpu")
    return {f: render(camera(f), f) for f in frames}


def eager(state, f, device="cpu"):
    kw = swin.union_params_at(state, f)
    alive = kw.pop("alive")
    return render_frame(*kw.values(), camera(f, device), 1,
                        torch.zeros(3, device=device), K_DUP, alive=alive)[0]


@pytest.fixture(scope="module")
def want(made):
    """The reference's bytes at each of ``FRAMES``."""
    union = made[0]
    with raster.no_tf32():
        return {f: ref_window.frame_bytes(
            union, f, inputs.ref_camera(matrices(f), "cpu"), 3, TILE,
            True).reshape(-1).numpy() for f in FRAMES}


def flat(frames):
    return {f: img.reshape(-1).numpy() for f, img in frames.items()}


def test_window_frames_equal_the_reference(made, want):
    assert min(float(w.astype(np.float64).mean()) for w in want.values()) > 2
    for f, got in flat(served(made[2])).items():
        nums = view_loop.compare({f: got}, {f: want[f]})
        assert all(nums[k] <= lim for k, lim in limits().items()), (f, nums)


def test_window_frames_equal_eager_union_params_at(made):
    """The window's frame is ``union_params_at``'s, byte for byte, and
    ``live_rows`` counts its live mask; frames differ as the rows move."""
    state = made[2]
    union = swin.WindowUnion(state)
    got = served(state)
    for f in FRAMES:
        assert torch.equal(got[f], eager(state, f)), f
        assert union.live_rows(f) == int(
            swin.union_params_at(state, f)["alive"].sum()) == 2000, f
    assert union.n_rows == 4000
    assert not torch.equal(got[9.25], served(state, [9.25, 9.5])[9.5])


def _older(monkeypatch):
    real = swin.rigid_deform
    monkeypatch.setattr(swin, "rigid_deform", lambda xyz, rot, v, rv, rc, t,
                        **k: real(xyz, rot, v, rv, rc, t + 1.0, **k))


def _unmoved(monkeypatch):
    monkeypatch.setattr(swin, "rigid_deform",
                        lambda xyz, rot, *a, **k: (xyz, rot))


@pytest.mark.parametrize("fault", [_older, _unmoved])
def test_a_wrong_motion_fails_the_comparison(made, want, monkeypatch,
                                             fault):
    fault(monkeypatch)
    got = flat(served(made[2], FRAMES[1:3]))
    nums = view_loop.compare(got, {f: want[f] for f in got})
    assert any(nums[k] > lim for k, lim in limits().items()), nums


def test_trainer_saved_checkpoint_loads_and_renders_alike(made, tmp_path):
    """The loaded state saved by ``ckpt_lib.save_pytree`` with its Adam
    moments, as ``train_swin`` saves {"state", "adam"}, loads back with
    every leaf and renders the same bytes."""
    state = made[2]
    path = str(tmp_path / "chkpnt_8_2000.npz")
    ckpt_lib.save_pytree(path, {"state": state,
                                "adam": optim.init(state.params())},
                         meta={"iteration": 2000, "deform": state.deform,
                               "swin": {"frame_start": 8, "frame_end": 12,
                                        "max_frame": 20,
                                        "_sampled_frames": [8, 9]}})
    back, window = swin.load_window(path, "cpu")
    assert window["_sampled_frames"] == [8, 9]
    assert back.m_count == state.m_count and back.im.n_alive == 2000
    for (k, a), (_, b) in zip(ckpt_lib.flatten_with_keys(state),
                              ckpt_lib.flatten_with_keys(back)):
        if torch.is_tensor(a):
            assert torch.equal(a, b), k
        else:
            assert a == b, k
    for f, img in served(back, FRAMES[:2]).items():
        assert torch.equal(img, served(state, [f])[f]), f


def rewritten(made, path, leaves=None, meta=None):
    """The cell's checkpoint written again to ``path`` with ``leaves``
    and ``meta`` (a function of the file's) in place of its own."""
    with np.load(made[1]) as z:
        arrays = {k: z[k] for k in z.files}
    arrays.update(leaves or {})
    if meta is not None:
        arrays["__meta__"] = json.dumps(meta(json.loads(
            str(arrays["__meta__"]))))
    np.savez(path, **arrays)
    return path


def test_loader_refuses_a_file_without_an_sh_degree(made, tmp_path):
    path = rewritten(made, str(tmp_path / "bad.npz"), leaves={
        "['state'].im.features_rest": np.zeros((2000, 2, 3), np.float32)})
    with pytest.raises(ValueError, match="SH degree"):
        swin.load_window(path, "cpu")


def test_loader_refuses_a_file_that_does_not_record_deform(made, tmp_path):
    path = rewritten(made, str(tmp_path / "old.npz"), meta=lambda m: {
        k: v for k, v in m.items() if k != "deform"})
    with pytest.raises(ValueError, match="--deform"):
        swin.load_window(path, "cpu")


def test_a_checkpoint_trained_without_deform_renders_unmoved(made, tmp_path):
    """The file's ``deform`` false: the loaded state does not deform, its
    frame is ``union_params_at``'s without the motion, and differs from
    the deforming state's."""
    path = rewritten(made, str(tmp_path / "still.npz"),
                     meta=lambda m: dict(m, deform=False))
    still, _ = swin.load_window(path, "cpu")
    assert not still.deform
    got = served(still, [9.25])[9.25]
    assert torch.equal(got, eager(still, 9.25))
    assert not torch.equal(got, served(made[2], [9.25])[9.25])


@pytest.mark.parametrize("extra", [["--cap_max", "5"], ["--sh_degree", "1"],
                                   ["--iteration", "7"]])
def test_cli_refuses_a_static_models_options_with_a_window(extra, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--swin_checkpoint", "chkpnt_8_1000.npz", *extra])
    assert e.value.code == 2
    assert extra[0] in capsys.readouterr().err


def test_window_clock_wraps_over_the_window():
    assert serve.window_frame(0.0, 96, 8) == 96.0
    assert serve.window_frame(0.25, 96, 8) == 103.5
    assert serve.window_frame(1.0, 96, 8) == 102.0   # 30 frames: 3 laps
    assert all(96 <= serve.window_frame(t / 7, 96, 8) < 104
               for t in range(100))


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed the connection"
        buf += chunk
    return buf


def test_serve_answers_a_sibr_request_for_a_window(made, monkeypatch):
    """A keep-alive request over loopback, answered by the server loop
    for a ``SwinState``: the reply is the window's render at the video
    time the server's clock gave, inside the window."""
    from benchmark.loops import sibr

    state = made[2]
    times = []
    real = serve.make_window_render_fn

    def spy(*a, **k):
        render = real(*a, **k)

        def timed(camera, frame, scaling_modifier=1.0):
            times.append(frame)
            return render(camera, frame, scaling_modifier)
        return timed
    monkeypatch.setattr(serve, "make_window_render_fn", spy)
    gui = network_gui.NetworkGUI("127.0.0.1", 0)
    stop = threading.Event()
    server = threading.Thread(target=serve.serve, daemon=True, args=(
        gui, state, K_DUP, "window"), kwargs=dict(device="cpu", stop=stop,
                                                  window_start=8))
    server.start()
    m = matrices(1.0)
    try:
        with socket.create_connection(("127.0.0.1", gui.port),
                                      timeout=120) as sock:
            sock.sendall(sibr.request_body(m, 0.9))
            img = recv_exact(sock, W * H * 3)
            n = int.from_bytes(recv_exact(sock, 4), "little")
            verify = recv_exact(sock, n).decode("ascii")
    finally:
        stop.set()
        server.join(timeout=60)
        gui.close()
    assert not server.is_alive()
    assert verify == "window" and len(times) == 1 and 8 <= times[0] < 12
    want = real(state, K_DUP, W, H, "cpu")(camera(1.0), times[0])
    assert img == network_gui.image_to_bytes(want)


def test_window_frame_spans_and_counters(made):
    state = made[2]
    render = serve.make_window_render_fn(state, K_DUP, W, H, "cpu")
    want = render(camera(9.25), 9.25)
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = render(camera(9.25), 9.25)
        spans, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.reset()
    assert torch.equal(got, want)
    root = [s for s in spans if s.name == "swin.render"]
    assert len(root) == 1 and root[0].parent is None
    under = sorted((s for s in spans if s is not root[0]),
                   key=lambda s: s.start_ns)
    assert [s.name for s in under] == [
        "swin.stage", "raster.preprocess", "raster.binning", "raster.gather",
        "raster.render", "raster.assemble", "raster.encode"]
    assert all(s.id == root[0].id and s.parent == "swin.render"
               for s in under)
    assert counters == {"swin.union_rows": 4000, "swin.active_rows": 2000}


@pytest.mark.gpu
def test_graphed_window_frames_equal_eager(made):
    """The window on the card: each replayed frame, the video time moving
    each frame, byte-equal to eager ``render_frame`` of
    ``union_params_at``, and unchanged by the later calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    state, _ = swin.load_window(made[1], "cuda")
    want = [eager(state, f, "cuda") for f in FRAMES]
    render = serve.make_window_render_fn(state, K_DUP, W, H, "cuda")
    got = [render(camera(f, "cuda"), f) for f in FRAMES]
    torch.cuda.synchronize()
    for f, g, w in zip(FRAMES, got, want):
        assert torch.equal(g, w), f
