"""Live-viewer server: load a trained model, answer SIBR requests
(port of gsplat_tpu/viewer/serve.py; same CLI and settings).

Usage:
  python -m gsplat_tpu_torch.viewer.serve -m <model_path> [--iteration N]
         [--ip 127.0.0.1] [--port 6009] [--cap_max N] [--sh_degree D]
         [--dup_budget K]
  python -m gsplat_tpu_torch.viewer.serve --swin_checkpoint
         <model_path>/chkpnt_<frame_start>_<it>.npz
         [--ip 127.0.0.1] [--port 6009] [--dup_budget K]

Renders on the GPU through ``raster.rasterize.render_frame`` (bf16 feature
stream, 128x32 tiles, background composited in the kernel, the reply's
RGB bytes made on the device), replayed as one CUDA graph a frame
(``FrameGraph``), duplicate budget ``--dup_budget`` or 8 x cap_max; the
bytes reach the host through a page-locked buffer. ``serve`` and
``make_render_fn`` take a ``device``; on the CPU they run the kernels'
plain PyTorch versions.

``--swin_checkpoint`` serves a SwinGS model at one window, from the
sliding-window trainer's checkpoint (which records whether it was
trained with ``--deform``, rigid motion; ``--iteration``, ``--cap_max``
and ``--sh_degree`` belong to a static model and are refused with it).
SIBR's requests carry no time, so the video runs on the
wall clock at 30 frames a second, wrapping over the checkpoint's window
[frame_start, frame_start + swin_size): each frame draws the union of the
immature and matured rows (``model/swin.WindowUnion``) moved by their
rigid motion to that (fractional) time, with the rows live at it
(``make_window_render_fn``). Its budget defaults to 8 x the union's rows.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.model import gaussians, swin
from gsplat_tpu_torch.model.gaussians import GaussianState
from gsplat_tpu_torch.raster.rasterize import FrameGraph
from gsplat_tpu_torch.utils.profiling import count, span
from gsplat_tpu_torch.viewer import network_gui

# the video's frame rate: a served SwinGS window's time on the wall clock
VIDEO_FPS = 30.0


def find_latest_iteration(model_path: str) -> int:
    root = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("iteration_")]
    return max(iters)


def make_render_fn(state: GaussianState, k_dup: int, width: int,
                   height: int, device: str | torch.device = "cuda"):
    """The server's render for one resolution: camera, scaling modifier ->
    the frame the viewer receives, uint8 [H, W, 3] on ``device``
    (``render_frame`` through ``FrameGraph``: the state's own tensors are
    the graph's rows)."""
    device = get_device(device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    rows = (state.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], state.get_features(),
            state.alive_mask)
    frames = FrameGraph(lambda: rows, state.max_sh_degree, bg, k_dup)

    def render(camera: CameraParams, scaling_modifier: float = 1.0):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(f"camera is {camera.width}x{camera.height}, "
                             f"this render is {width}x{height}")
        with span("serve.render"):
            return frames(camera, scaling_modifier)

    return render


def make_window_render_fn(state: swin.SwinState, k_dup: int, width: int,
                          height: int, device: str | torch.device = "cuda"):
    """The server's render of a SwinGS window for one resolution: camera,
    video frame (a float; fractional frames move the rows part way),
    scaling modifier -> the frame the viewer receives, uint8 [H, W, 3] on
    ``device``, over a black background. ``swin.WindowUnion`` builds the
    union's frame-invariant columns once; each call stages the frame
    number into a 0-d tensor (the span ``swin.stage``) and replays
    ``FrameGraph``, whose rows (the rigid motion, the unit quaternion and
    the ``valid & start <= f < end`` mask) are computed inside the graph.
    The bytes are ``render_frame(**union_params_at(state, frame))``'s."""
    device = get_device(device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    union = swin.WindowUnion(state)
    frame_no = torch.zeros((), device=device)
    frames = FrameGraph(lambda: union.rows(frame_no), union.sh_degree, bg,
                        k_dup)

    def render(camera: CameraParams, frame: float,
               scaling_modifier: float = 1.0):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(f"camera is {camera.width}x{camera.height}, "
                             f"this render is {width}x{height}")
        with span("swin.render"):
            with span("swin.stage"):
                frame_no.fill_(frame)
                count("swin.union_rows", union.n_rows)
                count("swin.active_rows", union.live_rows(frame))
            return frames(camera, scaling_modifier)

    return render


def window_frame(seconds: float, start: int, size: int) -> float:
    """The video frame a served window shows ``seconds`` after serving
    began: ``VIDEO_FPS`` frames a second from ``start``, wrapping over
    [start, start + size)."""
    return start + (seconds * VIDEO_FPS) % size


def serve(gui: network_gui.NetworkGUI,
          state: GaussianState | swin.SwinState, k_dup: int, verify: str,
          device: str | torch.device = "cuda",
          stop: threading.Event | None = None,
          window_start: int = 0) -> None:
    """Answer viewer requests until ``stop`` is set (forever if None).
    Only the current resolution's render (and its graph) is kept. A
    ``SwinState`` is served at the video frame ``window_frame`` gives
    (its window starts at ``window_start``, the checkpoint's
    ``frame_start``)."""
    size = render_fn = None
    window = isinstance(state, swin.SwinState)
    make = make_window_render_fn if window else make_render_fn
    t0 = time.monotonic()
    while stop is None or not stop.is_set():
        if not gui.try_connect():
            time.sleep(0.05)
            continue
        try:
            with span("serve.request"):
                camera, flags = gui.receive(device)
                if camera is None:
                    gui.send(None, verify)
                    continue
                if (camera.width, camera.height) != size:
                    size = (camera.width, camera.height)
                    render_fn = make(state, k_dup, *size, device)
                if window:
                    frame = window_frame(time.monotonic() - t0,
                                         window_start, state.max_lifespan)
                    img = render_fn(camera, frame,
                                    flags["scaling_modifier"])
                else:
                    img = render_fn(camera, flags["scaling_modifier"])
                data = network_gui.image_to_bytes(img)
                with span("serve.send"):
                    gui.send(data, verify)
            if not flags["keep_alive"]:
                gui.disconnect()
        except (ConnectionError, OSError):
            gui.disconnect()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", "-m", default=None)
    parser.add_argument("--swin_checkpoint", default=None,
                        help="a sliding-window trainer's chkpnt_*.npz")
    parser.add_argument("--iteration", type=int, default=None)
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--cap_max", type=int, default=None)
    parser.add_argument("--sh_degree", type=int, default=None)
    parser.add_argument("--dup_budget", type=int, default=0)
    args = parser.parse_args(argv)
    if args.swin_checkpoint is None and args.model_path is None:
        parser.error("give --model_path or --swin_checkpoint")
    static = [f"--{k}" for k in ("iteration", "cap_max", "sh_degree")
              if getattr(args, k) is not None]
    if args.swin_checkpoint is not None and static:
        parser.error(f"{', '.join(static)}: a static model's options, not "
                     "a --swin_checkpoint's")

    window_start = 0
    if args.swin_checkpoint is not None:
        state, window = swin.load_window(args.swin_checkpoint, "cuda")
        window_start = int(window["frame_start"])
        rows = state.capacity + state.buffer_size
        print(f"serving the window [{window_start}, "
              f"{window_start + state.max_lifespan}) of "
              f"{args.swin_checkpoint}: {rows} union rows, deform "
              f"{state.deform}")
        verify = args.model_path or os.path.dirname(args.swin_checkpoint)
    else:
        iteration = (args.iteration if (args.iteration or 0) > 0
                     else find_latest_iteration(args.model_path))
        ply = (f"{args.model_path}/point_cloud/iteration_{iteration}/"
               "point_cloud.ply")
        rows = args.cap_max or 1_000_000
        state = gaussians.load_ply(ply, capacity=rows,
                                   max_sh_degree=(3 if args.sh_degree is None
                                                  else args.sh_degree),
                                   device="cuda")
        print(f"serving {state.n_alive} gaussians from {ply}")
        verify = args.model_path
    k_dup = args.dup_budget or 8 * rows
    gui = network_gui.NetworkGUI(args.ip, args.port)
    print(f"listening on {args.ip}:{args.port}", flush=True)
    try:
        serve(gui, state, k_dup, verify, device="cuda",
              window_start=window_start)
    finally:
        gui.close()


if __name__ == "__main__":
    main()
