"""Render a streamed SwinGS scene (streamable.dat) frame by frame (port of
gsplat_tpu/eval/render_stream.py).

Loads the append-only matured-Gaussian stream that train_swin writes and,
for each requested frame, renders every camera with the lifespan-active
rows through ``raster.rasterize.render_frame`` (bf16 feature stream,
128x32 tiles, uint8 bytes made on the device), so playback runs the
render kernel, an owner-expansion kernel and the encode.

A frame's work is set by its live rows, not by the stream's length. Every
row lives at most L frames, L the stream's largest ``end - start``
(``swin_size`` for the rows that roll over, fewer for genesis rows), so
the rows live at frame f are among those with ``end`` in (f, f + L].
``load_stream_state`` orders the rows by ``end_frame`` (a stable sort),
which makes those rows one contiguous slice, and keeps each frame's slice
bounds and live-row count as host integers; a frame renders its slice
alone, masked by ``start <= f``. The activated columns (scales,
unit quaternions, opacities, SH) are computed once, at load.

The player (``make_stream_render_fn``) copies each frame's slice into
buffers as wide as the widest slice, the rows past it dead, and renders
them through ``FrameGraph``: one CUDA graph serves every video frame,
and the ``start <= f`` mask is computed inside it from the staged frame
number.

The duplicate budget is ``--dup_budget``, else max(8 x the largest
slice, 65536), rounded up to 128.

Usage:
  python -m gsplat_tpu_torch.eval.render_stream -m <model_path> \
      -s <dataset> [--frames 0 10] [--skip_train] [--data_device cuda]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.core.quaternion import normalize
from gsplat_tpu_torch.data.scene import DynamicScene
from gsplat_tpu_torch.eval.render import save_png
from gsplat_tpu_torch.raster.rasterize import FrameGraph, render_frame
from gsplat_tpu_torch.utils.profiling import count, span
from gsplat_tpu_torch.utils.stream import stream_load

# the columns render_frame takes, in its argument order
COLUMNS = ("xyz", "scales", "quats", "opacities", "shs")


def load_stream_state(model_path: str, device="cuda") -> dict:
    """The stream ready for playback: its rows ordered by ``end_frame``
    (stable), as float32 tensors on ``device``: ``xyz``, the activated
    ``scales`` (exp), ``quats`` (unit), ``opacities`` [N] (sigmoid), ``shs``
    (DC and rest concatenated) and ``start_frame``; its ``sh_degree``;
    and, host integer arrays over frames 0 .. max end - 1, each frame's
    slice ``slice_lo`` / ``slice_hi`` (the rows with end in (f, f + L])
    and ``live_rows`` (start <= f < end)."""
    data = stream_load(os.path.join(model_path, "format.json"),
                       os.path.join(model_path, "streamable.dat"))
    n = data["xyz"].shape[0]
    print(f"loaded {n} streamed gaussians (sh degree {data['sh_degree']})")
    start, end = data["start_frame"], data["end_frame"]
    order = np.argsort(end, kind="stable")
    idx = torch.as_tensor(order, device=device)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).index_select(0, idx)

    out = {"xyz": col(data["xyz"]),
           "scales": torch.exp(col(data["scaling"])),
           "quats": normalize(col(data["rotation"])),
           "opacities": torch.sigmoid(col(data["opacity"])[:, 0]),
           "shs": col(np.concatenate([data["f_dc"], data["f_rest"]], 1)),
           "start_frame": col(start), "sh_degree": int(data["sh_degree"])}
    life = int((end - start).max()) if n else 0
    n_frames = int(end.max()) if n else 0
    frames = np.arange(n_frames)
    end_sorted = end[order]
    out["slice_lo"] = np.searchsorted(end_sorted, frames, side="right")
    out["slice_hi"] = np.searchsorted(end_sorted, frames + life,
                                      side="right")
    born = np.cumsum(np.bincount(start, minlength=n_frames + 1))
    gone = np.cumsum(np.bincount(end, minlength=n_frames + 1))
    out["live_rows"] = (born - gone)[:n_frames]
    return out


def frame_rows(data: dict, frame: float) -> tuple[int, int, int]:
    """(lo, hi, live): the slice [lo, hi) of ``load_stream_state``'s rows
    that holds every row live at ``frame``, and how many are live; host
    integers, no device sync. Empty outside the stream's frames."""
    f = math.floor(frame)
    if not 0 <= f < len(data["slice_lo"]):
        return 0, 0, 0
    return (int(data["slice_lo"][f]), int(data["slice_hi"][f]),
            int(data["live_rows"][f]))


def widest_slice(data: dict) -> int:
    """The most rows any frame's slice holds."""
    hi, lo = data["slice_hi"], data["slice_lo"]
    return int((hi - lo).max()) if len(lo) else 0


def dup_budget(data: dict) -> int:
    """The CLI's default duplicate budget: max(8 x the largest slice,
    65536)."""
    return max(8 * widest_slice(data), 1 << 16)


def select_rows(data: dict, frame: float) -> tuple[int, int]:
    """``frame_rows``' slice (lo, hi) of a played frame, under the span
    ``stream.select``, its rows and live rows counted
    (``stream.slice_rows``, ``stream.live_rows``)."""
    with span("stream.select"):
        lo, hi, live = frame_rows(data, frame)
        count("stream.slice_rows", hi - lo)
        count("stream.live_rows", live)
    return lo, hi


def render_stream_frame(data: dict, camera: CameraParams, frame: float, bg,
                        k_dup: int):
    """One frame from ``load_stream_state``'s stream: the rows with
    start <= frame < end, without rigid motion (the stream format carries
    none, stream_utils.py:16-32, so the reference's playback drops it
    too), through ``render_frame`` on the frame's slice alone -> uint8
    [H, W, 3]."""
    lo, hi = select_rows(data, frame)
    rows = [data[k][lo:hi] for k in COLUMNS]
    alive = data["start_frame"][lo:hi] <= frame
    return render_frame(*rows, camera, data["sh_degree"], bg, k_dup,
                        alive=alive)[0]


def make_stream_render_fn(stream: dict, k_dup: int, width: int,
                          height: int, device: str | torch.device = "cuda"):
    """The player's render for one resolution: camera, frame -> the frame
    a viewer receives, uint8 [H, W, 3] on ``device``, over a black
    background: ``render_stream_frame``'s frame, through ``FrameGraph``.
    The frame's slice is copied into the first rows of buffers as wide as
    the widest slice; the rest get start = inf, so ``start <= f`` culls
    them, and one graph plays every frame; the copies are the span
    ``stream.stage``."""
    device = get_device(device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    wide = widest_slice(stream)
    names = COLUMNS + ("start_frame",)
    staged = {k: stream[k].new_zeros((wide,) + stream[k].shape[1:])
              for k in names}
    dead = torch.full((wide,), float("inf"), device=device)
    frame_no = torch.zeros((), device=device)

    def rows():
        return (*(staged[k] for k in COLUMNS),
                staged["start_frame"] <= frame_no)

    frames = FrameGraph(rows, stream["sh_degree"], bg, k_dup)

    def render(camera: CameraParams, frame: float):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(f"camera is {camera.width}x{camera.height}, "
                             f"this render is {width}x{height}")
        with span("stream.render"):
            lo, hi = select_rows(stream, frame)
            with span("stream.stage"):
                for k in names:
                    staged[k][:hi - lo].copy_(stream[k][lo:hi])
                staged["start_frame"][hi - lo:].copy_(dead[hi - lo:])
                frame_no.fill_(frame)
            return frames(camera)

    return render


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--frames", nargs=2, type=int, default=None)
    parser.add_argument("--max_frame", type=int, default=100)
    parser.add_argument("--min_frame", type=int, default=0)
    parser.add_argument("--resolution", "-r", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--dup_budget", type=int, default=0)
    parser.add_argument("--data_device", default="cuda")
    args = parser.parse_args(argv)

    device = get_device(args.data_device)
    data = load_stream_state(args.model_path, device)
    k_dup = args.dup_budget or dup_budget(data)
    k_dup = -(-k_dup // 128) * 128
    scene = DynamicScene(args.source_path, "", resolution=args.resolution,
                         max_frame=args.max_frame, min_frame=args.min_frame,
                         shuffle=False, device=device)
    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background
                      else [0.0, 0.0, 0.0], device=device)
    lo, hi = args.frames if args.frames else (0, scene.num_frames)
    splits = [("test", scene.get_test_cams_at)]
    if not args.skip_train:
        splits.append(("train", scene.get_train_cams_at))
    try:
        for split, getter in splits:
            out_dir = os.path.join(args.model_path, split, "stream",
                                   "renders")
            gt_dir = os.path.join(args.model_path, split, "stream", "gt")
            views = 0
            for f in range(lo, hi):
                for cam_obj in getter([f]):
                    camera, gt = cam_obj.load()
                    img = render_stream_frame(data, camera, float(f), bg,
                                              k_dup)
                    name = cam_obj.image_name.replace("/", "_")
                    save_png(os.path.join(out_dir, f"{name}.png"),
                             img.cpu().numpy())
                    save_png(os.path.join(gt_dir, f"{name}.png"), gt)
                    cam_obj.unload()
                    views += 1
            print(f"rendered {views} {split} views -> {out_dir}")
    finally:
        scene.close()


if __name__ == "__main__":
    main()
