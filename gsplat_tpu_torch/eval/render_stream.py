"""Render a streamed SwinGS scene (streamable.dat) frame by frame (port of
gsplat_tpu/eval/render_stream.py).

Loads the append-only matured-Gaussian stream that train_swin writes and,
for each requested frame, renders every camera with the lifespan-active
rows on the inference path (bf16 feature stream, 128x32 tiles, a
duplicate budget of max(8 n, 65536) unless --dup_budget is given), so
playback runs the render kernel and an owner-expansion kernel.

Usage:
  python -m gsplat_tpu_torch.eval.render_stream -m <model_path> \
      -s <dataset> [--frames 0 10] [--skip_train] [--data_device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core.quaternion import normalize
from gsplat_tpu_torch.data.scene import DynamicScene
from gsplat_tpu_torch.eval.render import save_png
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize
from gsplat_tpu_torch.utils.stream import stream_load


def load_stream_state(model_path: str, device="cuda") -> dict:
    """The stream's columns as float32 tensors on ``device`` (SH
    concatenated into ``shs``) and its SH degree."""
    data = stream_load(os.path.join(model_path, "format.json"),
                       os.path.join(model_path, "streamable.dat"))
    print(f"loaded {data['xyz'].shape[0]} streamed gaussians (sh degree "
          f"{data['sh_degree']})")
    out = {k: torch.as_tensor(np.asarray(data[k], np.float32), device=device)
           for k in ("start_frame", "end_frame", "xyz", "rotation",
                     "scaling", "opacity")}
    out["shs"] = torch.as_tensor(
        np.concatenate([data["f_dc"], data["f_rest"]], axis=1),
        device=device)
    out["sh_degree"] = int(data["sh_degree"])
    return out


@torch.no_grad()
def render_stream_frame(data: dict, camera, frame: float, bg, settings):
    """Render one frame from ``load_stream_state``'s columns: the rows with
    start <= frame < end, without rigid motion (the stream format carries
    none, stream_utils.py:16-32, so the reference's playback drops it
    too) -> [H, W, 3] float32 in [0, 1]."""
    active = (data["start_frame"] <= frame) & (data["end_frame"] > frame)
    out = rasterize(data["xyz"], torch.exp(data["scaling"]),
                    normalize(data["rotation"]),
                    torch.sigmoid(data["opacity"])[:, 0], data["shs"],
                    camera, data["sh_degree"], bg, settings, alive=active)
    img = out.image
    if settings.inference:  # [3, H, W] bf16 -> [H, W, 3] float32
        img = img.float().permute(1, 2, 0)
    return torch.clamp(img, 0.0, 1.0)


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
    # playback is inference: bf16 stream, 128x32 tiles
    k_dup = args.dup_budget or max(8 * data["xyz"].shape[0], 1 << 16)
    settings = RasterizeSettings(k_dup=-(-k_dup // 128) * 128,
                                 inference=True, tile_x=128, tile_y=32)
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
            count = 0
            for f in range(lo, hi):
                for cam_obj in getter([f]):
                    camera, gt = cam_obj.load()
                    img = render_stream_frame(data, camera, float(f), bg,
                                              settings)
                    name = cam_obj.image_name.replace("/", "_")
                    save_png(os.path.join(out_dir, f"{name}.png"),
                             img.cpu().numpy())
                    save_png(os.path.join(gt_dir, f"{name}.png"), gt)
                    cam_obj.unload()
                    count += 1
            print(f"rendered {count} {split} views -> {out_dir}")
    finally:
        scene.close()


if __name__ == "__main__":
    main()
