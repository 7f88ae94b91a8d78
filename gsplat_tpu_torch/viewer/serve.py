"""Live-viewer server: load a trained model, answer SIBR requests
(port of gsplat_tpu/viewer/serve.py; same CLI and settings).

Usage:
  python -m gsplat_tpu_torch.viewer.serve -m <model_path> [--iteration N]
         [--ip 127.0.0.1] [--port 6009] [--cap_max N] [--sh_degree D]
         [--dup_budget K]

Renders on the GPU through the inference rasterizer: bf16 feature stream,
128x32 tiles, background composited in the kernel, duplicate budget
``--dup_budget`` or 8 x cap_max. ``serve`` and ``make_render_fn`` take a
``device``; on the CPU they run the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.model import gaussians
from gsplat_tpu_torch.model.gaussians import GaussianState
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize
from gsplat_tpu_torch.viewer import network_gui

TILE_X, TILE_Y = 128, 32


def find_latest_iteration(model_path: str) -> int:
    root = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("iteration_")]
    return max(iters)


def make_render_fn(state: GaussianState, k_dup: int, width: int,
                   height: int, device: str | torch.device = "cuda"):
    """The server's render for one resolution: camera, scaling modifier ->
    [H, W, 3] float32 image clipped to [0, 1] on ``device``."""
    device = get_device(device)
    settings = RasterizeSettings(k_dup=k_dup, inference=True,
                                 tile_x=TILE_X, tile_y=TILE_Y)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    means = state.xyz
    scales = state.get_scaling()
    quats = state.get_rotation()
    opac = state.get_opacity()[:, 0]
    shs = state.get_features()
    alive = state.alive_mask

    def render(camera: CameraParams, scaling_modifier: float = 1.0):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(f"camera is {camera.width}x{camera.height}, "
                             f"this render is {width}x{height}")
        out = rasterize(means, scales, quats, opac, shs, camera,
                        state.max_sh_degree, bg, settings,
                        scale_modifier=scaling_modifier, alive=alive)
        img = out.image.float().permute(1, 2, 0)
        return torch.clamp(img, 0.0, 1.0)

    return render


def serve(gui: network_gui.NetworkGUI, state: GaussianState, k_dup: int,
          verify: str, device: str | torch.device = "cuda",
          stop: threading.Event | None = None) -> None:
    """Answer viewer requests until ``stop`` is set (forever if None)."""
    render_fns = {}
    while stop is None or not stop.is_set():
        if not gui.try_connect():
            time.sleep(0.05)
            continue
        try:
            camera, flags = gui.receive(device)
            if camera is None:
                gui.send(None, verify)
                continue
            key = (camera.width, camera.height)
            if key not in render_fns:
                render_fns[key] = make_render_fn(state, k_dup, *key, device)
            img = render_fns[key](camera, flags["scaling_modifier"])
            gui.send(network_gui.image_to_bytes(img), verify)
            if not flags["keep_alive"]:
                gui.disconnect()
        except (ConnectionError, OSError):
            gui.disconnect()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--cap_max", type=int, default=1_000_000)
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--dup_budget", type=int, default=0)
    args = parser.parse_args(argv)

    iteration = (args.iteration if args.iteration > 0
                 else find_latest_iteration(args.model_path))
    ply = f"{args.model_path}/point_cloud/iteration_{iteration}/point_cloud.ply"
    state = gaussians.load_ply(ply, capacity=args.cap_max,
                               max_sh_degree=args.sh_degree,
                               device="cuda")
    print(f"serving {state.n_alive} gaussians from {ply}")
    k_dup = args.dup_budget or 8 * args.cap_max
    gui = network_gui.NetworkGUI(args.ip, args.port)
    print(f"listening on {args.ip}:{args.port}", flush=True)
    try:
        serve(gui, state, k_dup, args.model_path, device="cuda")
    finally:
        gui.close()


if __name__ == "__main__":
    main()
