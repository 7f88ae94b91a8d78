"""Offline render entry: render the train/test sets of a trained model to
PNGs (port of gsplat_tpu/eval/render.py).

The working equivalent of the reference's render.py (render_sets,
:37-55). Output layout is the reference's:
{model}/{split}/ours_{iteration}/renders/*.png + gt/*.png, so its
metrics.py protocol applies unchanged. Views render through
``train_static.make_settings``: the float32 training rasterizer's forward
(binning's owner expansion and the blend forward kernel) under
``torch.no_grad()``, clipped to [0, 1]. Each view prints its duplicate
count, its render seconds (to the image on the host) and its PNG write
seconds.

Not in this slice of the port: ``--pshard`` / ``--tileshard`` above 1
(the parallel modes) raise NotImplementedError.

Usage:
  python -m gsplat_tpu_torch.eval.render -m <model_path> [-s <source>]
         [--iteration N] [--skip_train] [--skip_test] [--data_device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gsplat_tpu_torch import get_device, renderer
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.model import gaussians
from gsplat_tpu_torch.train.config import (ModelConfig, PipelineConfig,
                                           add_config_args, extract_config,
                                           load_combined_args)
from gsplat_tpu_torch.train.train_static import make_settings


def save_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] float image in [0, 1] as an 8-bit PNG."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
                    ).save(path)


def find_latest_iteration(model_path: str) -> int:
    root = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("iteration_")]
    return max(iters)


def _no_parallel(n_ps: int, n_ts: int) -> None:
    if n_ps > 1 or n_ts > 1:
        raise NotImplementedError(
            "gsplat_tpu_torch renders on one device; --pshard and "
            "--tileshard above 1 come with the parallel slice of the port")


@torch.no_grad()
def render_view(camera, state, settings, bg,
                pipe: PipelineConfig | None = None):
    """One view: ([H, W, 3] float32 image on the device, clipped to [0,
    1], the rasterizer's duplicate count)."""
    pipe = pipe or PipelineConfig()
    out = renderer.render(
        camera, state, bg, settings,
        convert_shs_python=pipe.convert_SHs_python,
        compute_cov3d_python=pipe.compute_cov3D_python)
    return torch.clamp(out["render"], 0.0, 1.0), out["num_dup"]


def render_set(model_path, split, iteration, cameras, state, settings, bg,
               pipe: PipelineConfig | None = None, n_ps: int = 1,
               n_ts: int = 1):
    _no_parallel(n_ps, n_ts)
    renders_dir = os.path.join(model_path, split, f"ours_{iteration}",
                               "renders")
    gt_dir = os.path.join(model_path, split, f"ours_{iteration}", "gt")
    for idx, cam_obj in enumerate(cameras):
        camera, gt = cam_obj.load()
        t0 = time.perf_counter()
        img, num_dup = render_view(camera, state, settings, bg, pipe)
        img = img.cpu().numpy()
        t1 = time.perf_counter()
        save_png(os.path.join(renders_dir, f"{idx:05d}.png"), img)
        save_png(os.path.join(gt_dir, f"{idx:05d}.png"), gt)
        t2 = time.perf_counter()
        cam_obj.unload()
        print(f"view {split} {idx:05d} num_dup={int(num_dup)} "
              f"k_dup={settings.k_dup} render_s={t1 - t0:.6f} "
              f"write_s={t2 - t1:.6f}")
    print(f"rendered {len(cameras)} {split} views -> {renders_dir}")


def render_sets(model_cfg: ModelConfig, pipe: PipelineConfig,
                iteration: int = -1, skip_train=False, skip_test=False,
                n_ps: int = 1, n_ts: int = 1):
    _no_parallel(n_ps, n_ts)
    device = get_device(model_cfg.data_device)
    scene = Scene(model_cfg.source_path, model_cfg.model_path,
                  images=model_cfg.images, eval_split=model_cfg.eval,
                  resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  init_type=model_cfg.init_type, num_pts=model_cfg.init_pts,
                  shuffle=False, device=device)
    if iteration == -1:
        iteration = find_latest_iteration(model_cfg.model_path)
    ply_path = scene.point_cloud_path(iteration)
    state = gaussians.load_ply(ply_path, capacity=model_cfg.cap_max,
                               max_sh_degree=model_cfg.sh_degree,
                               device=device)
    print(f"loaded {state.n_alive} gaussians from {ply_path}")

    settings = make_settings(pipe, model_cfg.cap_max)
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    if not skip_train:
        render_set(model_cfg.model_path, "train", iteration,
                   scene.train_cameras, state, settings, bg, pipe)
    if not skip_test:
        render_set(model_cfg.model_path, "test", iteration,
                   scene.test_cameras, state, settings, bg, pipe)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rendering script parameters")
    add_config_args(parser, ModelConfig())
    add_config_args(parser, PipelineConfig())
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--pshard", type=int, default=1,
                        help="Gaussian-sharded rendering over N devices "
                             "(the parallel slice of the port)")
    parser.add_argument("--tileshard", type=int, default=1,
                        help="image-band sharded rendering over N devices "
                             "(the parallel slice of the port)")
    args = load_combined_args(parser) if argv is None else \
        parser.parse_args(argv)
    model_cfg = extract_config(args, ModelConfig)
    pipe = extract_config(args, PipelineConfig)
    print("Rendering " + model_cfg.model_path)
    n_ps, n_ts = getattr(args, "pshard", 1), getattr(args, "tileshard", 1)
    if n_ps > 1 and n_ts > 1:
        raise ValueError("--pshard and --tileshard are mutually exclusive")
    render_sets(model_cfg, pipe, args.iteration, args.skip_train,
                args.skip_test, n_ps=n_ps, n_ts=n_ts)


if __name__ == "__main__":
    main()
