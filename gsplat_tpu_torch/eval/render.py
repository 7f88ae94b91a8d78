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

``--pshard N`` renders with the Gaussian rows sharded over N ranks
(parallel/pshard.py: depth slabs and the ordered compositing fold),
``--tileshard N`` with the image rows split into N bands
(parallel/tileshard.py). The command starts its ranks itself, or runs as
one rank under torchrun; only rank 0 writes the PNGs.

Usage:
  python -m gsplat_tpu_torch.eval.render -m <model_path> [-s <source>]
         [--iteration N] [--skip_train] [--skip_test] [--data_device cuda]
         [--pshard N | --tileshard N]
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
from gsplat_tpu_torch.parallel import launch
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.pshard import make_pshard_render
from gsplat_tpu_torch.parallel.tileshard import make_tileshard_render
from gsplat_tpu_torch.train.config import (ModelConfig, PipelineConfig,
                                           add_config_args, extract_config,
                                           load_combined_args)
from gsplat_tpu_torch.train.train_static import make_settings


def save_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] image, uint8 or float in [0, 1], as an 8-bit
    PNG."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    Image.fromarray(img).save(path)


def find_latest_iteration(model_path: str) -> int:
    root = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("iteration_")]
    return max(iters)


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


def _parallel_render(state, settings, n_ps: int, n_ts: int, mesh):
    """render(camera, bg) -> ([H, W, 3] image clipped to [0, 1], None) over
    the ranks of ``mesh``."""
    if n_ps > 1:
        if state.capacity % n_ps:
            raise ValueError(f"--cap_max {state.capacity} must be divisible "
                             f"by --pshard {n_ps}")
        render = make_pshard_render(mesh, settings, state.max_sh_degree)
        rows = {k: mesh_lib.shard_rows(v, mesh, "ps") for k, v in (
            ("means", state.xyz), ("scales", state.get_scaling()),
            ("quats", state.get_rotation()),
            ("opa", state.get_opacity()[:, 0]),
            ("shs", state.get_features()), ("alive", state.alive_mask))}
        args = tuple(rows.values())
    else:
        render = make_tileshard_render(mesh, settings, state.max_sh_degree)
        args = (state.xyz, state.get_scaling(), state.get_rotation(),
                state.get_opacity()[:, 0], state.get_features(),
                state.alive_mask)

    @torch.no_grad()
    def render_one(camera, bg):
        return torch.clamp(render(*args, camera, bg), 0.0, 1.0), None

    return render_one


def render_set(model_path, split, iteration, cameras, state, settings, bg,
               pipe: PipelineConfig | None = None, n_ps: int = 1,
               n_ts: int = 1, mesh=None):
    """Render ``cameras`` and write renders/ and gt/ PNGs; with ``mesh``
    (n_ps or n_ts above 1) every rank renders and rank 0 writes."""
    renders_dir = os.path.join(model_path, split, f"ours_{iteration}",
                               "renders")
    gt_dir = os.path.join(model_path, split, f"ours_{iteration}", "gt")
    if n_ps > 1 or n_ts > 1:
        render_one = _parallel_render(state, settings, n_ps, n_ts, mesh)
    else:
        def render_one(camera, bg):
            return render_view(camera, state, settings, bg, pipe)
    write = mesh is None or torch.distributed.get_rank() == 0
    for idx, cam_obj in enumerate(cameras):
        camera, gt = cam_obj.load()
        t0 = time.perf_counter()
        img, num_dup = render_one(camera, bg)
        img = img.cpu().numpy()
        t1 = time.perf_counter()
        if write:
            save_png(os.path.join(renders_dir, f"{idx:05d}.png"), img)
            save_png(os.path.join(gt_dir, f"{idx:05d}.png"), gt)
        t2 = time.perf_counter()
        cam_obj.unload()
        dup = "" if num_dup is None else f"num_dup={int(num_dup)} "
        print(f"view {split} {idx:05d} {dup}k_dup={settings.k_dup} "
              f"render_s={t1 - t0:.6f} write_s={t2 - t1:.6f}")
    print(f"rendered {len(cameras)} {split} views -> {renders_dir}")


def render_sets(model_cfg: ModelConfig, pipe: PipelineConfig,
                iteration: int = -1, skip_train=False, skip_test=False,
                n_ps: int = 1, n_ts: int = 1):
    if n_ps > 1 and n_ts > 1:
        raise ValueError("--pshard and --tileshard are mutually exclusive")
    if n_ps > 1 or n_ts > 1:
        return launch.run(_rank_render_sets, max(n_ps, n_ts),
                          model_cfg.data_device,
                          (model_cfg, pipe, iteration, skip_train,
                           skip_test, n_ps, n_ts))
    return _render_sets(model_cfg, pipe, iteration, skip_train, skip_test,
                        get_device(model_cfg.data_device))


def _rank_render_sets(model_cfg, pipe, iteration, skip_train, skip_test,
                      n_ps, n_ts):
    """One rank of a --pshard / --tileshard render."""
    device = launch.rank_device(model_cfg.data_device,
                                torch.distributed.get_rank(),
                                torch.distributed.get_backend())
    mesh = mesh_lib.make_mesh(axis_name="ps" if n_ps > 1 else "sp",
                              device=device)
    return _render_sets(model_cfg, pipe, iteration, skip_train, skip_test,
                        device, mesh, n_ps, n_ts)


def _render_sets(model_cfg, pipe, iteration, skip_train, skip_test, device,
                 mesh=None, n_ps: int = 1, n_ts: int = 1):
    rank0 = mesh is None or torch.distributed.get_rank() == 0

    def load():
        return Scene(model_cfg.source_path,
                     model_cfg.model_path if rank0 else "",
                     images=model_cfg.images, eval_split=model_cfg.eval,
                     resolution=model_cfg.resolution,
                     white_background=model_cfg.white_background,
                     init_type=model_cfg.init_type,
                     num_pts=model_cfg.init_pts, shuffle=False,
                     device=device)

    # the reader may write a PLY beside the dataset: ranks read in turn
    scene = load() if mesh is None else mesh_lib.in_turn(load)
    if iteration == -1:
        iteration = find_latest_iteration(model_cfg.model_path)
    ply_path = os.path.join(model_cfg.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
    state = gaussians.load_ply(ply_path, capacity=model_cfg.cap_max,
                               max_sh_degree=model_cfg.sh_degree,
                               device=device)
    print(f"loaded {state.n_alive} gaussians from {ply_path}")

    settings = make_settings(pipe, model_cfg.cap_max)
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    for split, skip, cams in (("train", skip_train, scene.train_cameras),
                              ("test", skip_test, scene.test_cameras)):
        if not skip:
            render_set(model_cfg.model_path, split, iteration, cams, state,
                       settings, bg, pipe, n_ps, n_ts, mesh)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rendering script parameters")
    add_config_args(parser, ModelConfig())
    add_config_args(parser, PipelineConfig())
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--pshard", type=int, default=1,
                        help="Gaussian-sharded rendering over N ranks "
                             "(depth-slab partition + ordered compositing)")
    parser.add_argument("--tileshard", type=int, default=1,
                        help="image-band sharded rendering over N ranks "
                             "(each renders H/N rows against the full "
                             "model; no compositing collective)")
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
