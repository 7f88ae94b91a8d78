"""Static 3DGS-MCMC training entry point (port of
gsplat_tpu/train/train_static.py, the single-device loop).

CLI and behaviour mirror the reference train_static.py:212-243 /
training() (:36-144): a random camera per iteration (python ``random``,
seeded by --camera_seed as the reference's safe_state does), L1 + SSIM
loss with opacity/scale regularisers, covariance-shaped noise, MCMC
relocation + capped growth every densification_interval (the split
grad -> densify -> Adam -> noise order on those iterations), the adaptive
duplicate budget, periodic PSNR eval and PLY saves.

Not in this slice of the port (each raises NotImplementedError):
--data_parallel / --pshard above 1, --replay_rng, --start_checkpoint,
--checkpoint_iterations, --profile_iterations, and SwinGS datasets.

Usage:
  python -m gsplat_tpu_torch.train.train_static -s <dataset> -m <out> \
      --cap_max N
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys
import time

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.data.readers import detect_scene_type
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.model import gaussians, optim
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import step as step_lib
from gsplat_tpu_torch.train.config import (ModelConfig, OptimizationConfig,
                                           PipelineConfig, add_config_args,
                                           auto_dup_budget, extract_config,
                                           save_cfg_args)
from gsplat_tpu_torch.utils import debug as debug_lib


def next_dup_budget(num_dup: int, k_dup: int, iteration: int,
                    dup_peak: int, dup_tightened: bool,
                    densify_until_iter: int,
                    chunk: int) -> tuple[int | None, int, bool]:
    """Adaptive duplicate-budget policy: returns (new k_dup or None,
    updated dup_peak, updated dup_tightened).

    - grow to 1.5x on (near-)overflow, so no run trains long on silently
      truncated tile lists;
    - shrink to 1.6x when grossly oversized (< 0.35x), checked every 1000
      iterations;
    - tighten once to 1.12x the observed peak shortly after densification
      ends (every padded slot feeds the K-sized stages)."""
    dup_peak = max(dup_peak, num_dup)
    new_k = None
    if num_dup > 0.95 * k_dup:
        new_k = int(num_dup * 1.5)
    elif (iteration % 1000 == 0 and k_dup > 1 << 16
          and num_dup < 0.35 * k_dup):
        new_k = max(int(num_dup * 1.6), 1 << 16)
    elif (not dup_tightened and dup_peak > 0
          and iteration > densify_until_iter + 300
          and k_dup > 1.25 * dup_peak):
        new_k = max(int(dup_peak * 1.12), 1 << 16)
        dup_tightened = True
    if new_k is not None:
        new_k = -(-new_k // chunk) * chunk
    return new_k, dup_peak, dup_tightened


def make_settings(pipe: PipelineConfig, cap_max: int) -> RasterizeSettings:
    return RasterizeSettings(k_dup=auto_dup_budget(cap_max, pipe),
                             tile_x=pipe.tile_x, tile_y=pipe.tile_y,
                             chunk=pipe.chunk)


def _unsupported(args) -> list[str]:
    """The CLI options that later slices of the port bring."""
    out = []
    if getattr(args, "data_parallel", 1) > 1:
        out.append("--data_parallel")
    if getattr(args, "pshard", 1) > 1:
        out.append("--pshard")
    for name in ("replay_rng", "start_checkpoint", "profile_iterations"):
        if getattr(args, name, None):
            out.append("--" + name)
    if getattr(args, "checkpoint_iterations", None):
        out.append("--checkpoint_iterations")
    return out


def _chw(gt: np.ndarray, device) -> torch.Tensor:
    """Host [H, W, 3] image -> [3, H, W] on the device (the steps run
    channel-first)."""
    return torch.as_tensor(np.ascontiguousarray(gt.transpose(2, 0, 1)),
                           device=device)


def training(model_cfg: ModelConfig, opt: OptimizationConfig,
             pipe: PipelineConfig, args) -> dict:
    if model_cfg.cap_max == -1:
        print("Please specify the maximum number of Gaussians with --cap_max.")
        sys.exit(1)
    missing = _unsupported(args)
    if missing:
        raise NotImplementedError(
            f"gsplat_tpu_torch trains on one device without checkpoints or "
            f"RNG replay; {', '.join(missing)} come with later slices of "
            f"the port")
    device = get_device(model_cfg.data_device)

    # safe_state parity (general_utils.py:112-133): seed the camera draw
    random.seed(getattr(args, "camera_seed", 0))
    tb_writer = _prepare_output_and_logger(model_cfg, args)

    if detect_scene_type(model_cfg.source_path) == "SwinGS":
        raise NotImplementedError(
            "SwinGS datasets (train one frame with --frame) come with the "
            "SwinGS slice of the port")
    scene = Scene(model_cfg.source_path, model_cfg.model_path,
                  images=model_cfg.images, eval_split=model_cfg.eval,
                  resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  init_type=model_cfg.init_type, num_pts=model_cfg.init_pts,
                  device=device)
    train_cams, test_cams = scene.train_cameras, scene.test_cameras
    cameras_extent = scene.cameras_extent

    capacity = model_cfg.cap_max
    n_init = min(scene.info.points.shape[0], capacity)
    state = gaussians.create_from_points(
        scene.info.points[:n_init], scene.info.colors[:n_init], capacity,
        model_cfg.sh_degree, device=device)
    adam = optim.init(state.params())
    settings = make_settings(pipe, capacity)

    def build_steps(s):
        return (step_lib.make_train_step(opt, s, cameras_extent),
                step_lib.make_grad_step(opt, s, cameras_extent),
                step_lib.make_eval_step(s))

    train_step, grad_step, eval_step = build_steps(settings)
    apply_step = step_lib.make_apply_step(opt, cameras_extent)
    densify_step = step_lib.make_densify_step(capacity)

    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    viewpoint_stack: list = []
    ema_loss = 0.0
    dup_peak, dup_tightened = 0, False
    metrics = None
    t_start = time.time()
    for iteration in range(1, opt.iterations + 1):
        if iteration == getattr(args, "debug_from", -1):
            torch.autograd.set_detect_anomaly(True)
            print(f"debug: anomaly detection armed at iteration {iteration}")
        sh_degree = min(iteration // 1000, model_cfg.sh_degree)
        step_bg = (torch.rand(3, generator=gen, device=device)
                   if opt.random_background else bg)
        densify_now = (opt.densify_from_iter < iteration
                       < opt.densify_until_iter
                       and iteration % opt.densification_interval == 0)
        if not viewpoint_stack:
            viewpoint_stack = list(train_cams)
        cam_obj = viewpoint_stack.pop(random.randint(0,
                                                     len(viewpoint_stack) - 1))
        camera, gt = cam_obj.load()
        gt_dev = _chw(gt, device)
        if densify_now:
            # reference interleave: backward -> densify -> Adam -> noise
            grads, metrics = grad_step(state, camera, gt_dev, step_bg,
                                       sh_degree)
            # did relocation or growth touch the model? (decides the
            # reference's grad=None Adam skip, see make_apply_step)
            n = state.n_alive
            dead_any = bool((state.alive_mask
                             & (state.get_opacity()[:, 0] <= 0.005)).any())
            surgery = dead_any or min(capacity, int(1.05 * n)) > n
            state, adam = densify_step(state, adam, gen)
            state, adam = apply_step(state, adam, grads, gen,
                                     float(iteration), not surgery)
        else:
            state, adam, metrics = train_step(state, adam, gen, camera,
                                              gt_dev, step_bg,
                                              float(iteration), sh_degree)

        if iteration % 10 == 0:
            loss = float(metrics.loss)
            debug_lib.check_finite_loss(loss, iteration, model_cfg.model_path,
                                        params=state.params(), adam=adam,
                                        camera=camera)
            ema_loss = 0.4 * loss + 0.6 * ema_loss
            num_dup = int(metrics.num_dup)
            if tb_writer:
                tb_writer.add_scalar("train_loss_patches/l1_loss",
                                     float(metrics.l1), iteration)
                tb_writer.add_scalar("train_loss_patches/total_loss", loss,
                                     iteration)
            if num_dup > settings.k_dup:
                print(f"  WARNING: duplicate budget overflowed "
                      f"({num_dup} > {settings.k_dup}); recent steps "
                      f"trained on truncated tile lists")
            new_k, dup_peak, dup_tightened = next_dup_budget(
                num_dup, settings.k_dup, iteration, dup_peak, dup_tightened,
                opt.densify_until_iter, settings.chunk)
            if new_k is not None:
                settings = dataclasses.replace(settings, k_dup=new_k)
                print(f"  duplicate budget -> {new_k}")
                train_step, grad_step, eval_step = build_steps(settings)
        if iteration % 100 == 0:
            dt = (time.time() - t_start) / min(iteration, 100)
            t_start = time.time()
            print(f"[ITER {iteration}] loss={float(metrics.loss):.5f} "
                  f"ema={ema_loss:.5f} psnr={float(metrics.psnr):.2f} "
                  f"n={state.n_alive} dup={int(metrics.num_dup)}/"
                  f"{settings.k_dup} {dt * 1000:.1f}ms/it")
            if tb_writer:
                tb_writer.add_scalar("iter_time", dt * 1000, iteration)
                tb_writer.add_scalar("total_points", state.n_alive,
                                     iteration)

        if iteration in args.test_iterations and test_cams:
            _report_eval(tb_writer, eval_step, state, test_cams, bg,
                         sh_degree, iteration, train_cams=train_cams)
        if iteration in args.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            gaussians.save_ply(state, scene.point_cloud_path(iteration))

    return {"state": state, "adam": adam,
            "final_loss": float(metrics.loss) if metrics else None}


def _report_eval(tb_writer, eval_step, state, test_cams, bg, sh_degree,
                 iteration, train_cams=()):
    """Held-out L1/PSNR per config (train_static.py:176-205): the test
    views, and train views at the reference's stride-5 offsets."""
    configs = [("test", list(test_cams))]
    if train_cams:
        configs.append(("train", [train_cams[idx % len(train_cams)]
                                  for idx in range(5, 30, 5)]))
    for name, cams in configs:
        l1s, psnrs = [], []
        for cam_obj in cams:
            camera, gt = cam_obj.load()
            _, l1, p = eval_step(state, camera,
                                 torch.as_tensor(gt, device=bg.device), bg,
                                 sh_degree)
            l1s.append(float(l1))
            psnrs.append(float(p))
        if name == "test":
            print(f"\n[ITER {iteration}] Evaluating test: "
                  f"L1 {np.mean(l1s):.5f} PSNR {np.mean(psnrs):.2f}")
        if tb_writer:
            tb_writer.add_scalar(f"{name}/loss_viewpoint - l1_loss",
                                 float(np.mean(l1s)), iteration)
            tb_writer.add_scalar(f"{name}/loss_viewpoint - psnr",
                                 float(np.mean(psnrs)), iteration)


def _prepare_output_and_logger(model_cfg: ModelConfig, args):
    if not model_cfg.model_path:
        import uuid

        model_cfg.model_path = os.path.join("./output/",
                                            str(uuid.uuid4())[:10])
        args.model_path = model_cfg.model_path
    print(f"Output folder: {model_cfg.model_path}")
    save_cfg_args(model_cfg.model_path, args)
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(model_cfg.model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")
        return None


def main(argv=None):
    parser = argparse.ArgumentParser(description="Training script parameters")
    add_config_args(parser, ModelConfig())
    add_config_args(parser, OptimizationConfig())
    add_config_args(parser, PipelineConfig())
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=list(range(2_000, 30_000, 1_000)))
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=list(range(5_000, 30_000, 5_000)))
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--camera_seed", type=int, default=0,
                        help="seed for the python-random camera draw "
                             "(safe_state parity, general_utils.py:112-133)")
    parser.add_argument("--profile_iterations", nargs=2, type=int,
                        default=None)
    parser.add_argument("--replay_rng", type=str, default=None)
    parser.add_argument("--data_parallel", type=int, default=1)
    parser.add_argument("--pshard", type=int, default=1)
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    model_cfg = extract_config(args, ModelConfig)
    opt = extract_config(args, OptimizationConfig)
    pipe = extract_config(args, PipelineConfig)
    print("Optimizing " + model_cfg.model_path)
    if args.detect_anomaly or pipe.debug or args.debug_from == 0:
        torch.autograd.set_detect_anomaly(True)
    result = training(model_cfg, opt, pipe, args)
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main()
