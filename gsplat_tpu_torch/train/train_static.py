"""Static 3DGS-MCMC training entry point (port of
gsplat_tpu/train/train_static.py).

CLI and behaviour mirror the reference train_static.py:212-243 /
training() (:36-144): a random camera per iteration (python ``random``,
seeded by --camera_seed as the reference's safe_state does), L1 + SSIM
loss with opacity/scale regularisers, covariance-shaped noise, MCMC
relocation + capped growth every densification_interval (the split
grad -> densify -> Adam -> noise order on those iterations), the adaptive
duplicate budget, periodic PSNR eval, PLY saves, and:

- checkpoints (--checkpoint_iterations, --start_checkpoint; the JAX
  package's .npz layout, utils/checkpoint.py). The random streams are not
  saved (neither JAX nor the reference saves them), so a resumed run
  retraces an uninterrupted one only under --replay_rng;
- RNG replay (--replay_rng, train/replay.py): cameras by name, the noise
  and the densification draws from a recorded schedule, the losses to
  parity_ours.json;
- a torch.profiler trace over [a, b) (--profile_iterations a b) into
  <model_path>/profile;
- SwinGS datasets: one static model of frame --frame;
- --data_parallel N (one camera per rank, gradients averaged), --pshard N
  (the Gaussian rows sharded over N ranks, depth-slab compositing) and the
  two together (an N_dp x N_ps job, ps minor), on torch.distributed. The
  command starts its ranks itself, or runs as one rank under torchrun;
  only rank 0 writes files.

Usage:
  python -m gsplat_tpu_torch.train.train_static -s <dataset> -m <out> \
      --cap_max N [--data_parallel N] [--pshard N]
  torchrun --nproc_per_node 2 -m gsplat_tpu_torch.train.train_static \
      -s <dataset> -m <out> --cap_max N --data_parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import random
import sys
import time

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.data.readers import detect_scene_type
from gsplat_tpu_torch.data.scene import DynamicScene, Scene
from gsplat_tpu_torch.model import gaussians, optim
from gsplat_tpu_torch.parallel import launch
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.dp import make_dp_train_step, own_sample
from gsplat_tpu_torch.parallel.pshard import make_pshard_train_step
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import step as step_lib
from gsplat_tpu_torch.train.replay import ReplaySchedule
from gsplat_tpu_torch.train.config import (ModelConfig, OptimizationConfig,
                                           PipelineConfig, add_config_args,
                                           auto_dup_budget, extract_config,
                                           save_cfg_args)
from gsplat_tpu_torch.utils import checkpoint as ckpt_lib
from gsplat_tpu_torch.utils import debug as debug_lib
from gsplat_tpu_torch.utils import profiling


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


def _chw(gt: np.ndarray, device) -> torch.Tensor:
    """Host [H, W, 3] image -> [3, H, W] on the device (the steps run
    channel-first)."""
    return torch.as_tensor(np.ascontiguousarray(gt.transpose(2, 0, 1)),
                           device=device)


def training(model_cfg: ModelConfig, opt: OptimizationConfig,
             pipe: PipelineConfig, args) -> dict:
    """Train; with --data_parallel / --pshard above 1 on that many ranks
    (parallel/launch.py), returning rank 0's result."""
    if model_cfg.cap_max == -1:
        print("Please specify the maximum number of Gaussians with --cap_max.")
        sys.exit(1)
    n_dp = getattr(args, "data_parallel", 1)
    n_ps = getattr(args, "pshard", 1)
    if n_dp == 1 and n_ps == 1:
        return _training(model_cfg, opt, pipe, args, None)
    if n_ps > 1 and model_cfg.cap_max % n_ps:
        raise ValueError(f"--cap_max {model_cfg.cap_max} must be divisible "
                         f"by --pshard {n_ps} (the Gaussian axis is sharded "
                         f"evenly)")
    if getattr(args, "replay_rng", None):
        raise ValueError("--replay_rng replays a single-device schedule; it "
                         "does not combine with --data_parallel / --pshard")
    _default_model_path(model_cfg, args)
    return launch.run(_rank_training, n_dp * n_ps, model_cfg.data_device,
                      (model_cfg, opt, pipe, args))


def _rank_training(model_cfg, opt, pipe, args) -> dict:
    """One rank of a --data_parallel / --pshard job."""
    n_dp, n_ps = args.data_parallel, args.pshard
    device = launch.rank_device(model_cfg.data_device,
                                torch.distributed.get_rank(),
                                torch.distributed.get_backend())
    if n_ps > 1 and n_dp > 1:
        mesh = mesh_lib.make_mesh_2d(n_dp, n_ps, device=device)
        print(f"2-D dp x ps training over {n_dp}x{n_ps} ranks")
    elif n_ps > 1:
        mesh = mesh_lib.make_mesh(n_ps, axis_name="ps", device=device)
        print(f"P-sharded (Gaussian-axis) training over {n_ps} ranks")
    else:
        mesh = mesh_lib.make_mesh(n_dp, device=device)
        print(f"data-parallel training over {n_dp} ranks")
    return _training(model_cfg, opt, pipe, args, mesh)


def _load_scene(model_cfg: ModelConfig, args, device, model_path: str):
    """(scene, train cameras, test cameras, points, colors, extent); a
    SwinGS video trains one frame (--frame), as the reference's static
    trainer reads a frame window."""
    if detect_scene_type(model_cfg.source_path) == "SwinGS":
        dyn = DynamicScene(model_cfg.source_path, model_path,
                           eval_split=model_cfg.eval,
                           resolution=model_cfg.resolution,
                           init_type=model_cfg.init_type,
                           num_pts=model_cfg.init_pts,
                           max_frame=model_cfg.max_frame,
                           min_frame=model_cfg.min_frame, device=device)
        return (dyn, dyn.get_train_cams_at([args.frame]),
                dyn.get_test_cams_at([args.frame]), dyn.info.points,
                dyn.info.colors, dyn.cameras_extent)
    scene = Scene(model_cfg.source_path, model_path,
                  images=model_cfg.images, eval_split=model_cfg.eval,
                  resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  init_type=model_cfg.init_type, num_pts=model_cfg.init_pts,
                  device=device)
    return (scene, scene.train_cameras, scene.test_cameras,
            scene.info.points, scene.info.colors, scene.cameras_extent)


def _training(model_cfg: ModelConfig, opt: OptimizationConfig,
              pipe: PipelineConfig, args, mesh) -> dict:
    device = get_device(model_cfg.data_device) if mesh is None \
        else mesh.device
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    # safe_state parity (general_utils.py:112-133): seed the camera draw,
    # the same stream on every rank
    random.seed(getattr(args, "camera_seed", 0))
    tb_writer = _prepare_output_and_logger(model_cfg, args) if rank0 \
        else None
    # only rank 0 writes into the model directory; the readers may write a
    # PLY beside the dataset, so ranks read it one after another
    def load():
        return _load_scene(model_cfg, args, device,
                           model_cfg.model_path if rank0 else "")

    loaded = load() if mesh is None else mesh_lib.in_turn(load)
    scene = loaded[0]
    try:
        return _train_loop(model_cfg, opt, pipe, args, mesh, device, rank0,
                           tb_writer, *loaded)
    finally:
        if isinstance(scene, DynamicScene):
            scene.close()


def _train_loop(model_cfg, opt, pipe, args, mesh, device, rank0, tb_writer,
                scene, train_cams, test_cams, points, colors,
                cameras_extent) -> dict:
    n_dp = getattr(args, "data_parallel", 1)
    n_ps = getattr(args, "pshard", 1)
    capacity = model_cfg.cap_max
    n_init = min(points.shape[0], capacity)
    state = gaussians.create_from_points(points[:n_init], colors[:n_init],
                                         capacity, model_cfg.sh_degree,
                                         device=device)
    if mesh is not None:
        # the replicated state starts from rank 0's (a random init draws
        # from each process's own numpy stream)
        mesh_lib.sync_replicas(mesh, tuple(mesh.axes), state)
    adam = optim.init(state.params())

    first_iter = 0
    if args.start_checkpoint:
        state, adam, first_iter, _ = ckpt_lib.load(args.start_checkpoint,
                                                   device)
        print(f"restored checkpoint at iteration {first_iter}")

    settings = make_settings(pipe, capacity)
    replay = None
    if getattr(args, "replay_rng", None):
        replay = ReplaySchedule(args.replay_rng, capacity)
        print(f"replaying recorded RNG schedule from {args.replay_rng} "
              f"({replay.iterations} iterations, {replay.num_densify} "
              f"densify events)")
    single = mesh is None

    def build_steps(s):
        if n_ps > 1:
            ps_steps = {}

            def train_step(sh):
                if sh not in ps_steps:
                    ps_steps[sh] = make_pshard_train_step(
                        mesh, opt, s, cameras_extent, sh,
                        dp_axis="dp" if n_dp > 1 else None)
                return ps_steps[sh]
        elif n_dp > 1:
            train_step = make_dp_train_step(mesh, opt, s, cameras_extent)
        else:
            train_step = step_lib.make_train_step(opt, s, cameras_extent)
        return (train_step, step_lib.make_grad_step(opt, s, cameras_extent),
                step_lib.make_eval_step(s))

    train_step, grad_step, eval_step = build_steps(settings)
    # the split grad -> densify -> Adam -> noise order on densification
    # iterations (and every iteration of a replay) is the single-device
    # path's; dp and pshard keep the fused step and densify after it, a
    # documented ordering deviation at densify iterations
    apply_step = step_lib.make_apply_step(
        opt, cameras_extent, external_noise=replay is not None)
    densify_step = step_lib.make_densify_step(capacity)
    densify_replay_step = step_lib.make_densify_replay_step()

    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ps_params = ps_adam = noise_gen = None
    if n_ps > 1:
        # this rank's rows; the shard's noise stream depends on its ps
        # index alone, so the dp rows of a 2-D job agree
        ps_params = {k: mesh_lib.shard_rows(v, mesh, "ps")
                     for k, v in state.params().items()}
        ps_adam = _shard_adam(adam, mesh)
        noise_gen = torch.Generator(device=device)
        noise_gen.manual_seed(1 + mesh.axis_index("ps"))

    def sync_state():
        """The whole model and Adam state from the shards (a collective:
        every rank calls it)."""
        full = mesh_lib.gather_rows(ps_params, mesh, "ps")
        return state.replace_params(full), _gather_adam(ps_adam, mesh)

    profile_range = getattr(args, "profile_iterations", None) or ()
    tracer = None
    replay_losses: list = []
    cams_by_name = {}
    if replay is not None:
        for c in train_cams:
            if c.image_name in cams_by_name:
                raise ValueError(f"duplicate camera name {c.image_name}: "
                                 f"replay needs unique image names")
            cams_by_name[c.image_name] = c
    viewpoint_stack: list = []

    def draw():
        nonlocal viewpoint_stack
        if not viewpoint_stack:
            viewpoint_stack = list(train_cams)
        return viewpoint_stack.pop(random.randint(0,
                                                  len(viewpoint_stack) - 1))

    ema_loss = 0.0
    dup_peak, dup_tightened = 0, False
    metrics = None
    camera = None
    t_start = time.time()
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if iteration == getattr(args, "debug_from", -1):
            torch.autograd.set_detect_anomaly(True)
            print(f"debug: anomaly detection armed at iteration {iteration}")
        if rank0 and profile_range and iteration == profile_range[0]:
            tracer = profiling.Trace(os.path.join(model_cfg.model_path,
                                                  "profile"))
            tracer.start()
        if tracer is not None and iteration == profile_range[-1]:
            print(f"profile trace -> {tracer.stop()}")
            tracer = None
        with profiling.span("train.step"):
            sh_degree = min(iteration // 1000, model_cfg.sh_degree)
            step_bg = (torch.rand(3, generator=gen, device=device)
                       if opt.random_background else bg)
            densify_now = (opt.densify_from_iter < iteration
                           < opt.densify_until_iter
                           and iteration % opt.densification_interval == 0)
            if not single:
                # every rank draws the whole batch in the same order and
                # takes the camera at its own dp index
                if n_dp > 1:
                    cam_obj = own_sample([draw() for _ in range(n_dp)],
                                         mesh)
                else:
                    cam_obj = draw()
                camera, gt = cam_obj.load()
                gt_dev = _chw(gt, device)
                if n_ps > 1:
                    ps_params, ps_adam, metrics = train_step(sh_degree)(
                        ps_params,
                        mesh_lib.shard_rows(state.alive_mask, mesh, "ps"),
                        ps_adam, noise_gen, camera, gt_dev, step_bg,
                        float(iteration), state.n_alive)
                else:
                    state, adam, metrics = train_step(
                        state, adam, gen, camera, gt_dev, step_bg,
                        float(iteration), sh_degree)
                if densify_now:
                    if n_ps > 1:
                        # densification runs on the gathered state, the
                        # same draws on every rank; the rows reshard after it
                        state, adam = sync_state()
                        state, adam = densify_step(state, adam, gen)
                        ps_params = {k: mesh_lib.shard_rows(v, mesh, "ps")
                                     for k, v in state.params().items()}
                        ps_adam = _shard_adam(adam, mesh)
                    else:
                        state, adam = densify_step(state, adam, gen)
            else:
                if replay is not None:
                    cam_obj = cams_by_name[replay.camera_name(iteration)]
                else:
                    cam_obj = draw()
                camera, gt = cam_obj.load()
                gt_dev = _chw(gt, device)
                if replay is not None or densify_now:
                    # reference interleave: backward -> densify -> Adam ->
                    # noise
                    grads, metrics = grad_step(state, camera, gt_dev,
                                               step_bg, sh_degree)
                    surgery = False
                    if densify_now:
                        if (replay is not None
                                and replay.has_densify(iteration)):
                            dm, rt, at_, target = replay.densify_arrays(
                                iteration, state=state)
                            surgery = (bool(dm.any())
                                       or target > state.n_alive)
                            state, adam = densify_replay_step(
                                state, adam,
                                torch.as_tensor(dm, device=device),
                                torch.as_tensor(rt, device=device),
                                torch.as_tensor(at_, device=device), target)
                        else:
                            # did relocation or growth touch the model?
                            # (the reference's grad=None Adam skip,
                            # make_apply_step)
                            n = state.n_alive
                            dead_any = bool((state.alive_mask & (
                                state.get_opacity()[:, 0] <= 0.005)).any())
                            surgery = dead_any or min(capacity,
                                                      int(1.05 * n)) > n
                            state, adam = densify_step(state, adam, gen)
                    extra = ((torch.as_tensor(replay.noise(iteration),
                                              device=device),)
                             if replay is not None else ())
                    state, adam = apply_step(state, adam, grads, gen,
                                             float(iteration), not surgery,
                                             *extra)
                else:
                    state, adam, metrics = train_step(state, adam, gen, camera,
                                                      gt_dev, step_bg,
                                                      float(iteration),
                                                      sh_degree)
                if replay is not None:
                    replay_losses.append((iteration, float(metrics.l1),
                                          float(metrics.loss)))

        if iteration % 10 == 0:
            # the metrics are reduced over the ranks, so every rank sees
            # the same loss and duplicate count and rebuilds k_dup with
            # the others
            loss = float(metrics.loss)
            if rank0:
                debug_lib.check_finite_loss(
                    loss, iteration, model_cfg.model_path,
                    params=state.params() if n_ps == 1 else ps_params,
                    adam=adam if n_ps == 1 else ps_adam,
                    camera=camera)
            elif not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss ({loss}) at iteration "
                                   f"{iteration}")
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
            dt = (time.time() - t_start) / min(iteration - first_iter, 100)
            t_start = time.time()
            print(f"[ITER {iteration}] loss={float(metrics.loss):.5f} "
                  f"ema={ema_loss:.5f} psnr={float(metrics.psnr):.2f} "
                  f"n={state.n_alive} dup={int(metrics.num_dup)}/"
                  f"{settings.k_dup} {dt * 1000:.1f}ms/it")
            if tb_writer:
                tb_writer.add_scalar("iter_time", dt * 1000, iteration)
                tb_writer.add_scalar("total_points", state.n_alive,
                                     iteration)

        if n_ps > 1 and (iteration in args.test_iterations
                         or iteration in args.save_iterations
                         or iteration in args.checkpoint_iterations):
            state, adam = sync_state()
        if rank0 and iteration in args.test_iterations and test_cams:
            _report_eval(tb_writer, eval_step, state, test_cams, bg,
                         sh_degree, iteration, train_cams=train_cams)
        if rank0 and iteration in args.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            gaussians.save_ply(state, scene.point_cloud_path(iteration))
        if rank0 and iteration in args.checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            ckpt_lib.save(os.path.join(model_cfg.model_path,
                                       f"chkpnt{iteration}.npz"),
                          state, adam, iteration)

    if tracer is not None:
        print(f"profile trace -> {tracer.stop()}")
    if n_ps > 1:
        state, adam = sync_state()
    if replay is not None:
        out = os.path.join(model_cfg.model_path, "parity_ours.json")
        with open(out, "w") as f:
            json.dump({"losses": replay_losses,
                       "densify_diagnostics": replay.diagnostics,
                       "iterations": opt.iterations}, f)
        print(f"wrote {out} ({len(replay_losses)} loss samples)")
    return {"state": state, "adam": adam,
            "final_loss": float(metrics.loss) if metrics else None}


def _shard_adam(adam: optim.AdamState, mesh) -> optim.AdamState:
    def shard(d):
        return {k: mesh_lib.shard_rows(v, mesh, "ps") for k, v in d.items()}

    return optim.AdamState(mu=shard(adam.mu), nu=shard(adam.nu),
                           count=adam.count)


def _gather_adam(adam: optim.AdamState, mesh) -> optim.AdamState:
    return optim.AdamState(mu=mesh_lib.gather_rows(adam.mu, mesh, "ps"),
                           nu=mesh_lib.gather_rows(adam.nu, mesh, "ps"),
                           count=adam.count)


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


def _default_model_path(model_cfg: ModelConfig, args) -> None:
    if not model_cfg.model_path:
        import uuid

        model_cfg.model_path = os.path.join("./output/",
                                            str(uuid.uuid4())[:10])
        args.model_path = model_cfg.model_path


def _prepare_output_and_logger(model_cfg: ModelConfig, args):
    _default_model_path(model_cfg, args)
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
                        default=None,
                        help="capture a torch.profiler trace over [a, b)")
    parser.add_argument("--replay_rng", type=str, default=None,
                        help="replay a recorded RNG schedule (camera order, "
                             "densify draws, noise); see "
                             "gsplat_tpu_torch/train/replay.py")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="train over N ranks, one camera each per step "
                             "(gradients averaged over the ranks)")
    parser.add_argument("--pshard", type=int, default=1,
                        help="shard the Gaussian rows over N ranks: each "
                             "rasterizes its depth slab, Adam state never "
                             "leaves the shard")
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
