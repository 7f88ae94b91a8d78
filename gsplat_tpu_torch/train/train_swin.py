"""Sliding-window (SwinGS) dynamic-scene training entry point (port of
gsplat_tpu/train/train_swin.py, the single-device loop).

The reference train_swin.py:275-380 / train_slide_window (:118-273): a
genesis pass over the first window, opacity-ranked lifespan staggering
(decay_genesis), then per tick: evolve (mature into the frozen ring,
stream the matured rows to disk, roll them over) and train the window;
finally mature the remainder. Frames are the reader's rebased frames.

Not in this slice of the port (each raises NotImplementedError):
--data_parallel above 1, --enable_arap, --start_checkpoint and
--checkpoint_iterations.

Usage:
  python -m gsplat_tpu_torch.train.train_swin -s <swings_dataset> -m <out> \
      --cap_max N --swin_size 10 [--deform] [--first_frame_only]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.data.scene import MAX_FRAME_IN_MEMORY, DynamicScene
from gsplat_tpu_torch.model import gaussians, optim, swin
from gsplat_tpu_torch.train import swin_step as sstep
from gsplat_tpu_torch.train.config import (ModelConfig, OptimizationConfig,
                                           PipelineConfig, add_config_args,
                                           extract_config, save_cfg_args)
from gsplat_tpu_torch.train.train_static import _chw, make_settings
from gsplat_tpu_torch.utils import debug as debug_lib
from gsplat_tpu_torch.utils.stream import SliWinManager, stream_dump


def evolve(state: swin.SwinState, adam, swin_mgr: SliWinManager,
           dump_path: str, sh_degree: int):
    """Stream the rows that cannot fill the next window to disk, then copy
    them into the ring and roll them over (gaussian_model.py:530-548)."""
    mask = swin.mature_mask(state, float(swin_mgr.frame_end))
    rows = swin.extract_rows_host(state, mask)
    n = rows["start_frame"].shape[0]
    if n:
        stream_dump(rows, dump_path, sh_degree)
        print(f"Matured {n} gaussians -> {dump_path}")
    return swin.mature_and_rollover(state, adam, mask)


def mature_rest(state: swin.SwinState, adam, dump_path: str,
                sh_degree: int):
    """Mature every remaining immature Gaussian (gaussian_model.py:
    551-555)."""
    mask = state.im.alive_mask & (state.frame_start >= 0)
    rows = swin.extract_rows_host(state, mask)
    if rows["start_frame"].shape[0]:
        stream_dump(rows, dump_path, sh_degree)
        print(f"Matured rest: {rows['start_frame'].shape[0]} gaussians")
    return swin.mature_and_rollover(state, adam, mask)


class StepBox:
    """The steps and their settings, rebuilt when the duplicate budget
    grows (every 10 iterations, as the static trainer checks). Eager
    PyTorch has nothing to recompile: a growth only changes k_dup."""

    def __init__(self, build, settings):
        self._build = build
        self.set_settings(settings)

    def set_settings(self, settings):
        self.settings = settings
        (self.train, self.densify, self.eval,
         self.grad, self.apply) = self._build(settings)

    def maybe_grow(self, num_dup: int, chunk: int) -> bool:
        """Grow the budget to 1.5x on (near-)overflow; True if it grew."""
        if num_dup <= 0.95 * self.settings.k_dup:
            return False
        if num_dup > self.settings.k_dup:
            print(f"  WARNING: duplicate budget overflowed ({num_dup} > "
                  f"{self.settings.k_dup}); recent steps trained on "
                  f"truncated tile lists")
        new_k = -(-int(num_dup * 1.5) // chunk) * chunk
        self.set_settings(dataclasses.replace(self.settings, k_dup=new_k))
        print(f"  duplicate budget -> {new_k}")
        return True


def densify_due(opt: OptimizationConfig, it: int, genesis: bool) -> bool:
    """The reference's densification condition (train_swin.py:203-242):
    from densify_from_iter during genesis, from the first iteration after
    it."""
    if it % opt.densification_interval:
        return False
    return (opt.densify_from_iter < it < opt.densify_until_iter
            or (not genesis and 0 < it < opt.densify_until_iter))


def train_slide_window(state, adam, scene: DynamicScene,
                       swin_mgr: SliWinManager, box: StepBox, model_cfg,
                       opt, args, bg, gen: torch.Generator, genesis: bool,
                       first_iter: int = 0, tb_writer=None):
    """Train the current window; returns (state, adam)."""
    total = opt.iterations
    if opt.genesis_iterations > 0 and genesis:
        total = opt.genesis_iterations
    viewpoint_stack: list = []
    device = bg.device
    # decode this window's frames and the one entering at the next tick on
    # the prefetch threads while the steps below run
    scene.prefetch_train_frames(
        list(swin_mgr.sampled_frames()) + [swin_mgr.frame_end])
    t_start = time.time()
    m = None
    for it in range(first_iter + 1, total + 1):
        if it == getattr(args, "debug_from", -1):
            torch.autograd.set_detect_anomaly(True)
            print(f"debug: anomaly detection armed at iteration {it}")
        sh_degree = (min(it // 1000, model_cfg.sh_degree) if genesis
                     else model_cfg.sh_degree)
        if not viewpoint_stack:
            viewpoint_stack = list(scene.get_train_cams_at(
                swin_mgr.sampled_frames()))
            random.shuffle(viewpoint_stack)
        cam_obj = viewpoint_stack.pop()
        camera, gt = cam_obj.load()
        gt_dev = _chw(gt, device)
        frame = float(cam_obj.frame)
        if densify_due(opt, it, genesis):
            # backward -> densify -> optimizer.step, with the Adam update
            # always skipped (see swin_step.make_swin_grad_step)
            _, m = box.grad(state, camera, gt_dev, bg, frame, sh_degree)
            state, adam = box.densify(state, adam, gen,
                                      float(swin_mgr.frame_start), genesis)
            state, adam = box.apply(state, adam, None, gen, float(it), frame,
                                    False)
        else:
            state, adam, m = box.train(state, adam, gen, camera, gt_dev, bg,
                                       float(it), frame, sh_degree)

        if it % 10 == 0:
            debug_lib.check_finite_loss(
                float(m.loss), it, model_cfg.model_path,
                params=state.params(), adam=adam,
                window=(swin_mgr.frame_start, swin_mgr.frame_end))
            num_dup = int(m.num_dup)
            args._dup_high_water = max(getattr(args, "_dup_high_water", 0),
                                       num_dup)
            if box.maybe_grow(num_dup, box.settings.chunk):
                args._dup_budget = box.settings.k_dup
            if tb_writer:
                tb_writer.add_scalar("train_loss_patches/total_loss",
                                     float(m.loss), it)

        if it % 100 == 0:
            dt = (time.time() - t_start) / 100
            t_start = time.time()
            print(f"[{swin_mgr}] it {it}: loss={float(m.loss):.5f} "
                  f"psnr={float(m.psnr):.2f} active={int(m.n_active)} "
                  f"dup={int(m.num_dup)}/{box.settings.k_dup} "
                  f"{dt * 1000:.0f}ms/it")
            if tb_writer:
                tb_writer.add_scalar("iter_time", dt * 1000, it)

        if it in args.test_iterations:
            _eval_report(state, scene, swin_mgr, box.eval, bg,
                         model_cfg.sh_degree, it, model_cfg.model_path,
                         tb_writer=tb_writer,
                         log_gt=it == min(args.test_iterations))

        if it in args.save_iterations:
            gaussians.save_ply(
                state.im, os.path.join(
                    model_cfg.model_path,
                    f"point_cloud/iteration_{it}/point_cloud.ply"))
    return state, adam


def _eval_report(state, scene, swin_mgr, eval_step, bg, sh_degree, it,
                 model_path, tb_writer=None, log_gt=False):
    """Held-out L1/PSNR over the window's test cameras; appends the
    per-frame PSNR to psnr.txt (train_swin.py:78-115)."""
    cams = scene.get_test_cams_at(swin_mgr.all_frames())
    if not cams:
        return
    psnr_per_frame: dict = {}
    l1s, psnrs = [], []
    for vi, cam_obj in enumerate(cams):
        camera, gt = cam_obj.load()
        img, l1, p = eval_step(state, camera,
                               torch.as_tensor(gt, device=bg.device), bg,
                               float(cam_obj.frame), sh_degree)
        l1s.append(float(l1))
        psnrs.append(float(p))
        psnr_per_frame.setdefault(cam_obj.frame, []).append(float(p))
        if tb_writer and vi < 5:
            tb_writer.add_image(f"test_view_{cam_obj.image_name}/render",
                                np.clip(img.cpu().numpy(), 0, 1), it,
                                dataformats="HWC")
            if log_gt:
                tb_writer.add_image(
                    f"test_view_{cam_obj.image_name}/ground_truth",
                    np.clip(gt, 0, 1), it, dataformats="HWC")
    print(f"\n[ITER {it}] Evaluating test: L1 {np.mean(l1s):.5f} "
          f"PSNR {np.mean(psnrs):.2f}")
    with open(os.path.join(model_path, "psnr.txt"), "a") as f:
        for frame, ps in sorted(psnr_per_frame.items()):
            f.write(f"\n[ITER {it} FRAME {frame}] eval test PSNR "
                    f"{np.mean(ps)}")
    if tb_writer:
        tb_writer.add_scalar("test/loss_viewpoint - l1_loss",
                             float(np.mean(l1s)), it)
        tb_writer.add_scalar("test/loss_viewpoint - psnr",
                             float(np.mean(psnrs)), it)
        alive = state.im.alive_mask

        def norm(x):
            return torch.linalg.norm(x[alive], dim=-1).cpu().numpy()

        tb_writer.add_histogram(
            "scene/opacity_histogram",
            state.im.get_opacity()[:, 0][alive].cpu().numpy(), it)
        tb_writer.add_histogram("scene/xyz_histogram", norm(state.im.xyz),
                                it)
        for k in swin.RIGID_KEYS:
            tb_writer.add_histogram(f"scene/{k}_histogram",
                                    norm(getattr(state, k)), it)
        tb_writer.add_scalar("total_points", state.im.n_alive, it)


def _unsupported(args) -> list[str]:
    """The CLI options that later slices of the port bring."""
    out = []
    if getattr(args, "data_parallel", 1) > 1:
        out.append("--data_parallel")
    for name in ("enable_arap", "start_checkpoint", "checkpoint_iterations"):
        if getattr(args, name, None):
            out.append("--" + name)
    return out


def training(model_cfg: ModelConfig, opt: OptimizationConfig,
             pipe: PipelineConfig, args) -> swin.SwinState:
    missing = _unsupported(args)
    if missing:
        raise NotImplementedError(
            f"gsplat_tpu_torch trains SwinGS on one device without ARAP or "
            f"checkpoints; {', '.join(missing)} come with later slices of "
            f"the port")
    device = get_device(model_cfg.data_device)
    os.makedirs(model_cfg.model_path, exist_ok=True)
    save_cfg_args(model_cfg.model_path, args)
    dump_path = os.path.join(model_cfg.model_path, "streamable.dat")
    if os.path.exists(dump_path):
        os.remove(dump_path)
    print(f"Streamable dump path: {dump_path}")

    scene = DynamicScene(model_cfg.source_path, model_cfg.model_path,
                         eval_split=model_cfg.eval,
                         resolution=model_cfg.resolution,
                         init_type=model_cfg.init_type,
                         num_pts=model_cfg.init_pts,
                         max_frame=model_cfg.max_frame,
                         min_frame=model_cfg.min_frame, device=device)
    try:
        return _train_windows(scene, model_cfg, opt, pipe, args, dump_path,
                              device)
    finally:
        scene.close()


def _train_windows(scene, model_cfg, opt, pipe, args, dump_path, device):
    swin_mgr = SliWinManager(args.swin_size, scene.num_frames,
                             MAX_FRAME_IN_MEMORY)
    capacity = model_cfg.cap_max
    n_init = min(scene.info.points.shape[0], capacity)
    state = swin.create_from_points(
        scene.info.points[:n_init], scene.info.colors[:n_init], capacity,
        model_cfg.sh_degree, max_lifespan=args.swin_size,
        buffer_size=capacity, deform=args.deform, device=device)
    adam = optim.init(state.params())

    # the union table has 2 x capacity rows
    settings = make_settings(pipe, 2 * capacity)
    args._dup_high_water = 0
    args._dup_budget = settings.k_dup

    def build_steps(s):
        return (sstep.make_swin_train_step(opt, s, scene.cameras_extent),
                sstep.make_swin_densify_step(capacity, args.swin_size),
                sstep.make_swin_eval_step(s),
                sstep.make_swin_grad_step(opt, s, scene.cameras_extent),
                sstep.make_swin_apply_step(opt, scene.cameras_extent))

    box = StepBox(build_steps, settings)
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(model_cfg.model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")
        tb_writer = None
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    genesis = swin_mgr.frame_start == 0
    state, adam = train_slide_window(state, adam, scene, swin_mgr, box,
                                     model_cfg, opt, args, bg, gen,
                                     genesis=genesis, tb_writer=tb_writer)
    if args.first_frame_only:
        state, adam = mature_rest(state, adam, dump_path,
                                  model_cfg.sh_degree)
        return state
    if genesis:
        state = swin.decay_genesis(state)
    swin_mgr.tick()

    while swin_mgr.frame_end <= swin_mgr.max_frame:
        state, adam = evolve(state, adam, swin_mgr, dump_path,
                             model_cfg.sh_degree)
        state, adam = train_slide_window(state, adam, scene, swin_mgr, box,
                                         model_cfg, opt, args, bg, gen,
                                         genesis=False, tb_writer=tb_writer)
        print(f"retiring frame #{swin_mgr.frame_start}")
        swin_mgr.tick()

    state, adam = mature_rest(state, adam, dump_path, model_cfg.sh_degree)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description="SwinGS training parameters")
    add_config_args(parser, ModelConfig())
    add_config_args(parser, OptimizationConfig())
    add_config_args(parser, PipelineConfig())
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[1000, 5000, 10000, 15000, 20000, 25000,
                                 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--swin_size", type=int, default=10)
    parser.add_argument("--first_frame_only", action="store_true")
    parser.add_argument("--deform", action="store_true")
    parser.add_argument("--enable_arap", action="store_true",
                        help="ARAP rigidity regulariser (not in the port "
                             "yet)")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="camera-batch data parallelism (not in the "
                             "port yet)")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    random.seed(314159)
    model_cfg = extract_config(args, ModelConfig)
    opt = extract_config(args, OptimizationConfig)
    pipe = extract_config(args, PipelineConfig)
    print("Optimizing " + model_cfg.model_path)
    if args.detect_anomaly or pipe.debug or args.debug_from == 0:
        torch.autograd.set_detect_anomaly(True)
    state = training(model_cfg, opt, pipe, args)
    print("\nTraining complete.")
    return state


if __name__ == "__main__":
    main()
