"""Sliding-window (SwinGS) dynamic-scene training entry point (port of
gsplat_tpu/train/train_swin.py).

The reference train_swin.py:275-380 / train_slide_window (:118-273): a
genesis pass over the first window, opacity-ranked lifespan staggering
(decay_genesis), then per tick: evolve (mature into the frozen ring,
stream the matured rows to disk, roll them over) and train the window;
finally mature the remainder. Frames are the reader's rebased frames.
Also:

- checkpoints of the whole SwinState, its Adam state and the window
  (--checkpoint_iterations -> chkpnt_<frame_start>_<it>.npz in the JAX
  package's pytree layout, --start_checkpoint);
- --enable_arap: the ARAP rigidity regulariser over the immature k-NN
  graph (rebuilt every densification_interval), with the fused step kept
  on densification iterations, as the JAX trainer does;
- --data_parallel N: one window (camera, frame) sample per rank,
  gradients averaged (parallel/swin_dp.py); the command starts its ranks
  itself or runs as one rank under torchrun, and only rank 0 writes files.

Usage:
  python -m gsplat_tpu_torch.train.train_swin -s <swings_dataset> -m <out> \
      --cap_max N --swin_size 10 [--deform] [--first_frame_only] \
      [--enable_arap] [--data_parallel N]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import random
import time

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.data.scene import MAX_FRAME_IN_MEMORY, DynamicScene
from gsplat_tpu_torch.model import gaussians, optim, swin
from gsplat_tpu_torch.model.knn import knn_indices
from gsplat_tpu_torch.parallel import launch
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.dp import own_sample
from gsplat_tpu_torch.parallel.swin_dp import make_dp_swin_train_step
from gsplat_tpu_torch.train import swin_step as sstep
from gsplat_tpu_torch.train.config import (ModelConfig, OptimizationConfig,
                                           PipelineConfig, add_config_args,
                                           extract_config, save_cfg_args)
from gsplat_tpu_torch.train.train_static import _chw, make_settings
from gsplat_tpu_torch.utils import checkpoint as ckpt_lib
from gsplat_tpu_torch.utils import debug as debug_lib
from gsplat_tpu_torch.utils.profiling import span
from gsplat_tpu_torch.utils.stream import SliWinManager, stream_dump


def evolve(state: swin.SwinState, adam, swin_mgr: SliWinManager,
           dump_path: str | None, sh_degree: int):
    """Stream the rows that cannot fill the next window to disk (unless
    ``dump_path`` is None: ranks other than 0), then copy them into the
    ring and roll them over (gaussian_model.py:530-548)."""
    with span("swin.slide"):
        mask = swin.mature_mask(state, float(swin_mgr.frame_end))
        if dump_path is not None:
            rows = swin.extract_rows_host(state, mask)
            n = rows["start_frame"].shape[0]
            if n:
                stream_dump(rows, dump_path, sh_degree)
                print(f"Matured {n} gaussians -> {dump_path}")
        return swin.mature_and_rollover(state, adam, mask)


def mature_rest(state: swin.SwinState, adam, dump_path: str | None,
                sh_degree: int):
    """Mature every remaining immature Gaussian (gaussian_model.py:
    551-555)."""
    with span("swin.slide"):
        mask = state.im.alive_mask & (state.frame_start >= 0)
        if dump_path is not None:
            rows = swin.extract_rows_host(state, mask)
            n = rows["start_frame"].shape[0]
            if n:
                stream_dump(rows, dump_path, sh_degree)
                print(f"Matured rest: {n} gaussians")
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
                       first_iter: int = 0, tb_writer=None, mesh=None):
    """Train the current window; returns (state, adam). With ``mesh`` this
    is one rank of a --data_parallel job."""
    total = opt.iterations
    if opt.genesis_iterations > 0 and genesis:
        total = opt.genesis_iterations
    viewpoint_stack: list = []
    device = bg.device
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    n_dp = 1 if mesh is None else mesh.shape["dp"]
    enable_arap = getattr(args, "enable_arap", False) and mesh is None
    nbr_indices = None
    # decode this window's frames and the one entering at the next tick on
    # the prefetch threads while the steps below run
    scene.prefetch_train_frames(
        list(swin_mgr.sampled_frames()) + [swin_mgr.frame_end])

    def draw():
        nonlocal viewpoint_stack
        if not viewpoint_stack:
            viewpoint_stack = list(scene.get_train_cams_at(
                swin_mgr.sampled_frames()))
            random.shuffle(viewpoint_stack)
        return viewpoint_stack.pop()

    t_start = time.time()
    m = None
    for it in range(first_iter + 1, total + 1):
        if it == getattr(args, "debug_from", -1):
            torch.autograd.set_detect_anomaly(True)
            print(f"debug: anomaly detection armed at iteration {it}")
        with span("train.step"):
            sh_degree = (min(it // 1000, model_cfg.sh_degree) if genesis
                         else model_cfg.sh_degree)
            if enable_arap and (nbr_indices is None
                                or it % opt.densification_interval == 0):
                nbr_indices = knn_indices(state.im.xyz, k=20)[1]
            densify_now = densify_due(opt, it, genesis)
            if mesh is not None:
                # every rank draws the whole batch in the same order and takes
                # its own sample; the noise gates on the first sample's frame
                batch = [draw() for _ in range(n_dp)]
                cam_obj = own_sample(batch, mesh)
                camera, gt = cam_obj.load()
                state, adam, m = box.train(
                    state, adam, gen, camera, _chw(gt, device),
                    float(cam_obj.frame), float(batch[0].frame), bg, float(it),
                    sh_degree)
                if densify_now:
                    state, adam = box.densify(state, adam, gen,
                                              float(swin_mgr.frame_start),
                                              genesis)
            else:
                cam_obj = draw()
                camera, gt = cam_obj.load()
                gt_dev = _chw(gt, device)
                frame = float(cam_obj.frame)
                if densify_now and not enable_arap:
                    # backward -> densify -> optimizer.step, with the Adam
                    # update always skipped (see swin_step.make_swin_grad_step)
                    _, m = box.grad(state, camera, gt_dev, bg, frame,
                                    sh_degree)
                    state, adam = box.densify(state, adam, gen,
                                              float(swin_mgr.frame_start),
                                              genesis)
                    state, adam = box.apply(state, adam, None, gen, float(it),
                                            frame, False)
                else:
                    state, adam, m = box.train(state, adam, gen, camera,
                                               gt_dev, bg, float(it), frame,
                                               sh_degree,
                                               nbr_indices=nbr_indices)
                    if densify_now:
                        # ARAP keeps the fused step (the split step has no
                        # ARAP term; the reference ships ARAP gated off)
                        state, adam = box.densify(state, adam, gen,
                                                  float(swin_mgr.frame_start),
                                                  genesis)

        if it % 10 == 0:
            # the metrics are reduced over the ranks (num_dup by MAX), so
            # every rank grows the budget with the others
            loss = float(m.loss)
            if rank0:
                debug_lib.check_finite_loss(
                    loss, it, model_cfg.model_path, params=state.params(),
                    adam=adam,
                    window=(swin_mgr.frame_start, swin_mgr.frame_end))
            elif not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss ({loss}) at iteration "
                                   f"{it}")
            num_dup = int(m.num_dup)
            args._dup_high_water = max(getattr(args, "_dup_high_water", 0),
                                       num_dup)
            if box.maybe_grow(num_dup, box.settings.chunk):
                args._dup_budget = box.settings.k_dup
            if tb_writer:
                tb_writer.add_scalar("train_loss_patches/total_loss", loss,
                                     it)

        if it % 100 == 0:
            dt = (time.time() - t_start) / 100
            t_start = time.time()
            print(f"[{swin_mgr}] it {it}: loss={float(m.loss):.5f} "
                  f"psnr={float(m.psnr):.2f} active={int(m.n_active)} "
                  f"dup={int(m.num_dup)}/{box.settings.k_dup} "
                  f"{dt * 1000:.0f}ms/it")
            if tb_writer:
                tb_writer.add_scalar("iter_time", dt * 1000, it)

        if rank0 and it in args.test_iterations:
            _eval_report(state, scene, swin_mgr, box.eval, bg,
                         model_cfg.sh_degree, it, model_cfg.model_path,
                         tb_writer=tb_writer,
                         log_gt=it == min(args.test_iterations))

        if rank0 and it in args.save_iterations:
            gaussians.save_ply(
                state.im, os.path.join(
                    model_cfg.model_path,
                    f"point_cloud/iteration_{it}/point_cloud.ply"))

        if rank0 and it in args.checkpoint_iterations:
            path = os.path.join(model_cfg.model_path,
                                f"chkpnt_{swin_mgr.frame_start}_{it}.npz")
            ckpt_lib.save_pytree(path, {"state": state, "adam": adam},
                                 meta={"iteration": it,
                                       "swin": swin_mgr.state_dump()})
            print(f"saved checkpoint {path}")
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


def training(model_cfg: ModelConfig, opt: OptimizationConfig,
             pipe: PipelineConfig, args) -> swin.SwinState:
    """Train; with --data_parallel above 1 on that many ranks
    (parallel/launch.py), returning rank 0's state."""
    n_dp = getattr(args, "data_parallel", 1)
    if n_dp == 1:
        return _training(model_cfg, opt, pipe, args, None)
    return launch.run(_rank_training, n_dp, model_cfg.data_device,
                      (model_cfg, opt, pipe, args))


def _rank_training(model_cfg, opt, pipe, args) -> swin.SwinState:
    """One rank of a --data_parallel job."""
    device = launch.rank_device(model_cfg.data_device,
                                torch.distributed.get_rank(),
                                torch.distributed.get_backend())
    mesh = mesh_lib.make_mesh(args.data_parallel, device=device)
    print(f"data-parallel SwinGS training over {args.data_parallel} ranks")
    return _training(model_cfg, opt, pipe, args, mesh)


def _training(model_cfg, opt, pipe, args, mesh) -> swin.SwinState:
    device = get_device(model_cfg.data_device) if mesh is None \
        else mesh.device
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    dump_path = os.path.join(model_cfg.model_path, "streamable.dat")
    if rank0:
        os.makedirs(model_cfg.model_path, exist_ok=True)
        save_cfg_args(model_cfg.model_path, args)
        if os.path.exists(dump_path):
            os.remove(dump_path)
        print(f"Streamable dump path: {dump_path}")

    def load():
        return DynamicScene(model_cfg.source_path,
                            model_cfg.model_path if rank0 else "",
                            eval_split=model_cfg.eval,
                            resolution=model_cfg.resolution,
                            init_type=model_cfg.init_type,
                            num_pts=model_cfg.init_pts,
                            max_frame=model_cfg.max_frame,
                            min_frame=model_cfg.min_frame, device=device)

    # the reader may write a PLY beside the dataset: ranks read in turn
    scene = load() if mesh is None else mesh_lib.in_turn(load)
    try:
        return _train_windows(scene, model_cfg, opt, pipe, args,
                              dump_path if rank0 else None, device, mesh)
    finally:
        scene.close()


def _train_windows(scene, model_cfg, opt, pipe, args, dump_path, device,
                   mesh):
    swin_mgr = SliWinManager(args.swin_size, scene.num_frames,
                             MAX_FRAME_IN_MEMORY)
    capacity = model_cfg.cap_max
    n_init = min(scene.info.points.shape[0], capacity)
    state = swin.create_from_points(
        scene.info.points[:n_init], scene.info.colors[:n_init], capacity,
        model_cfg.sh_degree, max_lifespan=args.swin_size,
        buffer_size=capacity, deform=args.deform, device=device)
    if mesh is not None:
        # the replicated state starts from rank 0's (a random init draws
        # from each process's own numpy stream)
        mesh_lib.sync_replicas(mesh, ("dp",), state)
    adam = optim.init(state.params())

    first_iter = 0
    if args.start_checkpoint:
        tree, meta = ckpt_lib.load_pytree(args.start_checkpoint,
                                          {"state": state, "adam": adam})
        state, adam = tree["state"], tree["adam"]
        swin_mgr.state_load(meta["swin"])
        first_iter = meta["iteration"]
        print(f"Checkpoint {first_iter} of {swin_mgr} loaded")

    # the union table has 2 x capacity rows
    settings = make_settings(pipe, 2 * capacity)
    args._dup_high_water = 0
    args._dup_budget = settings.k_dup
    arap_w = (0.1, 0.1, 0.1) if getattr(args, "enable_arap", False) \
        else None

    def build_steps(s):
        if mesh is not None:
            step = make_dp_swin_train_step(mesh, opt, s,
                                           scene.cameras_extent)
        else:
            step = sstep.make_swin_train_step(opt, s, scene.cameras_extent,
                                              arap_weights=arap_w)
        densify = sstep.make_swin_densify_step(capacity, args.swin_size)
        return (step, densify, sstep.make_swin_eval_step(s),
                sstep.make_swin_grad_step(opt, s, scene.cameras_extent),
                sstep.make_swin_apply_step(opt, scene.cameras_extent))

    box = StepBox(build_steps, settings)
    tb_writer = None
    if dump_path is not None:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(model_cfg.model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    genesis = swin_mgr.frame_start == 0
    state, adam = train_slide_window(state, adam, scene, swin_mgr, box,
                                     model_cfg, opt, args, bg, gen,
                                     genesis=genesis, first_iter=first_iter,
                                     tb_writer=tb_writer, mesh=mesh)
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
                                         genesis=False, tb_writer=tb_writer,
                                         mesh=mesh)
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
                        help="ARAP rigidity regulariser over the immature "
                             "k-NN graph (the reference ships it gated off)")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="camera-batch data parallelism: one window "
                             "(camera, frame) sample per rank, gradients "
                             "averaged over the ranks")
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
