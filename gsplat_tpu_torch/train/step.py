"""Training steps for static 3DGS-MCMC (port of gsplat_tpu/train/step.py).

Plain functions on tensors, run eagerly: render -> loss -> autograd ->
Adam -> noise injection, the reference hot loop train_static.py:63-144.
The loss is rendered channel-first ([3, H, W]); ``gt_image`` arrives CHW.
On densification iterations the trainer splits the step as the reference
orders it (backward -> densify -> Adam -> noise): ``make_grad_step``, then
``make_densify_step``, then ``make_apply_step``.

Where JAX takes a PRNG key, these take a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.core.schedule import expon_lr
from gsplat_tpu_torch.model import mcmc, optim
from gsplat_tpu_torch.model.gaussians import GaussianState
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize
from gsplat_tpu_torch.train import losses
from gsplat_tpu_torch.train.config import OptimizationConfig
from gsplat_tpu_torch.utils.profiling import span


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_dup: torch.Tensor
    psnr: torch.Tensor


def masked_mean(x, mask, count):
    """Mean over the masked rows only (the reference's .mean() runs over
    tensors that hold exactly those rows). ``count`` is the number of
    masked rows, a host int or a tensor (then counted on the device)."""
    per_row = torch.mean(x, dim=tuple(range(1, x.dim()))) if x.dim() > 1 \
        else x
    total = torch.sum(torch.where(mask, per_row, torch.zeros_like(per_row)))
    if isinstance(count, torch.Tensor):
        return total / torch.clamp(count.to(total.dtype), min=1.0)
    return total / max(count, 1)


def learning_rates(opt: OptimizationConfig, spatial_lr_scale: float,
                   iteration: float):
    """(xyz_lr, per-group learning rates) at ``iteration``."""
    xyz_lr = expon_lr(iteration, opt.position_lr_init * spatial_lr_scale,
                      opt.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt.position_lr_delay_mult,
                      max_steps=opt.position_lr_max_steps)
    return xyz_lr, {"xyz": xyz_lr, "f_dc": opt.feature_lr,
                    "f_rest": opt.feature_lr / 20.0,
                    "opacity": opt.opacity_lr, "scaling": opt.scaling_lr,
                    "rotation": opt.rotation_lr}


def _loss_and_grads(opt: OptimizationConfig, settings: RasterizeSettings,
                    state: GaussianState, camera: CameraParams, gt_image, bg,
                    sh_degree: int):
    """(grads keyed like ``state.params()``, StepMetrics)."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params().items()}
    s = state.replace_params(params)
    alive = s.alive_mask
    with span("train.loss"):
        out = rasterize(s.xyz, s.get_scaling(), s.get_rotation(),
                        s.get_opacity()[:, 0], s.get_features(), camera,
                        sh_degree, bg, settings, alive=alive)
        img = out.image
        ll1 = losses.l1_loss(img, gt_image)
        lssim = losses.ssim(img, gt_image)
        loss = ((1.0 - opt.lambda_dssim) * ll1
                + opt.lambda_dssim * (1.0 - lssim))
        # regularisers over the alive rows (train_static.py:99-100)
        loss = loss + opt.opacity_reg * masked_mean(
            torch.abs(s.get_opacity()), alive, s.n_alive)
        loss = loss + opt.scale_reg * masked_mean(
            torch.abs(s.get_scaling()), alive, s.n_alive)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        metrics = StepMetrics(
            loss=loss.detach(), l1=ll1.detach(), num_dup=out.num_dup,
            psnr=losses.psnr(torch.clamp(img, 0, 1),
                             torch.clamp(gt_image, 0, 1), channel_axis=0))
    return dict(zip(params, grads)), metrics


def make_train_step(opt: OptimizationConfig, settings: RasterizeSettings,
                    spatial_lr_scale: float):
    """The fused step: (state, adam_state, gen, camera, gt_image [3, H, W],
    bg, iteration, sh_degree) -> (state, adam_state, StepMetrics)."""
    settings = dataclasses.replace(settings, layout="chw")

    def train_step(state: GaussianState, adam_state: optim.AdamState,
                   gen: torch.Generator, camera: CameraParams, gt_image, bg,
                   iteration: float, sh_degree: int):
        grads, metrics = _loss_and_grads(opt, settings, state, camera,
                                         gt_image, bg, sh_degree)
        xyz_lr, lrs = learning_rates(opt, spatial_lr_scale, iteration)
        with span("train.adam"):
            new_params, new_adam = optim.step(state.params(), grads,
                                              adam_state, lrs)
        # noise after the optimizer step (train_static.py:132-140), skipped
        # at the final iteration like the reference's guard (:131)
        noise_lr = opt.noise_lr * float(iteration < opt.iterations)
        with span("train.noise"):
            new_state = mcmc.inject_noise(state.replace_params(new_params),
                                          gen, noise_lr, xyz_lr)
        return new_state, new_adam, metrics

    return train_step


def make_grad_step(opt: OptimizationConfig, settings: RasterizeSettings,
                   spatial_lr_scale: float):
    """Gradient half of the split step: (state, camera, gt_image, bg,
    sh_degree) -> (grads, StepMetrics)."""
    del spatial_lr_scale  # the learning rates belong to the apply half
    settings = dataclasses.replace(settings, layout="chw")

    def grad_step(state: GaussianState, camera: CameraParams, gt_image, bg,
                  sh_degree: int):
        return _loss_and_grads(opt, settings, state, camera, gt_image, bg,
                               sh_degree)

    return grad_step


def make_apply_step(opt: OptimizationConfig, spatial_lr_scale: float,
                    external_noise: bool = False):
    """Adam + noise half of the split step: (state, adam_state, grads, gen,
    iteration, do_adam[, raw_noise]) -> (state, adam_state).

    ``do_adam`` False mirrors the reference skipping the whole optimizer
    step on an iteration where densification replaced the parameters
    (their grads are None then, gaussian_model_static.py:302-392); the
    noise still runs. With ``external_noise`` the trailing ``raw_noise``
    ([C, 3] standard normal) replaces the generator's draw."""

    def apply_step(state: GaussianState, adam_state: optim.AdamState, grads,
                   gen: torch.Generator | None, iteration: float,
                   do_adam: bool, *extra):
        xyz_lr, lrs = learning_rates(opt, spatial_lr_scale, iteration)
        if do_adam:
            with span("train.adam"):
                new_params, adam_state = optim.step(state.params(), grads,
                                                    adam_state, lrs)
            state = state.replace_params(new_params)
        noise_lr = opt.noise_lr * float(iteration < opt.iterations)
        raw = extra[0] if external_noise else None
        with span("train.noise"):
            state = mcmc.inject_noise(state, gen, noise_lr, xyz_lr,
                                      raw_noise=raw)
        return state, adam_state

    return apply_step


def make_densify_step(cap_max: int):
    """relocate dead + grow 5% (train_static.py:122-125):
    (state, adam_state, gen) -> (state, adam_state)."""

    def densify_step(state: GaussianState, adam_state: optim.AdamState,
                     gen: torch.Generator):
        with span("train.densify"):
            state, adam_state = mcmc.relocate_gs(state, adam_state, gen)
            return mcmc.add_new_gs(state, adam_state, gen, cap_max)

    return densify_step


def make_densify_replay_step():
    """Densify with injected draws (a replayed schedule, train/replay.py):
    (state, adam_state, dead_mask [C], reloc_templates [C],
    add_templates [C], target) -> (state, adam_state). JAX's factory takes
    the capacity; here the templates come at the state's capacity."""

    def densify_replay_step(state: GaussianState,
                            adam_state: optim.AdamState, dead_mask,
                            reloc_templates, add_templates, target: int):
        with span("train.densify"):
            state, adam_state = mcmc.relocate_gs_forced(
                state, adam_state, dead_mask, reloc_templates)
            return mcmc.add_new_gs_forced(state, adam_state, add_templates,
                                          target)

    return densify_replay_step


def make_eval_step(settings: RasterizeSettings):
    """(state, camera, gt_image, bg, sh_degree) -> (clamped image, L1,
    mean per-channel PSNR), in ``settings.layout``."""

    @torch.no_grad()
    def eval_step(state: GaussianState, camera: CameraParams, gt_image, bg,
                  sh_degree: int):
        out = rasterize(state.xyz, state.get_scaling(), state.get_rotation(),
                        state.get_opacity()[:, 0], state.get_features(),
                        camera, sh_degree, bg, settings,
                        alive=state.alive_mask)
        img = torch.clamp(out.image, 0.0, 1.0)
        gt = torch.clamp(gt_image, 0.0, 1.0)
        ch = 0 if settings.layout == "chw" else -1
        return img, losses.l1_loss(img, gt), losses.psnr(img, gt,
                                                         channel_axis=ch)

    return eval_step
