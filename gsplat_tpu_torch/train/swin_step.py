"""Training steps for sliding-window (SwinGS) training (port of
gsplat_tpu/train/swin_step.py).

The train_slide_window iteration body of the reference (train_swin.py:
148-273), run eagerly: frame-indexed deformable render of the immature +
matured union, L1 + SSIM with the MCMC regularisers over the ACTIVE union
rows, Adam over nine parameter groups (the six static ones and the rigid
motion), noise on the active immature rows, per-birth-frame relocation
and genesis-only growth. The loss is rendered channel-first; ``gt_image``
arrives [3, H, W].

Where JAX takes a PRNG key, these take a ``torch.Generator``; the fused
and apply steps also take an optional ``raw_noise`` ([C, 3] standard
normal) in place of the generator's draw.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.model import optim, swin
from gsplat_tpu_torch.model.swin import SwinState
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize
from gsplat_tpu_torch.train import losses
from gsplat_tpu_torch.train.config import OptimizationConfig
from gsplat_tpu_torch.train.step import learning_rates, masked_mean


class SwinMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_dup: torch.Tensor
    psnr: torch.Tensor
    n_active: torch.Tensor


def swin_learning_rates(opt: OptimizationConfig, spatial_lr_scale: float,
                        iteration: float):
    """(xyz_lr, the nine groups' learning rates) at ``iteration``."""
    xyz_lr, lrs = learning_rates(opt, spatial_lr_scale, iteration)
    lrs.update(rigid_v=opt.rigid_v_lr, rigid_rotvec=opt.rigid_rotvec_lr,
               rigid_rotcen=opt.rigid_rotcen_lr)
    return xyz_lr, lrs


def swin_loss(opt: OptimizationConfig, settings: RasterizeSettings,
              state: SwinState, params, camera: CameraParams, gt_image, bg,
              frame: float, sh_degree: int):
    """Render the union at ``frame`` with ``params`` in place of the
    state's trainable leaves; L1 + SSIM plus the regularisers as means over
    the active union rows (train_swin.py:148-200). Returns (loss, (l1,
    num_dup, image, n_active))."""
    s = state.replace_params(params)
    kw = swin.union_params_at(s, frame)
    out = rasterize(kw["means3d"], kw["scales"], kw["quats"],
                    kw["opacities"], kw["shs"], camera, sh_degree, bg,
                    settings, alive=kw["alive"])
    img = out.image
    ll1 = losses.l1_loss(img, gt_image)
    lssim = losses.ssim(img, gt_image)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - lssim)
    active = kw["alive"]
    n_active = torch.sum(active.to(torch.int32))
    loss = loss + opt.opacity_reg * masked_mean(
        torch.abs(kw["opacities"]), active, n_active)
    loss = loss + opt.scale_reg * masked_mean(
        torch.abs(kw["scales"]), active, n_active)
    return loss, (ll1, out.num_dup, img, n_active)


def _loss_and_grads(opt, settings, state: SwinState, camera, gt_image, bg,
                    frame: float, sh_degree: int):
    """(grads keyed like ``state.params()``, SwinMetrics). A leaf the loss
    does not reach (the rigid ones without ``deform``) gets zeros, as
    jax.grad gives."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params().items()}
    loss, (ll1, num_dup, img, n_active) = swin_loss(
        opt, settings, state, params, camera, gt_image, bg, frame, sh_degree)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    with torch.no_grad():
        metrics = SwinMetrics(
            loss=loss.detach(), l1=ll1.detach(), num_dup=num_dup,
            psnr=losses.psnr(torch.clamp(img, 0, 1),
                             torch.clamp(gt_image, 0, 1), channel_axis=0),
            n_active=n_active)
    return grads, metrics


def make_swin_train_step(opt: OptimizationConfig,
                         settings: RasterizeSettings,
                         spatial_lr_scale: float):
    """The fused step: (state, adam, gen, camera, gt_image [3, H, W], bg,
    iteration, frame, sh_degree[, raw_noise]) -> (state, adam,
    SwinMetrics)."""
    settings = dataclasses.replace(settings, layout="chw")

    def swin_train_step(state: SwinState, adam: optim.AdamState,
                        gen: torch.Generator | None, camera: CameraParams,
                        gt_image, bg, iteration: float, frame: float,
                        sh_degree: int, raw_noise=None):
        grads, metrics = _loss_and_grads(opt, settings, state, camera,
                                         gt_image, bg, frame, sh_degree)
        xyz_lr, lrs = swin_learning_rates(opt, spatial_lr_scale, iteration)
        new_params, adam = optim.step(state.params(), grads, adam, lrs)
        state = swin.inject_noise_active(state.replace_params(new_params),
                                         gen, opt.noise_lr, xyz_lr, frame,
                                         raw_noise=raw_noise)
        return state, adam, metrics

    return swin_train_step


def make_swin_grad_step(opt: OptimizationConfig,
                        settings: RasterizeSettings,
                        spatial_lr_scale: float):
    """Gradient half of the split step: (state, camera, gt_image, bg,
    frame, sh_degree) -> (grads, SwinMetrics). Densification iterations
    follow the reference's backward -> densify -> optimizer.step; there the
    Adam update is ALWAYS skipped, because relocate_gs_immuture recreates
    every nn.Parameter with grad=None unconditionally
    (gaussian_model.py:957), so the reference's step() does nothing. The
    gradient serves the metrics."""
    del spatial_lr_scale  # the learning rates belong to the apply half
    settings = dataclasses.replace(settings, layout="chw")

    def swin_grad_step(state: SwinState, camera: CameraParams, gt_image,
                       bg, frame: float, sh_degree: int):
        return _loss_and_grads(opt, settings, state, camera, gt_image, bg,
                               frame, sh_degree)

    return swin_grad_step


def make_swin_apply_step(opt: OptimizationConfig, spatial_lr_scale: float):
    """Adam + noise half of the split step: (state, adam, grads, gen,
    iteration, frame, do_adam[, raw_noise]) -> (state, adam). ``do_adam``
    False is the grad=None skip above; the noise on the active immature
    rows still runs (the reference's own swin noise is a no-op,
    train_swin.py:261 adds to an advanced-indexing copy; this is the
    intended MCMC perturbation, as in the JAX package)."""

    def swin_apply_step(state: SwinState, adam: optim.AdamState, grads,
                        gen: torch.Generator | None, iteration: float,
                        frame: float, do_adam: bool, raw_noise=None):
        xyz_lr, lrs = swin_learning_rates(opt, spatial_lr_scale, iteration)
        if do_adam:
            new_params, adam = optim.step(state.params(), grads, adam, lrs)
            state = state.replace_params(new_params)
        state = swin.inject_noise_active(state, gen, opt.noise_lr, xyz_lr,
                                         frame, raw_noise=raw_noise)
        return state, adam

    return swin_apply_step


def make_swin_densify_step(cap_max: int, window_size: int):
    """(state, adam, gen, window_start, genesis) -> (state, adam):
    per-birth-frame relocation, then growth during genesis only
    (train_swin.py:233-234)."""

    def densify(state: SwinState, adam: optim.AdamState,
                gen: torch.Generator | None, window_start: float,
                genesis: bool):
        state, adam = swin.relocate_immature(state, adam, gen, window_start,
                                             window_size=window_size)
        if genesis:
            state, adam = swin.add_new_gs(state, adam, gen, cap_max)
        return state, adam

    return densify


def make_swin_eval_step(settings: RasterizeSettings):
    """(state, camera, gt_image, bg, frame, sh_degree) -> (clamped image,
    L1, mean per-channel PSNR), in ``settings.layout``."""

    @torch.no_grad()
    def eval_step(state: SwinState, camera: CameraParams, gt_image, bg,
                  frame: float, sh_degree: int):
        kw = swin.union_params_at(state, frame)
        out = rasterize(kw["means3d"], kw["scales"], kw["quats"],
                        kw["opacities"], kw["shs"], camera, sh_degree, bg,
                        settings, alive=kw["alive"])
        img = torch.clamp(out.image, 0.0, 1.0)
        gt = torch.clamp(gt_image, 0.0, 1.0)
        ch = 0 if settings.layout == "chw" else -1
        return img, losses.l1_loss(img, gt), losses.psnr(img, gt,
                                                         channel_axis=ch)

    return eval_step
