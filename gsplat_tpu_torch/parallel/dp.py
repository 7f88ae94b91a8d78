"""Camera-batch data-parallel training step (port of
gsplat_tpu/parallel/dp.py).

Each rank renders and differentiates ONE camera of the batch; the
gradients are averaged over the ``dp`` axis (one all_reduce of all the
leaves packed together) and every rank applies the same Adam step and the
same noise from its replicated ``torch.Generator``, so the replicated
state stays bit-identical across ranks. Losses follow
train_static.py:95-100.

The batch: every rank draws all n_dp cameras of a step from the same
seeded stream, in the same order, and renders the one at its own dp
index (``own_sample``), the order in which JAX stacks the batch over its
devices (``stack_cameras``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.model import mcmc, optim
from gsplat_tpu_torch.model.gaussians import GaussianState
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.mesh import Mesh
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import step as step_lib
from gsplat_tpu_torch.train.config import OptimizationConfig


class DPMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_dup: torch.Tensor
    psnr: torch.Tensor


def own_sample(batch: Sequence, mesh: Mesh, axis: str = "dp"):
    """This rank's entry of a batch drawn identically on every rank."""
    if len(batch) != mesh.shape[axis]:
        raise ValueError(f"a batch of {len(batch)} over {mesh.shape[axis]} "
                         f"ranks")
    return batch[mesh.axis_index(axis)]


def pmean_grads(grads: dict, mesh: Mesh, axis: str) -> dict:
    """Every leaf averaged over ``axis`` in one collective."""
    keys = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys])
    flat = mesh_lib.pmean(flat, mesh, axis)
    out, at = {}, 0
    for k in keys:
        n = grads[k].numel()
        out[k] = flat[at:at + n].view_as(grads[k])
        at += n
    return out


def reduce_metrics(mesh: Mesh, axis: str, loss, l1, num_dup, psnr,
                   n_active=None):
    """(loss, l1, psnr) averaged, num_dup (and n_active) maxed."""
    means = mesh_lib.pmean(torch.stack([loss, l1, psnr]).float(), mesh, axis)
    ints = torch.stack([num_dup.to(torch.int64).reshape(()),
                        torch.as_tensor(0 if n_active is None else n_active,
                                        dtype=torch.int64,
                                        device=means.device).reshape(())])
    ints = mesh_lib.pmax(ints, mesh, axis)
    return means[0], means[1], ints[0].to(num_dup.dtype), means[2], ints[1]


def make_dp_train_step(mesh: Mesh, opt: OptimizationConfig,
                       settings: RasterizeSettings, spatial_lr_scale: float,
                       axis: str = "dp"):
    """step(state, adam, gen, camera, gt [3, H, W], bg, iteration,
    sh_degree) -> (state, adam, DPMetrics): ``camera`` and ``gt`` are this
    rank's sample; state, adam and ``gen`` are replicated."""
    settings = dataclasses.replace(settings, layout="chw")

    def step(state: GaussianState, adam: optim.AdamState,
             gen: torch.Generator, camera: CameraParams, gt, bg,
             iteration: float, sh_degree: int):
        grads, m = step_lib._loss_and_grads(opt, settings, state, camera,
                                            gt, bg, sh_degree)
        grads = pmean_grads(grads, mesh, axis)
        loss, l1, num_dup, psnr, _ = reduce_metrics(
            mesh, axis, m.loss, m.l1, m.num_dup, m.psnr)
        xyz_lr, lrs = step_lib.learning_rates(opt, spatial_lr_scale,
                                              iteration)
        new_params, adam = optim.step(state.params(), grads, adam, lrs)
        state = mcmc.inject_noise(state.replace_params(new_params), gen,
                                  opt.noise_lr, xyz_lr)
        return state, adam, DPMetrics(loss=loss, l1=l1, num_dup=num_dup,
                                      psnr=psnr)

    return step
