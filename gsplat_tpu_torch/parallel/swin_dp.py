"""Camera-batch data-parallel SwinGS training step (port of
gsplat_tpu/parallel/swin_dp.py).

Each rank renders and differentiates ONE (camera, frame) sample of the
window batch through the shared ``swin_step.swin_loss`` body; gradients
are averaged over the ``dp`` axis and every rank applies the same Adam
step. The noise on the active immature rows is gated at the batch's FIRST
frame on every rank, as JAX gates it: the state is replicated, so the
injection must be identical everywhere, and the first sample's frame has
the single-device sample's marginal distribution (tests/test_swin.py::
test_dp_noise_gate_frame_marginal). Every rank drew the whole batch
(parallel/dp.py), so the caller passes that frame.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.model import optim, swin
from gsplat_tpu_torch.model.swin import SwinState
from gsplat_tpu_torch.parallel.dp import pmean_grads, reduce_metrics
from gsplat_tpu_torch.parallel.mesh import Mesh
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import swin_step as sstep
from gsplat_tpu_torch.train.config import OptimizationConfig


def make_dp_swin_train_step(mesh: Mesh, opt: OptimizationConfig,
                            settings: RasterizeSettings,
                            spatial_lr_scale: float, axis: str = "dp"):
    """step(state, adam, gen, camera, gt [3, H, W], frame, frame0, bg,
    iteration, sh_degree) -> (state, adam, SwinMetrics): ``camera``,
    ``gt`` and ``frame`` are this rank's sample, ``frame0`` the frame of
    the batch's first sample; state, adam and ``gen`` are replicated."""
    settings = dataclasses.replace(settings, layout="chw")

    def step(state: SwinState, adam: optim.AdamState, gen: torch.Generator,
             camera: CameraParams, gt, frame: float, frame0: float, bg,
             iteration: float, sh_degree: int):
        grads, m = sstep._loss_and_grads(opt, settings, state, camera, gt,
                                         bg, frame, sh_degree)
        grads = pmean_grads(grads, mesh, axis)
        loss, l1, num_dup, psnr, n_active = reduce_metrics(
            mesh, axis, m.loss, m.l1, m.num_dup, m.psnr, m.n_active)
        xyz_lr, lrs = sstep.swin_learning_rates(opt, spatial_lr_scale,
                                                iteration)
        new_params, adam = optim.step(state.params(), grads, adam, lrs)
        state = swin.inject_noise_active(state.replace_params(new_params),
                                         gen, opt.noise_lr, xyz_lr, frame0)
        return state, adam, sstep.SwinMetrics(
            loss=loss, l1=l1, num_dup=num_dup, psnr=psnr, n_active=n_active)

    return step
