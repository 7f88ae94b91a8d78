"""Gaussian-sharded (P-sharded) rendering and training, the
tensor-parallel analogue (port of gsplat_tpu/parallel/pshard.py).

Rank d of the ``ps`` axis owns rows [d C/n, (d+1) C/n) of the Gaussian
parameters and their Adam moments. Partitioning by camera depth slab
keeps front-to-back over-compositing associative:

1. every rank all-gathers the (activated) parameters; the backward of the
   gather is the reduce-scatter (SUM) that brings each shard its own rows'
   gradient (``mesh.all_gather``), with the loss divided by n so that the
   summed replicas give dL/d(shard) exactly;
2. a log-depth histogram (256 bins), summed over the axis as integers,
   gives global slab bounds of roughly equal occupancy; rank d rasterizes
   only the Gaussians whose depth falls in slab d (a mask: shapes stay
   fixed);
3. the per-rank premultiplied (C_d, T_d) images are all-gathered and
   folded in slab order: C = sum_d (prod_{e<d} T_e) C_d, T = prod_d T_d.

Slab order is depth order for every pixel, so the result matches the
single-device render up to the T <= 1e-4 stop rule (each slab stops on its
own transmittance). Every rank computes the histogram from the whole
gathered depth array and the sum runs over the axis, so the counts are n
times the Gaussians' (as in JAX): the bounds, and so each Gaussian's slab,
are JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.core.covariance import covariance_6
from gsplat_tpu_torch.core.quaternion import normalize
from gsplat_tpu_torch.model import optim
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.dp import pmean_grads
from gsplat_tpu_torch.parallel.mesh import Mesh
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize
from gsplat_tpu_torch.train import losses
from gsplat_tpu_torch.train import step as step_lib

ZNEAR_CULL = 0.2  # frustum near-cull plane (auxiliary.h:154)
_HIST_BINS = 256


def _depth_hi(depth, alive, mesh: Mesh, axis: str):
    """Upper end of the slab-binning depth range: the deepest alive point
    over the axis (all_reduce MAX), at least 2 x the near plane. Slab
    bounds are bookkeeping, not differentiated."""
    d = torch.where(alive, depth.detach(),
                    torch.full_like(depth, float("-inf")))
    d_max = mesh_lib.pmax(d.max().reshape(1), mesh, axis)[0]
    return torch.clamp(d_max, min=2.0 * ZNEAR_CULL)


def _log_depth(depth, hi):
    return torch.log(torch.minimum(torch.clamp(depth, min=ZNEAR_CULL), hi))


def _slab_bounds(depth, alive, n_dev: int, mesh: Mesh, axis: str):
    """([n_dev + 1] slab bounds in log-depth (-inf first, +inf last), the
    depth range's upper end) from the summed histogram."""
    depth = depth.detach()
    hi_d = _depth_hi(depth, alive, mesh, axis)
    logd = _log_depth(depth, hi_d)
    lo = torch.log(torch.tensor(ZNEAR_CULL, dtype=torch.float32,
                                device=depth.device))
    hi = torch.log(hi_d)
    bins = torch.clamp(((logd - lo) / (hi - lo) * _HIST_BINS).to(
        torch.int32), 0, _HIST_BINS - 1)
    hist = torch.zeros(_HIST_BINS, dtype=torch.int64, device=depth.device)
    hist.index_add_(0, bins.long(), alive.to(torch.int64))
    hist = mesh_lib.psum(hist, mesh, axis)
    cum = torch.cumsum(hist, 0)
    total = cum[-1]
    steps = (torch.arange(1, _HIST_BINS + 1, device=depth.device,
                          dtype=torch.float32) / _HIST_BINS)
    edges = lo + (hi - lo) * steps
    targets = (torch.arange(1, n_dev, dtype=torch.float32,
                            device=depth.device) / n_dev
               * total.to(torch.float32))
    idx = torch.searchsorted(cum, targets.to(torch.int32).to(torch.int64))
    inner = edges[torch.clamp(idx, 0, _HIST_BINS - 1)]
    inf = torch.full((1,), float("inf"), device=depth.device)
    return torch.cat([-inf, inner, inf]), hi_d


def _view_depth(means, camera: CameraParams):
    view = camera.view
    return (means[:, 0] * view[2, 0] + means[:, 1] * view[2, 1]
            + means[:, 2] * view[2, 2]) + view[2, 3]


def _gather_activated(means, scales, quats, opa, shs, alive, mesh: Mesh,
                      axis: str):
    """The whole model from every rank's rows, in one differentiable
    all-gather: (means, scales, quats, opacities, shs, alive)."""
    k = shs.shape[1]
    rows = means.shape[0]
    packed = torch.cat([means, scales, quats, opa[:, None],
                        shs.reshape(rows, -1)], dim=1)
    full = mesh_lib.all_gather(packed, mesh, axis)
    alive_f = mesh_lib.gather_rows({"a": alive}, mesh, axis)["a"]
    return (full[:, 0:3], full[:, 3:6], full[:, 6:10], full[:, 10],
            full[:, 11:].reshape(-1, k, 3), alive_f)


def _slab_composite(means_f, scales_f, quats_f, opa_f, shs_f, alive_f,
                    camera, sh_degree, settings, mesh: Mesh, axis: str):
    """(premultiplied colour [3, H, W], T [1, H, W], this rank's
    RasterizeOutput) of the ordered fold over the slabs."""
    n_dev = mesh.shape[axis]
    d = mesh.axis_index(axis)
    depth_f = _view_depth(means_f.detach(), camera)
    bounds, hi_d = _slab_bounds(depth_f, alive_f & (depth_f > ZNEAR_CULL),
                                n_dev, mesh, axis)
    logd = _log_depth(depth_f, hi_d)
    my_mask = (logd >= bounds[d]) & (logd < bounds[d + 1])
    out = rasterize(means_f, scales_f, quats_f, opa_f, shs_f, camera,
                    sh_degree, torch.zeros(3, device=means_f.device),
                    settings, alive=alive_f & my_mask)
    h, w = out.final_t.shape
    ct = torch.cat([out.image, out.final_t[None]], dim=0)   # [4, H, W]
    cts = mesh_lib.all_gather(ct, mesh, axis).view(n_dev, 4, h, w)
    c_acc = torch.zeros_like(out.image)
    t_acc = torch.ones_like(out.final_t[None])
    for j in range(n_dev):
        c_acc = c_acc + t_acc * cts[j, :3]
        t_acc = t_acc * cts[j, 3:]
    return c_acc, t_acc, out


def make_pshard_render(mesh: Mesh, settings: RasterizeSettings,
                       sh_degree: int, axis: str = "ps"):
    """render(means3d, scales, quats, opacities, shs, alive, camera, bg)
    over this rank's rows -> the composited [H, W, 3] image on every rank
    (differentiable with respect to the rank's rows)."""
    settings = dataclasses.replace(settings, layout="chw")

    def render(means, scales, quats, opa, shs, alive, camera, bg):
        full = _gather_activated(means, scales, quats, opa, shs, alive,
                                 mesh, axis)
        c, t, _ = _slab_composite(*full, camera, sh_degree, settings, mesh,
                                  axis)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=c.device)
        return (c + t * bg[:, None, None]).permute(1, 2, 0)

    return render


class PShardMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_dup: torch.Tensor
    psnr: torch.Tensor


def make_pshard_train_step(mesh: Mesh, opt, settings: RasterizeSettings,
                           spatial_lr_scale: float, sh_degree: int,
                           axis: str = "ps", dp_axis: str | None = None):
    """step(params, alive, adam, gen, camera, gt [3, H, W], bg, iteration,
    n_alive_total) -> (params, adam, PShardMetrics).

    ``params`` (keyed like ``GaussianState.params()``), ``alive`` and
    ``adam`` hold this rank's rows; camera, gt, bg, iteration and
    ``n_alive_total`` are the same on every rank of the ps axis. ``gen``
    draws this shard's noise: seed it by the ps index alone (JAX folds the
    index into the key), so dp rows agree. MCMC densification runs outside
    the step, on the gathered state.

    ``dp_axis``: the 2-D (dp x ps) mode. Each dp row trains its own camera
    (``camera``/``gt`` are the row's sample) on the same ps-sharded rows;
    gradients are averaged over ``dp_axis`` before the shard-local Adam
    step, so the update is the camera-batch mean as in parallel/dp.py.
    """
    n_dev = mesh.shape[axis]
    settings = dataclasses.replace(settings, layout="chw")

    def step(params, alive, adam: optim.AdamState, gen: torch.Generator,
             camera: CameraParams, gt, bg, iteration: float,
             n_alive_total: int):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        full = _gather_activated(
            p["xyz"], torch.exp(p["scaling"]), normalize(p["rotation"]),
            torch.sigmoid(p["opacity"])[:, 0],
            torch.cat([p["f_dc"], p["f_rest"]], dim=1), alive, mesh, axis)
        c, t, out = _slab_composite(*full, camera, sh_degree, settings,
                                    mesh, axis)
        img = c + t * torch.as_tensor(bg, dtype=torch.float32,
                                      device=c.device)[:, None, None]
        ll1 = losses.l1_loss(img, gt)
        lssim = losses.ssim(img, gt)
        loss = (1 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1 - lssim)
        # regularisers: per-shard masked sums, summed over the axis into
        # the global means
        af = alive.to(torch.float32)
        sums = mesh_lib.psum_grad(torch.stack([
            torch.sum(torch.abs(torch.sigmoid(p["opacity"])) * af[:, None]),
            torch.sum(torch.mean(torch.abs(torch.exp(p["scaling"])), dim=1)
                      * af)]), mesh, axis)
        denom = float(max(n_alive_total, 1))
        loss = loss + opt.opacity_reg * sums[0] / denom
        loss = loss + opt.scale_reg * sums[1] / denom
        grads = dict(zip(p, torch.autograd.grad(loss / n_dev,
                                                list(p.values()))))
        loss, ll1 = loss.detach(), ll1.detach()
        num_dup = out.num_dup
        with torch.no_grad():
            psnr = losses.psnr(torch.clamp(img, 0, 1), torch.clamp(gt, 0, 1),
                               channel_axis=0)
        if dp_axis is not None:
            grads = pmean_grads(grads, mesh, dp_axis)
            means = mesh_lib.pmean(torch.stack([loss, ll1, psnr]), mesh,
                                   dp_axis)
            loss, ll1, psnr = means[0], means[1], means[2]
            num_dup = mesh_lib.pmax(num_dup.reshape(1), mesh, dp_axis)[0]
        num_dup = mesh_lib.pmax(num_dup.reshape(1), mesh, axis)[0]

        xyz_lr, lrs = step_lib.learning_rates(opt, spatial_lr_scale,
                                              iteration)
        new_params, adam = optim.step(params, grads, adam, lrs)
        # covariance-shaped noise on the local shard (train_static.py:
        # 132-140)
        with torch.no_grad():
            opa_act = torch.sigmoid(new_params["opacity"])
            gate = torch.sigmoid(100.0 * ((1.0 - opa_act) - 0.995))
            raw = torch.randn(new_params["xyz"].shape, generator=gen,
                              device=new_params["xyz"].device)
            noise = raw * gate * opt.noise_lr * xyz_lr
            xx, xy, xz, yy, yz, zz = covariance_6(
                torch.exp(new_params["scaling"]),
                normalize(new_params["rotation"])).unbind(-1)
            nx, ny, nz = noise.unbind(-1)
            noise = torch.stack([xx * nx + xy * ny + xz * nz,
                                 xy * nx + yy * ny + yz * nz,
                                 xz * nx + yz * ny + zz * nz], dim=-1)
            noise = torch.where(alive[:, None], noise,
                                torch.zeros_like(noise))
            new_params = dict(new_params, xyz=new_params["xyz"] + noise)
        return new_params, adam, PShardMetrics(loss=loss, l1=ll1,
                                               num_dup=num_dup, psnr=psnr)

    return step
