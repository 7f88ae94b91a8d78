"""Rank body of tests/test_torch_parallel.py: every multi-rank case of the
port in one 4-rank gloo job on the CPU (one process group per test file).

``run_cases(inputs, out_dir)`` runs on each rank with numpy inputs built by
the test and writes that rank's results to ``out_dir/rank{r}.npz``. The
2-rank cases run on ranks 0 and 1 (their own group) while ranks 2 and 3
wait; the dp x ps case runs on all four. Imports torch and the port only.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from gsplat_tpu_torch.core.camera import make_camera
from gsplat_tpu_torch.model import gaussians, optim, swin
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.dp import make_dp_train_step
from gsplat_tpu_torch.parallel.mesh import Axis, Mesh
from gsplat_tpu_torch.parallel.pshard import (make_pshard_render,
                                              make_pshard_train_step)
from gsplat_tpu_torch.parallel.swin_dp import make_dp_swin_train_step
from gsplat_tpu_torch.parallel.tileshard import (make_tileshard_render,
                                                 tileshard_num_dup)
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import step as step_lib
from gsplat_tpu_torch.train import swin_step
from gsplat_tpu_torch.train.config import OptimizationConfig

CPU = torch.device("cpu")
T = torch.from_numpy


def settings(k_dup=4096):
    return RasterizeSettings(k_dup=k_dup, tile_x=16, tile_y=16, chunk=128)


def camera(spec):
    """make_camera from (R, t, fovx, fovy, W, H) as the test packs it."""
    r, t, fx, fy, w, h = spec
    return make_camera(np.asarray(r), np.asarray(t), float(fx), float(fy),
                       int(w), int(h), device="cpu")


def cloud(inp, pre):
    return tuple(T(inp[f"{pre}_{k}"]) for k in
                 ("means", "scales", "quats", "opa", "shs", "alive"))


def _flat(prefix, d, out):
    for k, v in d.items():
        out[f"{prefix}{k}"] = v.detach().numpy()


def run_cases(inp: dict, out_dir: str) -> None:
    rank = dist.get_rank()
    g01 = dist.new_group([0, 1])
    mesh2d = mesh_lib.make_mesh_2d(2, 2, device=CPU)
    out = {}
    if rank < 2:
        axes = {name: Axis(g01, 2, rank) for name in ("dp", "ps", "sp")}
        mesh = Mesh(axes, CPU)
        _two_rank_cases(inp, mesh, out)
    dist.barrier()
    _dp_ps_case(inp, mesh2d, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _two_rank_cases(inp, mesh, out):
    # tileshard: two bands against the replicated cloud
    cam = camera(inp["ts_cam"])
    bg = T(inp["bg"])
    args = cloud(inp, "ts")
    out["ts_image"] = make_tileshard_render(mesh, settings(), 1)(
        *args, cam, bg).numpy()
    out["ts_num_dup"] = np.asarray(
        int(tileshard_num_dup(mesh, settings(), 1)(*args, cam, bg)))

    # pshard render over this rank's half of the rows
    full = cloud(inp, "ps")
    half = full[0].shape[0] // 2
    d = mesh.axis_index("ps")
    rows = tuple(x[d * half:(d + 1) * half] for x in full)
    cam = camera(inp["ps_cam"])
    out["ps_image"] = make_pshard_render(mesh, settings(), 1)(
        *rows, cam, bg).detach().numpy()

    # the gather's backward delivers dL/d(shard) under the /n loss
    x = T(inp["gg_x"])[d * 32:(d + 1) * 32].clone().requires_grad_(True)
    full_x = mesh_lib.all_gather(x, mesh, "ps")
    (torch.sum(full_x ** 3) / 2).backward()
    out["gg_grad"] = x.grad.numpy()

    # pshard train step, noise off
    opt0 = OptimizationConfig(noise_lr=0.0)
    state = gaussians.state_from_numpy(_leaves(inp, "st"),
                                       int(inp["st_n"]), 1, CPU)
    cam = camera(inp["ps_cam"])
    gt = T(inp["ps_gt"])
    step = make_pshard_train_step(mesh, opt0, settings(), 1.0, 1)
    params = {k: mesh_lib.shard_rows(v, mesh, "ps")
              for k, v in state.params().items()}
    alive = mesh_lib.shard_rows(state.alive_mask, mesh, "ps")
    p, a, m = step(params, alive, optim.init(params), _gen(1 + d), cam, gt,
                   torch.zeros(3), 1.0, state.n_alive)
    _flat("pst_", mesh_lib.gather_rows(p, mesh, "ps"), out)
    _flat("pst_mu_", mesh_lib.gather_rows(a.mu, mesh, "ps"), out)
    out["pst_loss"] = m.loss.numpy()

    # dp: one step with the noise off, then three noisy steps with a
    # densification after the second (the replicated state must agree)
    cams = [camera(c) for c in inp["dp_cams"]]
    gts = [T(g) for g in inp["dp_gts"]]
    dp_i = mesh.axis_index("dp")
    s1, _, m = make_dp_train_step(mesh, opt0, settings(), 1.0)(
        state, optim.init(state.params()), _gen(0), cams[dp_i], gts[dp_i],
        torch.zeros(3), 1.0, 1)
    _flat("dp_", s1.params(), out)
    out["dp_loss"] = m.loss.numpy()
    dstep = make_dp_train_step(mesh, OptimizationConfig(), settings(), 1.0)
    densify = step_lib.make_densify_step(state.capacity)
    gen, s, a = _gen(0), state, optim.init(state.params())
    for it in range(1, 4):
        s, a, _ = dstep(s, a, gen, cams[dp_i], gts[dp_i], torch.zeros(3),
                        float(it), 1)
        if it == 2:
            s, a = densify(s, a, gen)
    _flat("dpn_", s.params(), out)
    _flat("dpn_mu_", a.mu, out)
    out["dpn_n_alive"] = np.asarray(s.n_alive)

    # swin-dp: one step with the noise off, then three noisy steps with a
    # relocation after the second
    sw = swin.swin_state_from_numpy(
        {k[3:]: v for k, v in inp.items() if k.startswith("sw_")},
        int(inp["swin_n"]), int(inp["swin_m"]), 1, 4, True, CPU)
    frames = [float(f) for f in inp["swin_frames"]]
    s1, _, m = make_dp_swin_train_step(mesh, opt0, settings(), 1.0)(
        sw, optim.init(sw.params()), _gen(0), cams[dp_i], gts[dp_i],
        frames[dp_i], frames[0], torch.zeros(3), 1.0, 1)
    _flat("sdp_", s1.params(), out)
    out["sdp_loss"] = m.loss.numpy()
    sstep_n = make_dp_swin_train_step(mesh, OptimizationConfig(),
                                      settings(), 1.0)
    sdens = swin_step.make_swin_densify_step(sw.capacity, 4)
    gen, s, a = _gen(0), sw, optim.init(sw.params())
    for it in range(1, 4):
        s, a, _ = sstep_n(s, a, gen, cams[dp_i], gts[dp_i], frames[dp_i],
                          frames[0], torch.zeros(3), float(it), 1)
        if it == 2:
            s, a = sdens(s, a, gen, 0.0, True)
    _flat("sdpn_", s.params(), out)
    out["sdpn_n_alive"] = np.asarray(s.im.n_alive)


def _dp_ps_case(inp, mesh, out):
    """2 dp rows x 2 ps shards, distinct cameras per row, noise off."""
    state = gaussians.state_from_numpy(_leaves(inp, "st"),
                                       int(inp["st_n"]), 1, CPU)
    step = make_pshard_train_step(mesh, OptimizationConfig(noise_lr=0.0),
                                  settings(), 1.0, 1, dp_axis="dp")
    params = {k: mesh_lib.shard_rows(v, mesh, "ps")
              for k, v in state.params().items()}
    alive = mesh_lib.shard_rows(state.alive_mask, mesh, "ps")
    row = mesh.axis_index("dp")
    cam = camera(inp["dp_cams"][row])
    p, a, m = step(params, alive, optim.init(params),
                   _gen(1 + mesh.axis_index("ps")), cam,
                   T(inp["dp_gts"][row]), torch.zeros(3), 1.0,
                   state.n_alive)
    _flat("dps_", mesh_lib.gather_rows(p, mesh, "ps"), out)
    _flat("dps_mu_", mesh_lib.gather_rows(a.mu, mesh, "ps"), out)
    out["dps_loss"] = m.loss.numpy()


def _leaves(inp, pre):
    return {k: inp[f"{pre}_{k}"] for k in gaussians.PARAM_KEYS}


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g
