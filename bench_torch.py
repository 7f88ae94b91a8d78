#!/usr/bin/env python3
"""Benchmark of gsplat_tpu_torch: bench.py's stages, method and gates run
through the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 bench_torch.py                # on the card (the default)
    python3 bench_torch.py --device cpu   # bench.py's CPU sizes, the
                                          # kernels' plain versions

Prints ONE JSON line on stdout with bench.py's keys (bench.py:495-525) and
two more: ``config.device``, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them ("cpu" with --device cpu), and
``config.hw_parity_param_delta_rel_masked``, the Adam-delta error the port
gates (``hw_parity_param_delta_rel`` keeps bench.py's unmasked definition,
reported ungated). Stage logs go to stderr as ``stage: ...``.
With ``--device cuda`` and no card it prints bench.py's failure line
(``"value": 0.0`` and ``config.error``) and exits 1: it never falls back to
the CPU.

Stages, in bench.py's order, all drawing from one
``np.random.default_rng(0)`` in bench.py's order, so that each stage's
inputs are the JAX bench's, bit for bit where numpy draws them:

  hw_parity_stage  tests/fixtures/hw_parity_golden.npz replayed through the
                   port (scripts/gen_hw_parity_golden.py's recipe): images,
                   loss, num_dup and Adam deltas of one train step, gated;
                   raises on a miss
  train_stage      100k Gaussians at 800x800, 8 orbit cameras (bench.py:
                   254-335)
  render_stage     the served frame (render_frame) at 1920x1088 with 128x32
                   tiles on the bare 100k-Gaussian _make_scene(seed=0)
                   scene, 8 cameras (bench.py:337-376)
  train_1m_stage   1M Gaussians with a trained scene's opacity and scale
                   statistics at 1296x840, 4 cameras (bench.py:378-430)
  swin_stage       SwinGS: 200k immature + 200k matured rows, swin 8, SH 1,
                   deform, 1280x720, 4 cameras (bench.py:432-493)

Method and gates, as bench.py's: one warm step, then 3 timed windows, the
median reported; each window ends on a host read of its last loss (a
synchronise for the render); the losses finite and different across
windows; every step's num_dup <= k_dup, read after timing; the rendered
image finite with max > 0.05. JAX's PRNG keys become one seeded
``torch.Generator`` a stage. BENCH_TILE_X / BENCH_TILE_Y set the training
tiles (default 64x16).

chip_smoke.py imports the recipes (scenes, cameras, states, budgets, the
golden replay) and the timed windows from here.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# bench.py's anchors (bench.py:36-42): estimates for an A100 from
# BASELINE.md, not measurements. The 100k figure is the A100 rate implied
# by the north-star target (~30 it/s); the 1M one the midpoint of the
# 50-70 ms/it band derived there for the reference codebase.
A100_BASELINE_ITERS_PER_SEC = 30.0
A100_1M_MS_PER_ITER = 60.0
TRAINED_STATS = os.path.join(ROOT, "tests", "fixtures", "trained_stats.npz")
HW_GOLDEN = os.path.join(ROOT, "tests", "fixtures", "hw_parity_golden.npz")
SH_DEGREE = 3
CHUNK = 128
SPATIAL_LR_SCALE = 4.0

# bench.py's sizes: on the card its full ones, on the CPU its toy ones
# (bench.py:254-255, 260, 341-346, 365, 384-385, 395, 440-441, 455).
# k_probe is the budget each stage probes num_dup at (the 100k stage also
# renders its ground truths at it).
SIZES = {
    "cuda": dict(
        p_gt=20_000,
        train=dict(p=100_000, width=800, height=800, cams=8, wit=20,
                   k_probe=800_000),
        render=dict(p=100_000, width=1920, height=1088, tile=(128, 32),
                    cams=8, frames=48),
        train_1m=dict(p=1_000_000, width=1296, height=840, cams=4, wit=10,
                      k_probe=1 << 21),
        swin=dict(cap=200_000, sh=1, lifespan=8, width=1280, height=720,
                  cams=4, wit=10, k_probe=1 << 20)),
    "cpu": dict(
        p_gt=500,
        train=dict(p=1000, width=128, height=128, cams=8, wit=2,
                   k_probe=1 << 15),
        render=dict(p=1000, width=256, height=128, tile=(32, 16), cams=8,
                    frames=2),
        train_1m=dict(p=2000, width=160, height=96, cams=4, wit=2,
                      k_probe=1 << 15),
        swin=dict(cap=2000, sh=1, lifespan=8, width=160, height=96, cams=4,
                  wit=2, k_probe=1 << 15)),
}


def log(msg: str) -> None:
    print(f"stage: {msg}", file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generator(device, seed: int):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def peak_gb(device, reset: bool = False):
    """Peak allocated GB on the card since the last reset (None on the
    CPU); with ``reset`` a new stretch starts."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def kernel_launches() -> dict:
    """Each hand-kernel wrapper's launch count (they count on the card
    only)."""
    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel

    return {name: getattr(mod, name).launches for mod, names in (
        (scan_kernel, ("expand_scan", "merge_expand", "multi_cumsum",
                       "multi_cummax")),
        (tile_kernel, ("tile_blend_forward", "tile_blend_backward",
                       "render_forward"))) for name in names}


def sizes(device) -> dict:
    import torch

    return SIZES[torch.device(device).type]


def bench_tile() -> tuple:
    """The training tiles: BENCH_TILE_X x BENCH_TILE_Y (bench.py:257-258)."""
    return (int(os.environ.get("BENCH_TILE_X", 64)),
            int(os.environ.get("BENCH_TILE_Y", 16)))


# ------------------------------------------------------------- recipes ----

def scene_arrays(p: int, sh_degree: int, seed: int = 0):
    """The __graft_entry__._make_scene recipe as raw numpy leaves (means,
    log-scales, quaternions, opacity logits, SH): uniform cloud at z in
    [2, 6], log-uniform scales, random quaternions, logits in [-2, 4], SH
    DC around 1."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.2, 1.2, size=(p, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2.0, 6.0, size=p)
    log_scales = rng.uniform(-3.5, -2.0, size=(p, 3)).astype(np.float32)
    quats = rng.normal(size=(p, 4)).astype(np.float32)
    opa_logit = rng.uniform(-2, 4, size=p).astype(np.float32)
    shs = (0.3 * rng.normal(size=(p, (sh_degree + 1) ** 2, 3))
           ).astype(np.float32)
    shs[:, 0, :] += 1.0
    return means, log_scales, quats, opa_logit, shs


def make_scene_params(p, sh_degree, seed, device):
    """__graft_entry__._make_scene as activated tensors (means, scales,
    quats, opacities, shs)."""
    import torch

    from gsplat_tpu_torch.core.quaternion import normalize

    means, log_scales, quats, opa_logit, shs = (
        torch.as_tensor(a, device=device)
        for a in scene_arrays(p, sh_degree, seed))
    return (means, torch.exp(log_scales), normalize(quats),
            torch.sigmoid(opa_logit), shs)


def orbit_poses(n, radius=6.0, center=(0.0, 0.0, 4.0)):
    """__graft_entry__._orbit_cameras' poses: n cameras on a circle around
    the cloud, all looking at its center; (camera-to-world rotation,
    position) each."""
    c = np.asarray(center)
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / max(n, 1)
        pos = c + radius * np.array([np.sin(th), 0.0, -np.cos(th)])
        fwd = (c - pos) / radius
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        poses.append((np.stack([right, up, fwd], 1), pos))
    return poses


def orbit_cameras(n, w, h, device, radius=6.0, center=(0.0, 0.0, 4.0)):
    """__graft_entry__._orbit_cameras: n cameras on a circle around the
    cloud, all looking at its center."""
    from gsplat_tpu_torch.core.camera import make_camera

    return [make_camera(rcw, -rcw.T @ pos, 0.9, 0.9, w, h, device=device)
            for rcw, pos in orbit_poses(n, radius, center)]


def bench_gt_scene(rng, p_gt, device):
    """bench.py's ground-truth scene (:266-274), activated."""
    import torch

    from gsplat_tpu_torch.core.quaternion import normalize

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    means = t(rng.uniform(-0.9, 0.9, (p_gt, 3)))
    scales = t(np.exp(rng.uniform(-3.2, -2.0, (p_gt, 3))))
    quats = normalize(t(rng.normal(size=(p_gt, 4))))
    opa = torch.sigmoid(t(rng.uniform(0, 3, p_gt)))
    shs = t(np.concatenate([rng.uniform(-0.5, 1.5, (p_gt, 1, 3)),
                            np.zeros((p_gt, 15, 3))], 1))
    return means, scales, quats, opa, shs


def probe_k_dup(need, chunk, headroom=1.12, floor=1 << 15):
    """bench.py's budget rule: measured demand x headroom (1.12), at least
    ``floor``, chunk-aligned."""
    return -(-max(int(need * headroom), floor) // chunk) * chunk


def cloud_state(rng, pts, sh, device):
    """create_from_points on ``pts`` (float32 [p, 3]) with uniform colours,
    the next draws of ``rng``: capacity p, SH degree ``sh``, 3-NN
    scales."""
    from gsplat_tpu_torch.model import gaussians

    p = len(pts)
    return gaussians.create_from_points(
        pts, rng.uniform(0, 1, (p, 3)).astype(np.float32), capacity=p,
        max_sh_degree=sh, device=device)


def uniform_state(rng, p, device, sh=SH_DEGREE):
    """bench.py's 100k model (:281-284): a uniform cloud in [-1, 1]^3 with
    uniform colours, SH 3 unless ``sh`` says otherwise, 3-NN scales."""
    return cloud_state(rng, rng.uniform(-1, 1, (p, 3)).astype(np.float32),
                       sh, device)


def trained_stats_state(p, sh, rng, device, stats_path=None,
                        positions="uniform"):
    """bench.trained_stats_state (bench.py:94-176): a state of capacity p
    whose opacities and log-scale triples are drawn by inverse CDF from the
    quantile tables of a trained scene (tests/fixtures/trained_stats.npz),
    log-scales shifted by -0.5 ln(P / N_source) for the density.

    Scale triples come from the per-Gaussian sorted-triple table where the
    file has one (one quantile draw a Gaussian, axes then permuted), else
    from the pooled per-axis marginal. positions="uniform": a uniform cloud
    in [-1, 1]^3; "clustered": a bootstrap resample of the file's position
    subsample with a Silverman-bandwidth jitter. Without the file: the
    uniform cloud with create_from_points' own opacity and scales. Returns
    (state, source)."""
    import dataclasses as dc

    import torch

    stats_path = stats_path or TRAINED_STATS
    st = np.load(stats_path) if os.path.exists(stats_path) else None
    if positions == "clustered" and st is not None and "xyz_sample" in st:
        src_pts = st["xyz_sample"]
        picks = rng.integers(0, len(src_pts), p)
        bw = src_pts.std(0) * (len(src_pts) ** -0.2)
        pts = (src_pts[picks]
               + rng.normal(0, 1, (p, 3)).astype(np.float32) * bw
               ).astype(np.float32)
        state = cloud_state(rng, pts, sh, device)
        pos_tag = " positions=clustered"
    else:
        state = uniform_state(rng, p, device, sh)
        pos_tag = ""
    if st is None:
        return state, "uniform-random (trained_stats.npz missing)"
    grid = np.linspace(0, 1, len(st["opacity_quantiles"]))
    opa = np.interp(rng.uniform(0, 1, p).astype(np.float32), grid,
                    st["opacity_quantiles"]).astype(np.float32)
    opa = np.clip(opa, 1e-4, 1 - 1e-4)
    if "logscale_sorted_quantiles" in st:
        sq = st["logscale_sorted_quantiles"]
        u = rng.uniform(0, 1, p).astype(np.float32)
        gridq = np.linspace(0, 1, len(sq))
        triple = np.stack([np.interp(u, gridq, sq[:, i]) for i in range(3)],
                          axis=1)
        perm = rng.permuted(np.tile(np.arange(3), (p, 1)), axis=1)
        logscale = np.take_along_axis(triple, perm, axis=1).astype(
            np.float32)
        pos_tag += " aniso-correlated"
    else:
        logscale = np.interp(
            rng.uniform(0, 1, (p, 3)).astype(np.float32),
            np.linspace(0, 1, len(st["logscale_quantiles"])),
            st["logscale_quantiles"]).astype(np.float32)
    n_src = max(int(st["n_alive"]), 1)
    logscale += np.float32(-0.5 * np.log(max(p / n_src, 1.0)))

    def t(a):
        return torch.as_tensor(a, device=state.device)

    state = dc.replace(state, opacity=t(np.log(opa / (1 - opa))[:, None]),
                       scaling=t(logscale))
    src = str(st["source"].astype(str)) if "source" in st else "stats"
    return state, f"{src} (density-corrected x{p / n_src:.0f}){pos_tag}"


def static_setup(device, gt, state, cfg, k_gt, tile):
    """A static training stage around ``state``: cfg["cams"] orbit cameras
    at cfg["width"] x cfg["height"], their ground truths (``gt`` through the
    training path at budget ``k_gt``, channel-first), num_dup on every
    camera at cfg["k_probe"] and the budget probe_k_dup of its max
    (bench.py:276-293, 386-404). Returns dict(cams, gts, state, settings,
    need)."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.raster import rasterize as rast

    bg = torch.zeros(3, device=device)
    cams = orbit_cameras(cfg["cams"], cfg["width"], cfg["height"], device)
    base = rast.RasterizeSettings(k_dup=k_gt, tile_x=tile[0],
                                  tile_y=tile[1], chunk=CHUNK, layout="chw")
    probe = dc.replace(base, k_dup=cfg["k_probe"])
    with torch.no_grad():
        gts = [rast.rasterize(*gt, c, SH_DEGREE, bg, base).image
               for c in cams]
        need = [int(renderer.render(c, state, bg, probe)["num_dup"])
                for c in cams]
    return dict(cams=cams, gts=gts, state=state, need=need,
                settings=dc.replace(base, k_dup=probe_k_dup(max(need),
                                                            CHUNK)))


def swin_setup(device, rng, cfg, p_gt, k_gt, tile):
    """The SwinGS stage (bench.py:442-469): cfg["cams"] orbit cameras, the
    ground truths (_make_scene(p_gt, cfg["sh"], seed=1) through the training
    path at budget ``k_gt``), the state from the next draws of ``rng`` (a
    cfg["cap"]-row uniform cloud with a ring of as many rows, deform), its
    frame-0 num_dup on every camera at cfg["k_probe"] and the budget with
    headroom 1.2 (the windows render other frames). Returns dict(cams, gts,
    state, settings, need)."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.model import swin
    from gsplat_tpu_torch.raster import rasterize as rast

    bg = torch.zeros(3, device=device)
    cams = orbit_cameras(cfg["cams"], cfg["width"], cfg["height"], device)
    base = rast.RasterizeSettings(k_dup=k_gt, tile_x=tile[0],
                                  tile_y=tile[1], chunk=CHUNK, layout="chw")
    scene = make_scene_params(p_gt, cfg["sh"], 1, device)
    with torch.no_grad():
        gts = [rast.rasterize(*scene, c, cfg["sh"], bg, base).image
               for c in cams]
    cap = cfg["cap"]
    pts = rng.uniform(-1, 1, (cap, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
    state = swin.create_from_points(pts, cols, cap, cfg["sh"],
                                    max_lifespan=cfg["lifespan"],
                                    buffer_size=cap, deform=True,
                                    device=device)
    probe = dc.replace(base, k_dup=cfg["k_probe"], layout="hwc")
    with torch.no_grad():
        need = [int(renderer.deformable_render(c, state, 0.0, bg,
                                               probe)["num_dup"])
                for c in cams]
    return dict(cams=cams, gts=gts, state=state, need=need,
                settings=dc.replace(probe, k_dup=probe_k_dup(
                    max(need), CHUNK, headroom=1.2)))


def render_setup(device, cfg):
    """The render stage's scene and budget (bench.py:342-360): the bare
    _make_scene(cfg["p"], 3, seed=0) scene, cfg["cams"] orbit cameras, the
    served frame (``render_frame``) at cfg["tile"] tiles; num_dup on every
    camera probed at 8 x P, the budget that max x 1.02 rounded up to chunk
    x 8. Returns dict(scene, cams, need, k_dup)."""
    import torch

    from gsplat_tpu_torch.raster import rasterize as rast

    bg = torch.zeros(3, device=device)
    scene = make_scene_params(cfg["p"], SH_DEGREE, 0, device)
    cams = orbit_cameras(cfg["cams"], cfg["width"], cfg["height"], device)
    tile_x, tile_y = cfg["tile"]
    need = max(int(rast.render_frame(*scene, c, SH_DEGREE, bg, 8 * cfg["p"],
                                     tile_x=tile_x, tile_y=tile_y)[1])
               for c in cams)
    return dict(scene=scene, cams=cams, need=need, k_dup=render_k_dup(need))


def render_k_dup(need):
    """The render stage's budget: ``need`` x 1.02 rounded up to chunk x 8
    (the probe covers the very cameras rendered, so only rounding slack)."""
    align = CHUNK * 8
    return -(-int(need * 1.02) // align) * align


# --------------------------------------------------------------- timing ----

def timed_windows(run, per_window, finish, windows=3):
    """bench.py's timing: ``windows`` windows of ``per_window`` calls
    ``run(i)`` (i counting on across the windows); each window ends on
    ``finish(last result)``, a host read of the loss or a synchronise,
    before its clock stops. Returns (ms per call of each window, finish's
    value of each)."""
    ms, out = [], []
    i = 0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            last = run(i)
            i += 1
        out.append(finish(last))
        ms.append((time.perf_counter() - t0) * 1e3 / per_window)
    return ms, out


def train_windows(call, state, adam, per_window, windows=3):
    """Timed windows of fused training steps: ``call(state, adam, it)`` ->
    (state, adam, metrics) is step ``it`` (0, 1, ...); each window
    ends on a host read of its last loss. Returns (state, adam, window ms
    per step, window losses, the max num_dup over every step, read after
    timing)."""
    carry, dups = [state, adam], []

    def run(i):
        carry[0], carry[1], m = call(carry[0], carry[1], i)
        dups.append(m.num_dup)
        return m

    ms, losses = timed_windows(run, per_window, lambda m: float(m.loss),
                               windows)
    return carry[0], carry[1], ms, losses, max(int(d) for d in dups)


def static_windows(step, state, adam, gen, st, wit):
    """bench.py's static windows: step it renders camera it % n at
    iteration it + 2 (the warm step is iteration 1 on camera 0)."""
    import torch

    cams, gts = st["cams"], st["gts"]
    bg = torch.zeros(3, device=gts[0].device)

    def call(s, a, it):
        return step(s, a, gen, cams[it % len(cams)], gts[it % len(cams)],
                    bg, float(it + 2), SH_DEGREE)

    return train_windows(call, state, adam, wit)


def swin_windows(step, state, adam, gen, st, cfg, windows=3,
                 first_frame=0.0):
    """bench.py's SwinGS windows: step it renders camera it % n at frame
    first_frame + it % lifespan, iteration it + 2."""
    import torch

    cams, gts = st["cams"], st["gts"]
    bg = torch.zeros(3, device=gts[0].device)

    def call(s, a, it):
        return step(s, a, gen, cams[it % len(cams)], gts[it % len(cams)],
                    bg, float(it + 2),
                    float(first_frame + it % cfg["lifespan"]), cfg["sh"])

    return train_windows(call, state, adam, cfg["wit"], windows)


def check_windows(where, losses, max_dup, k_dup) -> None:
    """bench.py's gates: window losses finite and all different (a broken
    synchronise or a constant step fails), no num_dup above the budget."""
    if not all(math.isfinite(x) for x in losses) or \
            len(set(losses)) != len(losses):
        raise AssertionError(f"{where}: window losses {losses}")
    if max_dup > k_dup:
        raise AssertionError(f"{where}: num_dup {max_dup} > {k_dup}")


# ------------------------------------------------- the hw-parity golden ----

# scripts/gen_hw_parity_golden.py's constants
GOLDEN = dict(p_gt=4096, p_model=8192, width=256, height=256, tile=(64, 16),
              k_dup=1 << 16, seed=0, train_sh=2, iteration=100.0)
# The golden's inference image carries the JAX kernel's bf16 log-scan of
# T and bf16 colour matmul; the port composites in float32, so the two
# differ by the golden's own rounding (61.13 dB on the CPU) while both sit
# equally far from the float32 training image. bench.py's 62 dB gate held
# Mosaic against the interpret mode of the same algorithm.
INFER_GATE_DB = 60.0
# Adam's first step moves each entry by lr * sign(grad): an entry whose
# gradient is below this share of the leaf's largest has no sign the
# golden's bf16-split arithmetic resolves (tile_kernel.py:168-176).
SIGN_FLOOR = 2e-4


def delta_rel_l2(delta, golden, grad):
    """(rel-L2 of the Adam delta against the golden, the same over the
    entries whose gradient sign is determined, count of the others)."""
    d, g = delta.astype(np.float64), golden.astype(np.float64)
    det = np.abs(grad) >= SIGN_FLOOR * np.abs(grad).max()

    def rel(mask):
        return float(np.linalg.norm((d - g)[mask])
                     / (np.linalg.norm(g[mask]) + 1e-12))
    return rel(np.ones_like(det)), rel(det), int((~det).sum())


def golden_inputs(device):
    """scripts/gen_hw_parity_golden.py::build_inputs without JAX: the
    4096-Gaussian _make_scene(seed=0), orbit camera 1 of 3 at 256x256, the
    8192-row model from default_rng(1), the structured ground truth, the
    settings, and a generator seeded 7 (the noise draws are the port's, not
    JAX's PRNGKey(7))."""
    import torch

    from gsplat_tpu_torch.raster import rasterize as rast

    g = GOLDEN
    w, h, p = g["width"], g["height"], g["p_model"]
    rng = np.random.default_rng(g["seed"] + 1)
    pts = rng.uniform(-1.2, 1.2, (p, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2.0, 6.0, p)
    colors = rng.uniform(0, 1, (p, 3)).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    gt = torch.as_tensor(np.stack([xx, yy, 0.5 * (xx + yy)], 0).astype(
        np.float32), device=device)
    return dict(
        scene=make_scene_params(g["p_gt"], SH_DEGREE, g["seed"], device),
        cam=orbit_cameras(3, w, h, device)[1], pts=pts, colors=colors,
        gt=gt, bg=torch.zeros(3, device=device),
        settings=rast.RasterizeSettings(k_dup=g["k_dup"], tile_x=g["tile"][0],
                                        tile_y=g["tile"][1], chunk=CHUNK),
        gen=generator(device, 7))


def golden_replay(inp):
    """The golden's computation through the port: the training and
    inference renders, one train step as grad + apply (to keep the
    gradients); images, loss, num_dup and the opacity / scaling Adam
    deltas against the golden (the xyz delta carries the noise, whose
    draws are not JAX's: logged, not gated). Gates: training image >= 85
    dB, inference image >= INFER_GATE_DB, loss rel <= 1e-4, num_dup rel <=
    1e-3, deltas rel-L2 <= 3e-2 over the entries whose gradient is >=
    SIGN_FLOOR of the leaf's max. Returns the measured values; raises on a
    miss."""
    import torch

    from gsplat_tpu_torch.model import gaussians, optim
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    golden = np.load(HW_GOLDEN)
    g, settings = GOLDEN, inp["settings"]
    cam, gt, bg = inp["cam"], inp["gt"], inp["bg"]
    with torch.no_grad():
        train_img = rast.rasterize(*inp["scene"], cam, SH_DEGREE, bg,
                                   settings).image
    infer_img = rast.render_image(*inp["scene"], cam, SH_DEGREE, bg,
                                  settings.k_dup, tile_x=settings.tile_x,
                                  tile_y=settings.tile_y)[0].float()
    state = gaussians.create_from_points(inp["pts"], inp["colors"],
                                         g["p_model"], SH_DEGREE,
                                         device=gt.device)
    opt = OptimizationConfig()
    grads, m = step_lib.make_grad_step(opt, settings, SPATIAL_LR_SCALE)(
        state, cam, gt, bg, g["train_sh"])
    new, _ = step_lib.make_apply_step(opt, SPATIAL_LR_SCALE)(
        state, optim.init(state.params()), grads, inp["gen"],
        g["iteration"], True)

    def psnr_db(a, b):
        mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
        return min(-10.0 * np.log10(mse + 1e-30), 99.0)

    def host(t):
        return t.detach().cpu().numpy()

    res = dict(
        train_psnr=psnr_db(host(train_img), golden["train_img"]),
        infer_psnr=psnr_db(host(infer_img), golden["infer_img"]),
        infer_vs_golden_train_psnr=psnr_db(
            host(infer_img), golden["train_img"].transpose(2, 0, 1)),
        golden_infer_vs_golden_train_psnr=psnr_db(
            golden["infer_img"], golden["train_img"].transpose(2, 0, 1)),
        loss=float(m.loss), golden_loss=float(golden["loss"]),
        num_dup=int(m.num_dup), golden_num_dup=int(golden["num_dup"]))
    for key, leaf in (("dopacity", "opacity"), ("dscaling", "scaling"),
                      ("dxyz", "xyz")):
        raw, det, n_undet = delta_rel_l2(
            host(getattr(new, leaf) - getattr(state, leaf)), golden[key],
            host(grads[leaf]))
        res[f"{key}_rel"], res[f"{key}_rel_determined"] = raw, det
        res[f"{key}_undetermined_entries"] = n_undet
    res["loss_rel"] = abs(res["loss"] - res["golden_loss"]) / abs(
        res["golden_loss"])
    res["num_dup_rel"] = abs(res["num_dup"] - res["golden_num_dup"]) / max(
        res["golden_num_dup"], 1)
    gates = [res["train_psnr"] >= 85.0, res["infer_psnr"] >= INFER_GATE_DB,
             res["loss_rel"] <= 1e-4, res["num_dup_rel"] <= 1e-3,
             res["dopacity_rel_determined"] <= 3e-2,
             res["dscaling_rel_determined"] <= 3e-2]
    if not all(gates):
        raise AssertionError(f"golden replay gates failed: {res}")
    return res


# --------------------------------------------------------------- stages ----

def hw_parity_stage(device, rng):
    """Hardware-vs-golden parity first (bench.py:179-235): if the kernels
    drifted from the golden, fail before reporting any speed.
    ``hw_parity_param_delta_rel`` is bench.py's: the largest unmasked
    rel-L2 of the xyz, opacity and scaling deltas, here ungated;
    ``hw_parity_param_delta_rel_masked`` is the opacity / scaling value
    golden_replay gates. Draws nothing from ``rng``."""
    del rng
    res = golden_replay(golden_inputs(device))
    delta = max(res["dxyz_rel"], res["dopacity_rel"], res["dscaling_rel"])
    masked = max(res["dopacity_rel_determined"],
                 res["dscaling_rel_determined"])
    log(f"hw parity: train {res['train_psnr']:.1f} dB, infer "
        f"{res['infer_psnr']:.1f} dB, loss_rel {res['loss_rel']:.2e}, "
        f"dup_rel {res['num_dup_rel']:.2e}, param_delta_rel {delta:.2e} "
        f"(masked {masked:.2e})")
    return {"hw_parity_psnr": round(min(res["train_psnr"],
                                        res["infer_psnr"]), 1),
            "hw_parity_train_psnr": round(res["train_psnr"], 1),
            "hw_parity_infer_psnr": round(res["infer_psnr"], 1),
            "hw_parity_loss_rel": float(f"{res['loss_rel']:.2e}"),
            "hw_parity_param_delta_rel": float(f"{delta:.2e}"),
            "hw_parity_param_delta_rel_masked": float(f"{masked:.2e}")}


def train_stage(device, rng, gt):
    """100k Gaussians at 800x800, the full fused step (bench.py:254-335):
    the state from the next draws of ``rng``, ground truths of ``gt``.
    Returns bench.py's top-level keys with the stage's config keys."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    cfg = sizes(device)["train"]
    state = uniform_state(rng, cfg["p"], device)
    st = static_setup(device, gt, state, cfg, cfg["k_probe"], bench_tile())
    settings = st["settings"]
    log(f"dup budget {settings.k_dup} (need {max(st['need'])})")
    step = step_lib.make_train_step(OptimizationConfig(), settings,
                                    SPATIAL_LR_SCALE)
    gen = generator(device, 0)
    state, adam, m = step(state, optim.init(state.params()), gen,
                          st["cams"][0], st["gts"][0],
                          torch.zeros(3, device=device), 1.0, SH_DEGREE)
    float(m.loss)
    log("warm")
    _, _, ms, losses, max_dup = static_windows(step, state, adam, gen, st,
                                               cfg["wit"])
    check_windows("train", losses, max_dup, settings.k_dup)
    rates = [1e3 / x for x in ms]
    its = statistics.median(rates)
    log(f"train windows {[round(r, 2) for r in rates]} it/s, losses "
        f"{losses}, maxdup {max_dup} / budget {settings.k_dup}")
    return {"metric": "train_iters_per_sec", "value": round(its, 2),
            "unit": "it/s",
            "vs_baseline": round(its / A100_BASELINE_ITERS_PER_SEC, 3),
            "config": {"gaussians": cfg["p"],
                       "image": f"{cfg['width']}x{cfg['height']}",
                       "tile": f"{settings.tile_x}x{settings.tile_y}",
                       "backend": torch.device(device).type,
                       "k_dup": settings.k_dup,
                       "ms_per_iter": round(1000.0 / its, 2),
                       "windows_it_per_s": [round(r, 2) for r in rates]}}


def render_stage(device, rng):
    """The served frame (``render_frame``) at 1920x1088 with 128x32 tiles
    on the bare 100k scene (bench.py:337-376): the probe, one pass over
    the cameras, then 3 windows of 48 frames (camera i % 8), each ending
    on a synchronise. Draws nothing from ``rng``."""
    del rng
    import torch

    from gsplat_tpu_torch.raster import rasterize as rast

    cfg = sizes(device)["render"]
    rs = render_setup(device, cfg)
    cams, k_dup = rs["cams"], rs["k_dup"]
    tile_x, tile_y = cfg["tile"]
    log(f"render dup budget {k_dup} (need {rs['need']})")
    bg = torch.zeros(3, device=device)

    def run(i):
        return rast.render_frame(*rs["scene"], cams[i % len(cams)],
                                 SH_DEGREE, bg, k_dup, tile_x=tile_x,
                                 tile_y=tile_y)[0]

    def done(img):
        sync(device)
        return img

    for i in range(len(cams)):
        run(i)
    sync(device)
    ms, imgs = timed_windows(run, cfg["frames"], done)
    img = imgs[-1].float() / 255
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0.05):
        raise AssertionError("render produced a degenerate image")
    fps = statistics.median(1e3 / x for x in ms)
    image = f"{cfg['width']}x{cfg['height']}"
    log(f"render {image}: {fps:.1f} FPS")
    return {"render_fps_1080p": round(fps, 1), "render_image": image,
            "render_num_dup": rs["need"], "render_ms": round(1000.0 / fps, 2)}


def train_1m_stage(device, rng, gt, k_gt):
    """cap_max 1M at 1296x840 (bench.py:378-430): the state from the next
    draws of ``rng`` with trained-scene statistics, ground truths of ``gt``
    at the 100k stage's budget ``k_gt``."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    cfg = sizes(device)["train_1m"]
    state, src = trained_stats_state(cfg["p"], SH_DEGREE, rng, device)
    log(f"1M workload opacity/scale source: {src}")
    st = static_setup(device, gt, state, cfg, k_gt, bench_tile())
    settings = st["settings"]
    log(f"1M dup budget {settings.k_dup} (need {max(st['need'])})")
    step = step_lib.make_train_step(OptimizationConfig(), settings,
                                    SPATIAL_LR_SCALE)
    gen = generator(device, 0)
    state, adam, m = step(state, optim.init(state.params()), gen,
                          st["cams"][0], st["gts"][0],
                          torch.zeros(3, device=device), 1.0, SH_DEGREE)
    float(m.loss)
    _, _, ms, losses, max_dup = static_windows(step, state, adam, gen, st,
                                               cfg["wit"])
    check_windows("train_1m", losses, max_dup, settings.k_dup)
    ms_it = statistics.median(ms)
    image = f"{cfg['width']}x{cfg['height']}"
    log(f"1M-cap {image}: {ms_it:.1f} ms/it (windows {ms}, losses "
        f"{losses}, maxdup {max_dup} / budget {settings.k_dup})")
    return {"train_1m_ms_per_iter": round(ms_it, 1),
            "train_1m_vs_anchor": round(A100_1M_MS_PER_ITER / ms_it, 3),
            "train_1m_workload": src, "train_1m_gaussians": cfg["p"],
            "train_1m_image": image, "train_1m_num_dup": max(st["need"]),
            "train_1m_windows_ms": [round(x, 1) for x in ms]}


def swin_stage(device, rng, k_gt):
    """The sliding-window step at the run_exp1 scale (bench.py:432-493):
    the state from the next draws of ``rng``, ground truths at the 100k
    stage's budget ``k_gt``."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig

    size = sizes(device)
    cfg = size["swin"]
    st = swin_setup(device, rng, cfg, size["p_gt"], k_gt, bench_tile())
    settings = st["settings"]
    log(f"swin dup budget {settings.k_dup} (need {max(st['need'])})")
    step = swin_step.make_swin_train_step(OptimizationConfig(), settings,
                                          SPATIAL_LR_SCALE)
    gen = generator(device, 0)
    state = st["state"]
    state, adam, m = step(state, optim.init(state.params()), gen,
                          st["cams"][0], st["gts"][0],
                          torch.zeros(3, device=device), 1.0, 0.0, cfg["sh"])
    float(m.loss)
    _, _, ms, losses, max_dup = swin_windows(step, state, adam, gen, st, cfg)
    check_windows("swin", losses, max_dup, settings.k_dup)
    ms_it = statistics.median(ms)
    image = f"{cfg['width']}x{cfg['height']}"
    log(f"swin cap {cfg['cap']} {image}: {ms_it:.1f} ms/it (windows {ms}, "
        f"losses {losses})")
    return {"swin_ms_per_iter": round(ms_it, 1), "swin_cap": cfg["cap"],
            "swin_image": image, "swin_windows_ms": [round(x, 1) for x in ms]}


def run(device) -> dict:
    """Every stage in bench.py's order, each stage's wall seconds (set-up
    included) logged; the result line as a dict."""
    def timed(stage, *args):
        t0 = time.perf_counter()
        part = stage(device, *args)
        log(f"{stage.__name__}: {time.perf_counter() - t0:.1f} s")
        return part

    rng = np.random.default_rng(0)
    parity = timed(hw_parity_stage, rng)
    gt = bench_gt_scene(rng, sizes(device)["p_gt"], device)
    log("gt scene drawn")
    out = timed(train_stage, rng, gt)
    render = timed(render_stage, rng)
    k_gt = out["config"]["k_dup"]
    m1 = timed(train_1m_stage, rng, gt, k_gt)
    swin = timed(swin_stage, rng, k_gt)
    out["config"].update(device=card() if device == "cuda" else "cpu",
                         **render, **m1, **swin, **parity)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu for bench.py's CPU "
                         "sizes on the plain versions")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({
            "metric": "train_iters_per_sec", "value": 0.0, "unit": "it/s",
            "vs_baseline": 0.0,
            "config": {"error": "CUDA device unavailable: "
                                "torch.cuda.is_available() is False"}}))
        return 1
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
