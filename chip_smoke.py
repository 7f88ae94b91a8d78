#!/usr/bin/env python3
"""On-card smoke test of gsplat_tpu_torch (one NVIDIA GPU): the serving
path, the static training path and SwinGS training and playback.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the CUDA kernels from gsplat_tpu_torch/csrc, then

- serves a 100k-Gaussian SH-3 model (written as a PLY from a seed) at
  cap_max 1M and 1920x1088 through the port's own entry points, in the
  server's two owner-expansion settings:
    expand   k_dup = 8 x cap_max = 8,000,000 (the server's default):
             scatter-max + the expand_scan kernel (2 k_dup >= 7 P)
    merge    --dup_budget 877,568 (raised by the 1.02 rule if a camera
             needs more): the merge_expand kernel (2 k_dup < 7 P)
- trains in bench.py's two static settings (its recipes copied here):
    100k-800x800  100k Gaussians, 8 orbit cameras, 64x16 tiles; the
                  per-Gaussian gradient reduction is one scatter-add
    1m-1296x840   1M Gaussians with trained-scene opacity/scale
                  statistics, 4 cameras; the reduction is sort +
                  multi_cumsum (P > 250k rows)
  both binning through merge_expand;
- trains in bench.py's SwinGS setting (bench.py:432-493, its draws
  continued): 200k immature rows + a 200k-row matured ring (a 400k-row
  union), swin 8, SH 1, deform, 1280x720, 4 cameras; merge_expand and the
  multi_cumsum reduction; then slides the window and runs the SwinGS CLI
  and its stream playback on the committed dynamic fixture.

Phases, one JSON line each; any failure raises and exits non-zero before
the result line is printed:

  build        compile the kernels (seconds)
  probe        serving: num_dup of the 8 orbit cameras; the merge budget;
               kernel inputs captured from the first camera of each setting
  kernel       each serving kernel against its plain PyTorch version on
               those inputs: expand_scan and merge_expand bit-equal, the
               render within two bf16 ULPs, and two launches of the render
               and of expand_scan each bit-equal; CUDA-event times; the
               render's pairs that pass 1/255 (bound_ms counts those
               alone, bound_all_pairs_ms every pair of the visited chunks)
               and the share of (warp block / sub-block, slot) pairs its
               cull keeps; and
               multi_cummax (on no path) bit-equal to torch.cummax at
               3 x 8M, beside torch.cummax's time
  small        a 300-Gaussian scene rendered on the card vs the port on
               the CPU
  serve        per setting, launch counts zeroed, its 8 cameras rendered
               through viewer.serve.make_render_fn, counts read
  socket       python -m gsplat_tpu_torch.viewer.serve per setting, 3 SIBR
               requests; reply bytes must equal the in-process image
  fps          frames/s over 3 windows of 48 frames per setting
  quality      the served frame vs the plain render of an f32 stream
  train_probe  per training setting (swin too, at frame 0): num_dup per
               camera against the TPU record (rel <= 1e-3, bench.py's
               gate), the probed k_dup
  kernel       the blend forward and backward and multi_cumsum against
               their plain versions on the inputs of each setting's first
               step (and merge_expand at the swin setting's) (forward:
               colour and T within 1e-5, used > 0 per slot identical;
               backward: each dfeat row within 1e-4 of its max,
               two launches bit-equal; multi_cumsum: 2e-3 + 1e-5 |x| of a
               float64 cumsum, two launches bit-equal); times; for the
               blends also the pairs that
               pass 1/255 (bound_ms counts those alone; bound_all_pairs_ms
               every pair whose pixel is not done) and the
               share of (warp, slot) pairs the kernels' cull keeps
  large_tile   one step of the 100k setting at 128x32 tiles and 256-slot
               chunks (the blends in pixel groups and chunk pieces): both
               blends against plain with the kernel phase's gates
  kernel_yardstick  merge_expand beside its bound and torch.searchsorted
               per setting (owners only: a partial yardstick, not the same
               function)
  train_small  tests/fixtures/hw_parity_golden.npz replayed without JAX:
               bench.py's gates, then one split densify iteration
  train        per setting, counts zeroed: one warm step, 3 windows of
               fused steps (20 / 10), counts read and held to one blend
               forward, one blend backward and one merge_expand per step
               (multi_cumsum one per step at 1M, none at 100k); then one
               untimed split densify iteration
  cli          python -m gsplat_tpu_torch.train.train_static on the
               committed Blender fixture (300 iterations), held-out PSNR
               >= 21.0 dB
  swin_train   counts zeroed: one warm step and 3 windows of 10 fused
               swin steps (frame it % 8, camera it % 4), one blend
               forward, blend backward, merge_expand and multi_cumsum a
               step and nothing else
  swin_slide   decay_genesis -> tick -> evolve (ring + stream_dump +
               rollover) -> densify -> one window of steps in the new
               window; matured rows active and rendered, records = matured
  swin_cli     train_swin.main on the dynamic fixture (the flags of
               tests/test_stream_semantic.py), stream playback vs the
               direct render (>= 24 dB) and vs GT (>= 15 dB), then
               render_stream.main: one render and one owner expansion a
               view
  profile      device time by kernel, serving, after every unprofiled
               timing (the port's kernels each by name: their own device
               time); the idle share against the unprofiled frame time
  train_profile  the same for 3 training steps per setting
  swin_profile   the same for 3 swin steps

Then the card's name and power limit (nvidia-smi), the kernels line and
{"ok": true, "device": {...}} as the last line. Exits non-zero with no
result when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
WORK = os.path.join(ROOT, "build", "chip_smoke")
WIDTH, HEIGHT = 1920, 1088
N_GAUSS, CAP_MAX, SH_DEGREE = 100_000, 1_000_000, 3
MERGE_BUDGET = 877_568
MEM_BPS = 3.35e12      # H100 SXM HBM3, bytes/s
FP32_OPS = 67e12       # H100 SXM float32 outside the tensor cores, op/s
# float operations per (pixel, slot) pair in render_kernel.cu: 11 for the
# quadratic form, exp, opa scale, clamp, two tests, weight, 3 FMAs (6),
# 1 - alpha and the transmittance product
RENDER_OPS_PER_PAIR = 25


# the keys of each kernel's entry on the kernels line (the blends add
# bound_all_pairs_ms; the phase lines carry more: shapes, flips, cull
# statistics)
KERNEL_LINE_KEYS = ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "bound_all_pairs_ms")


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- scene ----

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


def write_scene_ply(path: str, p: int, sh_degree: int, seed: int = 0):
    """The bench's render-stage model as a PLY."""
    from gsplat_tpu_torch.data import ply

    means, log_scales, quats, opa_logit, shs = scene_arrays(p, sh_degree,
                                                            seed)
    ply.save_gaussian_ply(path, means, shs[:, :1], shs[:, 1:],
                          opa_logit[:, None], log_scales, quats)


def orbit_cameras(n, w, h, device, radius=6.0, center=(0.0, 0.0, 4.0)):
    """__graft_entry__._orbit_cameras: n cameras on a circle around the
    cloud, all looking at its center."""
    from gsplat_tpu_torch.core.camera import make_camera

    c = np.asarray(center)
    cams = []
    for i in range(n):
        th = 2 * np.pi * i / max(n, 1)
        pos = c + radius * np.array([np.sin(th), 0.0, -np.cos(th)])
        fwd = (c - pos) / radius
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        rcw = np.stack([right, up, fwd], 1)
        cams.append(make_camera(rcw, -rcw.T @ pos, 0.9, 0.9, w, h,
                                device=device))
    return cams


# -------------------------------------------------------------- helpers ----

class _ModuleProxy:
    """``module`` with one attribute replaced."""

    def __init__(self, module, attr, value):
        self._module, self._attr, self._value = module, attr, value

    def __getattr__(self, name):
        return self._value if name == self._attr else getattr(self._module,
                                                              name)


@contextlib.contextmanager
def capture(caller, name: str, store: list, attr: str | None = None):
    """Record the arguments of the calls ``caller`` makes to its global
    ``name`` (to ``name.attr`` when ``name`` is a module it imported); the
    call still runs. Only the caller's reference is replaced, so a wrapper
    that counts its launches through its own module still finds itself."""
    orig = getattr(caller, name)
    target = getattr(orig, attr) if attr else orig

    def recorder(*args, **kw):
        store.append((args, kw))
        return target(*args, **kw)

    setattr(caller, name,
            _ModuleProxy(orig, attr, recorder) if attr else recorder)
    try:
        yield
    finally:
        setattr(caller, name, orig)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations")."""
    tb, to = nbytes / MEM_BPS, ops / FP32_OPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def searchsorted_ms(starts, k):
    """A partial yardstick for merge_expand, not its library_ms:
    torch.searchsorted at its shapes finds the owners only (pack[g] and
    starts[g], the kernel's other outputs, are not in it)."""
    import torch

    d = torch.arange(k, dtype=torch.int32, device=starts.device)
    return cuda_ms(lambda: torch.searchsorted(starts, d, right=True), 20)


def within_bf16_ulps(got, want, ulps: int = 2) -> bool:
    """|got - want| <= ``ulps`` bf16 ULPs of the larger magnitude."""
    import torch

    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulps * ulp).all())


def psnr(a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return -10.0 * math.log10(mse) if mse > 0 else float("inf")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sibr_request(cam, keep_alive: bool = True) -> dict:
    """A viewer request as the SIBR remote viewer sends it: row-major
    matrices in the reference's transposed layout, Y/Z columns negated."""
    view = cam.view.cpu().numpy().T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    full = cam.full_proj.cpu().numpy().T.copy()
    full[:, 1] *= -1
    fov = 2 * math.atan(float(cam.tan_fovx))
    return {"resolution_x": cam.width, "resolution_y": cam.height,
            "train": False, "fov_x": fov,
            "fov_y": 2 * math.atan(float(cam.tan_fovy)),
            "z_near": 0.01, "z_far": 100.0, "shs_python": False,
            "rot_scale_python": False, "keep_alive": keep_alive,
            "scaling_modifier": 1.0,
            "view_matrix": view.reshape(-1).tolist(),
            "view_projection_matrix": full.reshape(-1).tolist()}


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("server closed the connection")
        buf += chunk
    return bytes(buf)


# --------------------------------------------------------------- phases ----

def probe_serving(card_name):
    """The serving setup: the 100k-Gaussian model written as a PLY (under
    ``model_dir``) and loaded at cap_max 1M, the 8 orbit cameras, num_dup
    per camera, the
    two settings' k_dup and render functions, and the kernel inputs
    recorded from camera 0 of each setting (``cap``: expand_scan,
    merge_expand, render_forward; ``store`` also holds _slot_features)."""
    import torch

    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster import binning
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.viewer import serve

    model_dir = os.path.join(WORK, "model")
    ply_path = os.path.join(model_dir, "point_cloud", "iteration_1",
                            "point_cloud.ply")
    write_scene_ply(ply_path, N_GAUSS, SH_DEGREE, seed=0)
    state = gaussians.load_ply(ply_path, capacity=CAP_MAX,
                               max_sh_degree=SH_DEGREE, device=DEVICE)
    cams = orbit_cameras(8, WIDTH, HEIGHT, DEVICE)
    p = state.capacity

    # num_dup per camera; kernel inputs of camera 0
    k_expand = 8 * CAP_MAX
    settings = rast.RasterizeSettings(k_dup=k_expand, inference=True,
                                      tile_x=serve.TILE_X,
                                      tile_y=serve.TILE_Y)
    bg = torch.zeros(3, device=DEVICE)
    cap = {}
    store = {k: [] for k in ("expand_scan", "merge_expand", "render_forward",
                             "_slot_features")}
    need = []
    for i, cam in enumerate(cams):
        with contextlib.ExitStack() as st:
            if i == 0:
                st.enter_context(capture(binning, "expand_scan",
                                         store["expand_scan"]))
                st.enter_context(capture(rast, "tile_kernel",
                                         store["render_forward"],
                                         attr="render_forward"))
                st.enter_context(capture(rast, "_slot_features",
                                         store["_slot_features"]))
            out = rast.rasterize(state.xyz, state.get_scaling(),
                                 state.get_rotation(),
                                 state.get_opacity()[:, 0],
                                 state.get_features(), cam, SH_DEGREE, bg,
                                 settings, alive=state.alive_mask)
            need.append(int(out.num_dup))
    k_merge = MERGE_BUDGET
    if max(need) > k_merge:   # bench.py's rule: need x 1.02 to 1024
        k_merge = -(-int(max(need) * 1.02) // 1024) * 1024
    if not (2 * k_expand >= 7 * p and 2 * k_merge < 7 * p):
        raise AssertionError("settings do not take both expansion branches")
    render_fns = {"expand": serve.make_render_fn(state, k_expand, WIDTH,
                                                 HEIGHT, DEVICE),
                  "merge": serve.make_render_fn(state, k_merge, WIDTH,
                                                HEIGHT, DEVICE)}
    with capture(binning, "merge_expand", store["merge_expand"]):
        render_fns["merge"](cams[0])
    for key in ("expand_scan", "merge_expand", "render_forward"):
        if not store[key]:
            raise AssertionError(f"the main path did not call {key}")
        cap[key] = store[key][0]
    log("probe", card=card_name, gaussians=state.n_alive, capacity=p,
        num_dup=need, k_dup={"expand": k_expand, "merge": k_merge})
    return dict(cams=cams, model_dir=model_dir,
                k_dup={"expand": k_expand, "merge": k_merge},
                render_fns=render_fns, store=store, cap=cap)


def render_kwargs(cap_render):
    """(feat, chunk_meta, bg, wrapper keyword arguments) from a recorded
    render_forward call."""
    args, kw = cap_render
    feat, meta, bg = args[:3]
    return feat, meta, bg, dict(zip(("num_tiles", "n_pix", "tile_x",
                                     "tile_y", "grid_x", "chunk"), args[3:]),
                                **kw)


def check_render(render, feat, meta, bg, rkw, want):
    """One build's render (a callable with the wrapper's signature) against
    the plain version's image ``want``: within two bf16 ULPs, and two
    launches bit-equal. Returns the max abs error."""
    import torch

    got = render(feat, meta, bg, **rkw)
    again = render(feat, meta, bg, **rkw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not within_bf16_ulps(got.float(), want.float()):
        raise AssertionError(f"render_forward differs from plain by more "
                             f"than 2 bf16 ULPs (max abs {err})")
    if not torch.equal(got, again):
        raise AssertionError("two render_forward launches differ")
    return err


def check_expand(expand, marks, base_in, want):
    """One build's expand_scan against the plain outputs ``want``: bit-equal,
    and two launches bit-equal. Returns the max abs difference (0)."""
    import torch

    got = expand(marks, base_in)
    again = expand(marks, base_in)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"expand_scan differs from plain: {err}")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("two expand_scan launches differ")
    return float(err)


def check_kernels(cap, card_name):
    """Each kernel vs its plain version on main-path inputs; returns the
    kernels-line entries (launch counts filled in later)."""
    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel

    out = {}
    (marks, base_in), _ = cap["expand_scan"]
    k = marks.shape[0]
    err = check_expand(scan_kernel.expand_scan, marks, base_in,
                       scan_kernel.expand_scan_plain(marks, base_in))
    nbytes = 20 * k            # 2 int32 in, 3 int32 out per slot
    out["expand_scan"] = dict(
        name="expand_scan", route="cuda",
        source="gsplat_tpu_torch/csrc/scan_kernels.cu",
        replaces="gsplat_tpu/raster/scan_kernel.py:202",
        max_abs_err=err,
        ms=cuda_ms(lambda: scan_kernel.expand_scan(marks, base_in), 20),
        plain_ms=cuda_ms(lambda: scan_kernel.expand_scan_plain(marks,
                                                               base_in), 5),
        bound_ms=nbytes / MEM_BPS * 1e3, bound_by="bytes", library_ms=None,
        repeat_bit_equal=True, shape=f"K={k}")
    log("kernel", card=card_name, **out["expand_scan"])

    (starts, pack, kk), _ = cap["merge_expand"]
    out["merge_expand"] = check_merge_expand(starts, pack, kk, card_name)

    feat, meta, bg, rkw = render_kwargs(cap["render_forward"])
    stats = {}
    want, visits = tile_kernel.render_plain_with_visits(feat, meta, bg,
                                                        **rkw, stats=stats)
    err = check_render(tile_kernel.render_forward, feat, meta, bg, rkw, want)
    out["render_forward"] = dict(
        name="render_forward", route="cuda",
        source="gsplat_tpu_torch/csrc/render_kernel.cu",
        replaces="gsplat_tpu/raster/tile_kernel.py:816", max_abs_err=err,
        ms=cuda_ms(lambda: tile_kernel.render_forward(feat, meta, bg,
                                                      **rkw), 10),
        plain_ms=cuda_ms(lambda: tile_kernel.render_forward_plain(
            feat, meta, bg, **rkw), 2),
        **render_bounds(feat, meta, rkw, visits, stats), library_ms=None,
        repeat_bit_equal=True)
    log("kernel", card=card_name, **out["render_forward"])
    return out


def render_bounds(feat, meta, rkw, visits, stats):
    """The render's bounds from the plain version's ``stats``: bound_ms
    over the (pixel, slot) pairs of the visited chunks that pass 1/255 (the
    work this frame's data needs), bound_all_pairs_ms over every pair of
    those chunks (the first kernel's count); the cull's kept shares of
    (16 x 8 warp block, slot) and (8 x 4 sub-block, slot) pairs; the
    shape."""
    from gsplat_tpu_torch.raster import tile_kernel

    chunk, n_pix = rkw["chunk"], rkw["n_pix"]
    visited = int(visits.sum())
    # the chunks the tile-wide stop lets each tile visit (18 B of bf16
    # features per slot), plus meta and the image
    nbytes = (visited * chunk * 18 + meta.numel() * 4 + 12
              + rkw["num_tiles"] * 3 * n_pix * 2)
    b_ms, b_by = bound(nbytes, stats["passing"] * RENDER_OPS_PER_PAIR)
    f32 = feat.float()
    return dict(
        bound_ms=b_ms, bound_by=b_by,
        bound_all_pairs_ms=bound(nbytes, visited * chunk * n_pix
                                 * RENDER_OPS_PER_PAIR)[0],
        passing_pairs=stats["passing"],
        kept_slot_share={
            "warp_block": kept_slot_share(f32, meta, stats["visited"], rkw,
                                          tile_kernel.BLEND_WARP_BLOCK),
            "sub_block": kept_slot_share(f32, meta, stats["visited"], rkw,
                                         tile_kernel.BLEND_SUB_BLOCK)},
        shape=f"tiles={rkw['num_tiles']} slots={feat.shape[1]} "
              f"visited_chunks={visited} "
              f"pairs={visited * chunk * n_pix}")


def merge_bound(p, k):
    """merge_expand's bound at P starts and K slots: the function's bytes,
    starts and pack read once and three int32 written a slot (whatever
    algorithm computes it)."""
    return dict(zip(("bound_ms", "bound_by"), bound(8 * p + 12 * k, 0)))


def check_merge_expand(starts, pack, kk, card_name, **extra):
    """merge_expand bit-equal to its plain version on main-path inputs;
    returns its kernels-line entry."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    got = scan_kernel.merge_expand(starts, pack, kk)
    again = scan_kernel.merge_expand(starts, pack, kk)
    want = scan_kernel.merge_expand_plain(starts, pack, kk)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"merge_expand differs from plain: {err}")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("two merge_expand launches differ")
    p = starts.shape[0]
    entry = dict(
        name="merge_expand", route="cuda",
        source="gsplat_tpu_torch/csrc/scan_kernels.cu",
        replaces="gsplat_tpu/raster/scan_kernel.py:260",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: scan_kernel.merge_expand(starts, pack, kk), 20),
        plain_ms=cuda_ms(lambda: scan_kernel.merge_expand_plain(
            starts, pack, kk), 5),
        **merge_bound(p, kk),
        library_ms=None, owners_only_searchsorted_ms=searchsorted_ms(
            starts, kk), shape=f"P={p} K={kk}", **extra)
    log("kernel", card=card_name, **entry)
    return entry


CUMMAX_SHAPE = (3, 8_000_000)


def check_multi_cummax(card_name):
    """multi_cummax (on no path of the system) bit-equal to torch.cummax
    per row at n = 3, K = 8M, values drawn from numpy's generator at seed
    0, INT_MIN in a prefix of row 0 (the TPU wrapper's padding value)."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    n, k = CUMMAX_SHAPE
    rng = np.random.default_rng(0)
    host = rng.integers(-2**31, 2**31, size=(n, k), dtype=np.int64)
    host[0, :4096 + 77] = -2**31
    x = torch.as_tensor(host.astype(np.int32), device=DEVICE)
    got = scan_kernel.multi_cummax(x)
    want = scan_kernel.multi_cummax_plain(x)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"multi_cummax differs from plain: {err}")
    entry = dict(
        name="multi_cummax", route="cuda",
        source="gsplat_tpu_torch/csrc/scan_kernels.cu",
        replaces="gsplat_tpu/raster/scan_kernel.py:66",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: scan_kernel.multi_cummax(x), 20),
        plain_ms=cuda_ms(lambda: scan_kernel.multi_cummax_plain(x), 20),
        bound_ms=2 * n * k * 4 / MEM_BPS * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.cummax(x, dim=1), 20),
        shape=f"n={n} K={k}")
    log("kernel", card=card_name, **entry)
    return entry


def check_small(card_name):
    """300 Gaussians, 256x64 at 128x32 tiles: card vs the CPU port."""
    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster.rasterize import RasterizeSettings

    rng = np.random.default_rng(1)
    cap, n = 400, 300
    par = {"xyz": np.zeros((cap, 3)), "f_dc": np.zeros((cap, 1, 3)),
           "f_rest": np.zeros((cap, 3, 3)), "opacity": np.zeros((cap, 1)),
           "scaling": np.zeros((cap, 3)), "rotation": np.zeros((cap, 4))}
    par["xyz"][:n] = np.c_[rng.uniform(-1.2, 1.2, (n, 2)),
                           rng.uniform(2, 6, n)]
    par["f_dc"][:n] = 1.0 + 0.3 * rng.normal(size=(n, 1, 3))
    par["f_rest"][:n] = 0.3 * rng.normal(size=(n, 3, 3))
    par["opacity"][:n] = rng.uniform(-2, 6, (n, 1))
    par["scaling"][:n] = rng.uniform(-3.5, -1.5, (n, 3))
    par["rotation"][:n] = rng.normal(size=(n, 4))
    settings = RasterizeSettings(k_dup=1536, tile_x=128, tile_y=32,
                                 inference=True)
    imgs = []
    for dev in ("cpu", DEVICE):
        state = gaussians.state_from_numpy(par, n, 1, dev)
        cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 256, 64,
                          device=dev)
        imgs.append(renderer.render(cam, state, [0.2, 0.3, 0.4], settings))
    torch.cuda.synchronize()
    want, got = imgs[0]["render"].float(), imgs[1]["render"].float().cpu()
    if int(imgs[0]["num_dup"]) != int(imgs[1]["num_dup"]):
        raise AssertionError("num_dup differs between card and CPU")
    if not within_bf16_ulps(got, want):
        raise AssertionError("small scene: card vs CPU port beyond 2 ULPs")
    log("small", card=card_name, num_dup=int(imgs[1]["num_dup"]),
        max_abs_err=float((got - want).abs().max()), mean=float(got.mean()))


def socket_phase(model_dir, setting, k_dup, cams, render_fn, card_name):
    """Serve 3 keep-alive requests from a server subprocess; compare the
    reply bytes with the in-process render of the same decoded camera."""
    from gsplat_tpu_torch.viewer import network_gui

    port = free_port()
    log_path = os.path.join(WORK, f"serve_{setting}.log")
    cmd = [sys.executable, "-m", "gsplat_tpu_torch.viewer.serve",
           "-m", model_dir, "--ip", "127.0.0.1", "--port", str(port),
           "--cap_max", str(CAP_MAX), "--sh_degree", str(SH_DEGREE)]
    if setting == "merge":
        cmd += ["--dup_budget", str(k_dup)]
    t0 = time.time()
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=lf,
                                stderr=subprocess.STDOUT)
    try:
        sock = None
        while sock is None:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited rc={proc.returncode}: "
                                   + open(log_path).read()[-2000:])
            if time.time() - t0 > 180:
                raise TimeoutError("server did not start listening")
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=300)
            except OSError:
                time.sleep(0.5)
        latencies = []
        with sock:
            for cam in cams[:3]:
                msg = sibr_request(cam)
                body = json.dumps(msg).encode("utf-8")
                t1 = time.time()
                sock.sendall(len(body).to_bytes(4, "little") + body)
                img = recv_exact(sock, cam.width * cam.height * 3)
                n = int.from_bytes(recv_exact(sock, 4), "little")
                verify = recv_exact(sock, n).decode("ascii")
                latencies.append(time.time() - t1)
                dec, _ = network_gui.request_to_camera(msg, DEVICE)
                want = network_gui.image_to_bytes(render_fn(dec))
                if img != want:
                    diff = np.frombuffer(img, np.uint8).astype(int) - \
                        np.frombuffer(want, np.uint8)
                    raise AssertionError(
                        f"{setting}: served bytes differ from the in-process "
                        f"image at {int((diff != 0).sum())} values")
                if verify != model_dir:
                    raise AssertionError(f"verify string {verify!r}")
        log("socket", card=card_name, setting=setting, k_dup=k_dup,
            requests=3, bytes_per_reply=WIDTH * HEIGHT * 3,
            reply_seconds=latencies, startup_s=time.time() - t0
            - sum(latencies))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def pass_ms(fn, cams) -> float:
    """Wall milliseconds per frame of one synchronised pass of the
    cameras."""
    import torch

    t0 = time.perf_counter()
    for cam in cams:
        fn(cam)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(cams)


# the port's kernel entry functions as the profiler names them
PORT_KERNELS = ("expand_scan_kernel", "merge_expand_kernel", "render_kernel",
                "blend_forward_kernel", "blend_backward_kernel",
                "multi_cumsum_kernel")


def port_kernel_ms(rows):
    """{kernel: device ms} of the port's kernels among a profile's rows
    ((ms, calls, full kernel name)): each kernel's own time on the card,
    which a CUDA-event time of a call of a few microseconds cannot give
    (the host's time of the call bounds it)."""
    out = {}
    for ms, _, key in rows:
        for name in PORT_KERNELS:
            if name in key:
                out[name] = out.get(name, 0.0) + ms
    return out


def profile_frames(fn, cams, setting, frame_ms, plain_pass_ms, card_name):
    """Device time by kernel over one pass of the cameras (torch.profiler).
    The profiler slows the host, so the idle share sets the device busy
    time against ``frame_ms``, the unprofiled frame time of the fps phase;
    the wall time of an unprofiled pass over the same cameras (taken
    before any profiling) and of the profiled pass are logged beside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_pass_ms = pass_ms(fn, cams)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us:
            rows.append((dev_us / 1e3 / len(cams), e.count // len(cams),
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", card=card_name, setting=setting, frame_ms=frame_ms,
        unprofiled_pass_ms_per_frame=plain_pass_ms,
        profiled_pass_ms_per_frame=profiled_pass_ms,
        device_busy_ms_per_frame=busy if rows else "not measured",
        idle_share=(1 - busy / frame_ms) if rows else "not measured",
        kernels_per_frame=sum(r[1] for r in rows),
        port_kernels_ms_per_frame=port_kernel_ms(rows),
        top=[{"kernel": k[:70], "ms_per_frame": round(ms, 4), "calls": c}
             for ms, c, k in rows[:14]])


def quality(cap_slot, cap_render, served, card_name):
    """Served frame vs the plain render of an f32 feature stream."""
    import torch

    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.raster import tile_kernel

    (table, gid), kw = cap_slot
    feat32 = rast._slot_features(table, gid, dtype=torch.float32)
    args, rkw = cap_render
    meta, bg = args[1], args[2]
    n_t, n_pix, tx, ty, gx, chunk = args[3:]
    ref_t = tile_kernel.render_forward_plain(feat32, meta, bg, n_t, n_pix,
                                             tx, ty, gx, chunk)
    gy = n_t // gx
    ref = rast.assemble_tiles(ref_t, gx, gy, tx, ty, WIDTH, HEIGHT)
    ref = torch.clamp(ref.float().permute(1, 2, 0), 0.0, 1.0)
    bands = {}
    for lo, hi in ((0, 256), (256, 512), (512, 1024), (1024, WIDTH)):
        if lo < WIDTH:
            bands[f"[{lo},{hi})"] = psnr(served[:, lo:hi], ref[:, lo:hi])
    log("quality", card=card_name, psnr_db=psnr(served, ref),
        psnr_by_columns_db=bands,
        max_abs=float((served - ref).abs().max()))


# ------------------------------------------------------------- training ----

# The two static training settings: copies of bench.py's recipes
# (bench.py:254-335 and :379-430), with numpy draws in bench.py's order.
# num_dup / k_dup are the TPU records of the same scenes (BENCH_r05.json).
TRAIN = {
    "100k-800x800": dict(p=100_000, width=800, height=800, cams=8, wit=20,
                         tpu_num_dup=138_188, tpu_k_dup=154_880),
    "1m-1296x840": dict(p=1_000_000, width=1296, height=840, cams=4,
                        wit=10, tpu_num_dup=3_063_690,
                        tpu_k_dup=3_431_424),
}
TRAIN_P_GT = 20_000
DUP_REL_GATE = 1e-3   # bench.py's dup_rel gate against the TPU counts
TRAIN_TILE = (64, 16)
TRAINED_STATS = os.path.join(ROOT, "tests", "fixtures", "trained_stats.npz")
HW_GOLDEN = os.path.join(ROOT, "tests", "fixtures", "hw_parity_golden.npz")
CLI_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "quality_blender")
# float operations per live (pixel, slot) pair, counted from
# blend_kernels.cu: forward 2 offsets, 9 for the quadratic form, exp (2),
# opa scale, clamp, two alpha tests, 1 - alpha, the product, the stop
# test, the weight and 3 color FMAs (6); the backward repeats the first 20
# and adds <dC, rgb> (5), the running sum (2), the suffix and dalpha (4),
# de and dpower (2), the five geometry terms (17), d rgb (3) and the nine
# per-slot sums over pixels (9)
BLEND_FWD_OPS_PER_PAIR = 27
BLEND_BWD_OPS_PER_PAIR = 62

def kept_slot_share(feat, meta, visited, kw, block):
    """Share of the (pixel block, slot) pairs of the visited chunks whose
    cull box meets the block, for the tile cut into ``block``-sized pixel
    blocks (the kernels' warp blocks, or the 8 x 4 sub-blocks a thread's
    j-th pixels form across a warp); before warps stop at saturation. The
    cull rule is tile_kernel's transcription of the kernels'."""
    import torch

    from gsplat_tpu_torch.raster import tile_kernel

    bx, by = block
    tx, ty, chunk = kw["tile_x"], kw["tile_y"], kw["chunk"]
    nbx, nby = -(-tx // bx), -(-ty // by)
    cidx = torch.cat(visited)
    tiles = (meta[cidx] >> 2).long()
    f = feat.reshape(9, -1, chunk)[:, cidx]                    # [9, V, C]
    xl = f[0] - ((tiles % kw["grid_x"]) * tx).float()[:, None]
    yl = f[1] - ((tiles // kw["grid_x"]) * ty).float()[:, None]
    hx, hy = tile_kernel.blend_cull_extent(f[2], f[3], f[4], f[5])
    wx = torch.arange(nbx, device=feat.device).repeat(nby) * bx
    wy = torch.arange(nby, device=feat.device).repeat_interleave(nbx) * by
    x0, y0 = wx.float(), wy.float()
    x1 = torch.clamp(wx + bx, max=tx).float() - 1
    y1 = torch.clamp(wy + by, max=ty).float() - 1
    xl, yl, hx, hy = (t[:, :, None] for t in (xl, yl, hx, hy))
    kept = tile_kernel.blend_cull_meets(xl, yl, hx, hy, x0, x1, y0,
                                        y1)                   # [V, C, W]
    return float(kept.float().mean())


def probe_k_dup(need, chunk, headroom=1.12, floor=1 << 15):
    """bench.py's budget rule: measured demand x 1.12, chunk-aligned."""
    return -(-max(int(need * headroom), floor) // chunk) * chunk


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


def bench_gt_scene(rng, p_gt, device):
    """bench.py's ground-truth scene (:266-274), activated."""
    import torch

    from gsplat_tpu_torch.core.quaternion import normalize

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    means = t(rng.uniform(-0.9, 0.9, (p_gt, 3)))
    scales = t(np.exp(rng.uniform(-3.2, -2.0, (p_gt, 3))))
    quats = normalize(t(rng.normal(size=(p_gt, 4))))
    opa = torch.sigmoid(t(rng.uniform(0, 3, p_gt)))
    shs = t(np.concatenate([rng.uniform(-0.5, 1.5, (p_gt, 1, 3)),
                            np.zeros((p_gt, 15, 3))], 1))
    return means, scales, quats, opa, shs


def trained_stats_state(p, sh, rng, device):
    """bench.trained_stats_state with uniform positions: a 1M-capacity
    state whose opacity and log-scale triples are drawn from the quantile
    tables of a trained scene (tests/fixtures/trained_stats.npz), density-
    corrected by -0.5 ln(P / N_source)."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.model import gaussians

    st = np.load(TRAINED_STATS)
    pts = rng.uniform(-1, 1, (p, 3)).astype(np.float32)
    state = gaussians.create_from_points(
        pts, rng.uniform(0, 1, (p, 3)).astype(np.float32), capacity=p,
        max_sh_degree=sh, device=device)
    grid = np.linspace(0, 1, len(st["opacity_quantiles"]))
    opa = np.interp(rng.uniform(0, 1, p).astype(np.float32), grid,
                    st["opacity_quantiles"]).astype(np.float32)
    opa = np.clip(opa, 1e-4, 1 - 1e-4)
    sq = st["logscale_sorted_quantiles"]
    u = rng.uniform(0, 1, p).astype(np.float32)
    gridq = np.linspace(0, 1, len(sq))
    triple = np.stack([np.interp(u, gridq, sq[:, i]) for i in range(3)], 1)
    perm = rng.permuted(np.tile(np.arange(3), (p, 1)), axis=1)
    logscale = np.take_along_axis(triple, perm, axis=1).astype(np.float32)
    logscale += np.float32(-0.5 * np.log(max(p / max(int(st["n_alive"]), 1),
                                             1.0)))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dc.replace(state, opacity=t(np.log(opa / (1 - opa))[:, None]),
                      scaling=t(logscale))


def build_training(card_name):
    """Both settings: ground truths, initial states, probed budgets."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster import rasterize as rast

    rng = np.random.default_rng(0)
    bg = torch.zeros(3, device=DEVICE)
    gt = bench_gt_scene(rng, TRAIN_P_GT, DEVICE)
    out = {}
    k_first = None
    for name, cfg in TRAIN.items():
        t0 = time.time()
        cams = orbit_cameras(cfg["cams"], cfg["width"], cfg["height"],
                             DEVICE)
        base = rast.RasterizeSettings(
            k_dup=8 * cfg["p"] if k_first is None else k_first,
            tile_x=TRAIN_TILE[0], tile_y=TRAIN_TILE[1], chunk=128,
            layout="chw")
        with torch.no_grad():
            gts = [rast.rasterize(*gt, c, SH_DEGREE, bg, base).image
                   for c in cams]
        if k_first is None:
            pts = rng.uniform(-1, 1, (cfg["p"], 3)).astype(np.float32)
            state = gaussians.create_from_points(
                pts, rng.uniform(0, 1, (cfg["p"], 3)).astype(np.float32),
                capacity=cfg["p"], max_sh_degree=SH_DEGREE, device=DEVICE)
            probe = base
        else:
            state = trained_stats_state(cfg["p"], SH_DEGREE, rng, DEVICE)
            probe = dc.replace(base, k_dup=1 << 21)
        with torch.no_grad():
            need = [int(renderer.render(c, state, bg, probe)["num_dup"])
                    for c in cams]
        settings = dc.replace(base, k_dup=probe_k_dup(max(need), 128))
        if k_first is None:
            k_first = settings.k_dup
        rel = abs(max(need) - cfg["tpu_num_dup"]) / cfg["tpu_num_dup"]
        if rel > DUP_REL_GATE:
            raise AssertionError(f"{name}: num_dup {max(need)} vs the TPU's "
                                 f"{cfg['tpu_num_dup']} (rel {rel:.2e})")
        out[name] = dict(cams=cams, gts=gts, state=state, settings=settings)
        log("train_probe", card=card_name, setting=name,
            gaussians=state.n_alive, image=f"{cfg['width']}x{cfg['height']}",
            num_dup_per_camera=need, num_dup_max=max(need),
            tpu_num_dup=cfg["tpu_num_dup"], num_dup_rel=rel,
            k_dup=settings.k_dup, tpu_k_dup=cfg["tpu_k_dup"],
            gt_means=[round(float(g.mean()), 5) for g in gts],
            seconds=time.time() - t0)
    return out, rng


class _ExtProxy:
    """The compiled extension with some functions recording their
    arguments before they launch (the wrappers and their launch counts are
    left as they are)."""

    def __init__(self, ext, store):
        self._ext, self._store = ext, store

    def __getattr__(self, name):
        fn = getattr(self._ext, name)
        if name not in self._store:
            return fn

        def recorder(*args):
            self._store[name].append(args)
            return fn(*args)
        return recorder


@contextlib.contextmanager
def capture_ext(store):
    """Record the arguments of the kernel launches named in ``store``."""
    from gsplat_tpu_torch.raster import cuda_ext

    orig = cuda_ext.load
    cuda_ext.load = lambda: _ExtProxy(orig(), store)
    try:
        yield
    finally:
        cuda_ext.load = orig


def capture_training(setups, card_name):
    """One train step per setting with its kernel inputs recorded (the
    state is not advanced)."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.raster import binning
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    caps = {}
    for name, st in setups.items():
        store = {"blend_forward": [], "blend_backward": [],
                 "multi_cumsum": []}
        merge = []
        step = step_lib.make_train_step(OptimizationConfig(),
                                        st["settings"], 4.0)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(0)
        with capture_ext(store), capture(binning, "merge_expand", merge):
            step(st["state"], optim.init(st["state"].params()), gen,
                 st["cams"][0], st["gts"][0], torch.zeros(3, device=DEVICE),
                 1.0, SH_DEGREE)
        torch.cuda.synchronize()
        caps[name] = {k: v[0] for k, v in store.items() if v}
        caps[name]["merge_expand"] = merge[0][0]
    return caps


def blend_kwargs(args):
    """Wrapper keyword arguments from a recorded blend launch
    (feat, chunk_meta, out(s)..., n_pix, tile_x, tile_y, grid_x, chunk)."""
    feat, meta = args[0].detach(), args[1]
    n_pix, tile_x, tile_y, grid_x, chunk = args[4:9]
    num_tiles = args[2].shape[0]
    return feat, meta, dict(num_tiles=num_tiles, n_pix=n_pix, tile_x=tile_x,
                            tile_y=tile_y, grid_x=grid_x, chunk=chunk)


def check_blend(setting, forward, backward, feat, meta, dpack, kw, want):
    """Hold one build's blend forward and backward (callables with the
    wrappers' signatures) against the plain versions' ``want`` = (ct,
    used, dfeat): colour and T within 1e-5 and used > 0 identical per slot
    (flips at the 1e-4 stop threshold, if any, show as whole pixels beyond
    tolerance; both counts are gated at zero), each dfeat row within 1e-4
    of its maximum, two backward launches bit-equal. Returns the errors."""
    import torch

    want_ct, want_used, want_d = want
    got_ct, got_used = forward(feat, meta, **kw)
    got = backward(feat, meta, dpack, **kw)
    again = backward(feat, meta, dpack, **kw)
    torch.cuda.synchronize()
    bad_pix = int(((got_ct - want_ct).abs().amax(dim=1) > 1e-5).sum())
    bad_slots = int(((got_used > 0) != (want_used > 0)).sum())
    if bad_pix or bad_slots:
        raise AssertionError(f"{setting}: blend forward vs plain: {bad_pix} "
                             f"pixels beyond 1e-5, {bad_slots} slots differ "
                             f"in used > 0")
    row_max = want_d.abs().amax(dim=1)
    row_err = (got - want_d).abs().amax(dim=1)
    if bool((row_err > 1e-4 * row_max).any()):
        raise AssertionError(f"{setting}: blend backward vs plain, row "
                             f"errors {row_err.tolist()} vs maxima "
                             f"{row_max.tolist()}")
    if not torch.equal(got, again):
        raise AssertionError(f"{setting}: two blend backward launches differ")
    return dict(
        fwd_max_abs_err=float((got_ct - want_ct).abs().max()),
        flips=bad_pix, bwd_max_abs_err=float((got - want_d).abs().max()),
        max_rel_row_err=float((row_err / row_max.clamp(min=1e-30)).max()))


def check_training_kernels(caps, card_name):
    """The three training kernels against their plain versions on the
    inputs of each setting's first step (detached: the plain versions must
    not build an autograd graph)."""
    import torch

    with torch.no_grad():
        return _check_training_kernels(caps, card_name)


def _check_training_kernels(caps, card_name):
    import torch

    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel

    out = {}
    for name, cap in caps.items():
        # the backward was recorded with the forward's feat and chunk_meta
        feat, meta, kw = blend_kwargs(cap["blend_forward"])
        dpack = cap["blend_backward"][2].detach()
        stats = {}
        want_ct, want_used = tile_kernel._blend_plain(feat, meta, stats=stats,
                                                      **kw)
        want_d = tile_kernel.tile_blend_backward_plain(feat, meta, dpack,
                                                       **kw)
        errs = check_blend(name, tile_kernel.tile_blend_forward,
                           tile_kernel.tile_blend_backward, feat, meta, dpack,
                           kw, (want_ct, want_used, want_d))
        k, n_pix = feat.shape[1], kw["n_pix"]
        shape = (f"tiles={kw['num_tiles']} slots={k} visited_chunks="
                 f"{stats['chunks']} live_pairs={stats['pairs']}")
        cull = dict(passing_pairs=stats["passing"],
                    kept_warp_slot_share=kept_slot_share(
                        feat, meta, stats["visited"], kw,
                        tile_kernel.BLEND_WARP_BLOCK),
                    kept_sub_block_slot_share=kept_slot_share(
                        feat, meta, stats["visited"], kw,
                        tile_kernel.BLEND_SUB_BLOCK))
        # bound_ms: the work this run's data needs, the pairs that pass
        # alpha >= 1/255; bound_all_pairs_ms: every pair whose pixel is not
        # done (the work without culling), the first kernels' bound
        slot_bytes = stats["chunks"] * kw["chunk"] * 36 + meta.numel() * 4
        pix_bytes = kw["num_tiles"] * 16 * n_pix
        for kname, tpu_line, nbytes, ops, run, plain in (
                ("tile_blend_forward", 348, slot_bytes + pix_bytes + 4 * k,
                 BLEND_FWD_OPS_PER_PAIR,
                 lambda: tile_kernel.tile_blend_forward(feat, meta, **kw),
                 lambda: tile_kernel.tile_blend_forward_plain(feat, meta,
                                                              **kw)),
                ("tile_blend_backward", 526,
                 slot_bytes + pix_bytes + 36 * k, BLEND_BWD_OPS_PER_PAIR,
                 lambda: tile_kernel.tile_blend_backward(feat, meta, dpack,
                                                         **kw),
                 lambda: tile_kernel.tile_blend_backward_plain(
                     feat, meta, dpack, **kw))):
            b_ms, b_by = bound(nbytes, stats["passing"] * ops)
            fwd = kname == "tile_blend_forward"
            entry = dict(
                name=kname, route="cuda",
                source="gsplat_tpu_torch/csrc/blend_kernels.cu",
                replaces=f"gsplat_tpu/raster/tile_kernel.py:{tpu_line}",
                setting=name,
                max_abs_err=errs["fwd_max_abs_err" if fwd
                                 else "bwd_max_abs_err"],
                ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 1, warmup=0),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bound_all_pairs_ms=bound(nbytes, stats["pairs"] * ops)[0],
                **cull, shape=shape)
            if fwd:
                entry["flips"] = errs["flips"]
            else:
                entry.update(max_rel_row_err=errs["max_rel_row_err"],
                             repeat_bit_equal=True)
            log("kernel", card=card_name, **entry)
            out.setdefault(kname, {})[name] = entry

        if "multi_cumsum" in cap:
            x = cap["multi_cumsum"][0].detach()
            got = scan_kernel.multi_cumsum(x)
            again = scan_kernel.multi_cumsum(x)
            ref = torch.cumsum(x.double(), dim=1)
            torch.cuda.synchronize()
            err = (got.double() - ref).abs()
            if bool((err > 2e-3 + 1e-5 * ref.abs()).any()):
                raise AssertionError(f"{name}: multi_cumsum vs float64, max "
                                     f"abs {float(err.max())}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two multi_cumsum launches "
                                     f"differ")
            plain = scan_kernel.multi_cumsum_plain(x)
            n, kk = x.shape
            b_ms, b_by = bound(8 * n * kk, n * kk)
            entry = dict(
                name="multi_cumsum", route="cuda",
                source="gsplat_tpu_torch/csrc/scan_kernels.cu",
                replaces="gsplat_tpu/raster/scan_kernel.py:103",
                setting=name, max_abs_err=float(err.max()),
                max_abs_vs_plain=float((got - plain).abs().max()),
                ms=cuda_ms(lambda: scan_kernel.multi_cumsum(x), 20),
                plain_ms=cuda_ms(lambda: scan_kernel.multi_cumsum_plain(x),
                                 5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lambda: torch.cumsum(x, dim=1), 20),
                repeat_bit_equal=True, shape=f"n={n} K={kk}")
            log("kernel", card=card_name, **entry)
            out.setdefault("multi_cumsum", {})[name] = entry
    return out


# the serving tile and a 256-slot chunk: the blend kernels walk such a tile
# in four groups of 1,024 pixels and each chunk in two 128-slot pieces
LARGE_TILE = dict(tile_x=128, tile_y=32, chunk=256)


def check_large_tiles(st, card_name):
    """One step of the 100k training setting at LARGE_TILE, its blend
    inputs recorded, and both blends held against their plain versions
    with check_blend's gates; times beside them."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.raster import tile_kernel

    name = "100k-800x800-128x32-c256"
    settings = dc.replace(st["settings"], **LARGE_TILE)
    cap = capture_training({name: dict(st, settings=settings)},
                           card_name)[name]
    with torch.no_grad():
        feat, meta, kw = blend_kwargs(cap["blend_forward"])
        dpack = cap["blend_backward"][2].detach()
        want = (*tile_kernel.tile_blend_forward_plain(feat, meta, **kw),
                tile_kernel.tile_blend_backward_plain(feat, meta, dpack,
                                                      **kw))
        errs = check_blend(name, tile_kernel.tile_blend_forward,
                           tile_kernel.tile_blend_backward, feat, meta,
                           dpack, kw, want)
        log("large_tile", card=card_name, setting=name, **errs,
            forward_ms=cuda_ms(lambda: tile_kernel.tile_blend_forward(
                feat, meta, **kw), 10),
            backward_ms=cuda_ms(lambda: tile_kernel.tile_blend_backward(
                feat, meta, dpack, **kw), 10),
            shape=f"tiles={kw['num_tiles']} slots={feat.shape[1]} "
                  f"n_pix={kw['n_pix']} chunk={kw['chunk']}")


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


def train_small(card_name):
    """hw_parity_golden.npz replayed through the port (the recipe of
    scripts/gen_hw_parity_golden.py::build_inputs, without JAX): images,
    loss, num_dup and the Adam deltas of one train step against the
    golden, with bench.py's gates; then one split densify iteration on a
    state of twice the capacity."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.model import gaussians, optim
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    golden = np.load(HW_GOLDEN)
    p_model, w, h = 8192, 256, 256
    scene = make_scene_params(4096, SH_DEGREE, 0, DEVICE)
    cam = orbit_cameras(3, w, h, DEVICE)[1]
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.2, 1.2, (p_model, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2.0, 6.0, p_model)
    colors = rng.uniform(0, 1, (p_model, 3)).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    gt = torch.as_tensor(np.stack([xx, yy, 0.5 * (xx + yy)], 0).astype(
        np.float32), device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    settings = rast.RasterizeSettings(k_dup=1 << 16, tile_x=64, tile_y=16,
                                      chunk=128)
    with torch.no_grad():
        train_img = rast.rasterize(*scene, cam, SH_DEGREE, bg,
                                   settings).image
        infer_img = rast.rasterize(*scene, cam, SH_DEGREE, bg, dc.replace(
            settings, inference=True)).image.float()
    state = gaussians.create_from_points(pts, colors, p_model, SH_DEGREE,
                                         device=DEVICE)
    opt = OptimizationConfig()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    # the fused step as grad + apply, to keep the gradients
    grads, m = step_lib.make_grad_step(opt, settings, 4.0)(
        state, cam, gt, bg, 2)
    new, _ = step_lib.make_apply_step(opt, 4.0)(
        state, optim.init(state.params()), grads, gen, 100.0, True)

    def psnr_db(a, b):
        mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
        return min(-10.0 * np.log10(mse + 1e-30), 99.0)

    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
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
        raise AssertionError(f"train_small golden gates failed: {res}")

    # one split densify iteration at twice the capacity
    big = gaussians.create_from_points(pts, colors, 2 * p_model, SH_DEGREE,
                                       device=DEVICE)
    adam = optim.init(big.params())
    grads, _ = step_lib.make_grad_step(opt, settings, 4.0)(
        big, cam, gt, bg, SH_DEGREE)
    big, adam = step_lib.make_densify_step(2 * p_model)(big, adam, gen)
    big, adam = step_lib.make_apply_step(opt, 4.0)(big, adam, grads, gen,
                                                   100.0, False)
    grown = int(1.05 * p_model)
    new_rows = slice(p_model, grown)
    zero = all(float(v[new_rows].abs().max()) == 0.0
               for tree in (adam.mu, adam.nu) for v in tree.values())
    if big.n_alive != grown or not zero:
        raise AssertionError(f"densify: n_alive {big.n_alive} (want "
                             f"{grown}), new-row moments zero: {zero}")
    log("train_small", card=card_name, **res, densify_n_alive=big.n_alive,
        densify_new_row_moments_zero=zero)


def train_setting(name, st, wrappers, card_name):
    """The setting's main path: counts zeroed, one warm step and 3 timed
    windows of fused steps, counts read; then one untimed split densify
    iteration. Returns (launches, ms per step, losses)."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    cfg = TRAIN[name]
    cams, gts, settings = st["cams"], st["gts"], st["settings"]
    opt = OptimizationConfig()
    bg = torch.zeros(3, device=DEVICE)
    step = step_lib.make_train_step(opt, settings, 4.0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    state, adam = st["state"], optim.init(st["state"].params())
    for w in wrappers.values():
        w.launches = 0
    state, adam, m = step(state, adam, gen, cams[0], gts[0], bg, 1.0,
                          SH_DEGREE)
    torch.cuda.synchronize()
    ms, losses, dups = [], [], []
    it = 0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(cfg["wit"]):
            state, adam, m = step(state, adam, gen, cams[it % len(cams)],
                                  gts[it % len(cams)], bg, float(it + 2),
                                  SH_DEGREE)
            dups.append(m.num_dup)
            it += 1
        losses.append(float(m.loss))     # synchronises
        ms.append((time.perf_counter() - t0) * 1e3 / cfg["wit"])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = 1 + 3 * cfg["wit"]
    segsum = "1m" in name
    want = {k: 0 for k in wrappers}
    want.update(tile_blend_forward=steps, tile_blend_backward=steps,
                merge_expand=steps, multi_cumsum=steps if segsum else 0)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 3:
        raise AssertionError(f"{name}: window losses {losses}")
    max_dup = max(int(d) for d in dups)
    if max_dup > settings.k_dup:
        raise AssertionError(f"{name}: num_dup {max_dup} > {settings.k_dup}")

    # one untimed split densify iteration (grad -> densify -> Adam + noise)
    dead = int((state.alive_mask & (state.get_opacity()[:, 0] <= 0.005)
                ).sum())
    grads, _ = step_lib.make_grad_step(opt, settings, 4.0)(
        state, cams[0], gts[0], bg, SH_DEGREE)
    n_before = state.n_alive
    state, adam = step_lib.make_densify_step(state.capacity)(state, adam,
                                                             gen)
    state, adam = step_lib.make_apply_step(opt, 4.0)(
        state, adam, grads, gen, float(it + 2), dead == 0)
    torch.cuda.synchronize()
    if segsum and dead == 0:
        raise AssertionError(f"{name}: relocation moved no rows")
    log("train", card=card_name, setting=name, steps=steps,
        window_ms_per_step=ms, ms_per_step_median=statistics.median(ms),
        it_per_s_median=1e3 / statistics.median(ms), window_losses=losses,
        max_num_dup=max_dup, k_dup=settings.k_dup,
        launches_per_step={k: v / steps for k, v in launches.items()},
        densify_relocated=dead, n_alive_before=n_before,
        n_alive_after=state.n_alive,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches, statistics.median(ms), state, adam


def profile_steps(phase, setting, run, step_ms, card_name, n=3):
    """Device time by kernel over ``n`` calls of ``run(i)`` (one step
    each); the idle share sets the device busy time against the
    unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us:
            rows.append((dev_us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(phase, card=card_name, setting=setting, step_ms=step_ms,
        device_busy_ms_per_step=busy if rows else "not measured",
        idle_share=(1 - busy / step_ms) if rows else "not measured",
        kernels_per_step=sum(r[1] for r in rows),
        port_kernels_ms_per_step=port_kernel_ms(rows),
        top=[{"kernel": k[:70], "ms_per_step": round(ms, 4), "calls": c}
             for ms, c, k in rows[:16]])


def profile_train(name, st, state, adam, step_ms, card_name):
    """Device time by kernel over 3 fused static steps."""
    import torch

    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    step = step_lib.make_train_step(OptimizationConfig(), st["settings"],
                                    4.0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    bg = torch.zeros(3, device=DEVICE)
    carry = [state, adam]

    def run(i):
        carry[0], carry[1], _ = step(carry[0], carry[1], gen,
                                     st["cams"][i % 4], st["gts"][i % 4], bg,
                                     100.0 + i, SH_DEGREE)

    profile_steps("train_profile", name, run, step_ms, card_name)


def cli_phase(card_name):
    """The trainer CLI on the committed Blender fixture with the flags of
    tests/test_quality_regression.py, then the held-out PSNR of the saved
    PLY (gate 21.0 dB, as the JAX test's)."""
    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster import rasterize as rast

    out_dir = os.path.join(WORK, "cli_model")
    cmd = [sys.executable, "-m", "gsplat_tpu_torch.train.train_static",
           "-s", CLI_FIXTURE, "-m", out_dir, "--eval", "-w",
           "--cap_max", "512", "--init_pts", "256", "--iterations", "300",
           "--densify_from_iter", "50", "--densify_until_iter", "280",
           "--densification_interval", "50", "--test_iterations", "-1",
           "--save_iterations", "-1", "--dup_budget", "16384"]
    t0 = time.time()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        raise RuntimeError(f"trainer CLI rc={res.returncode}: "
                           + (res.stdout + res.stderr)[-3000:])
    seconds = time.time() - t0
    scene = Scene(CLI_FIXTURE, "", eval_split=True, white_background=True,
                  init_type="random", num_pts=8, shuffle=False,
                  device=DEVICE)
    state = gaussians.load_ply(
        os.path.join(out_dir, "point_cloud/iteration_300/point_cloud.ply"),
        capacity=512, max_sh_degree=3, device=DEVICE)
    settings = rast.RasterizeSettings(k_dup=16384, tile_x=16, tile_y=16)
    psnrs = []
    for cam_obj in scene.test_cameras:
        cam, gt = cam_obj.load()
        with torch.no_grad():
            img = renderer.render(cam, state, torch.ones(3, device=DEVICE),
                                  settings)["render"]
        a = np.clip(img.cpu().numpy(), 0, 1)
        psnrs.append(float(-10 * np.log10(np.mean((a - np.clip(gt, 0, 1))
                                                   ** 2) + 1e-12)))
    mean = float(np.mean(psnrs))
    if mean < 21.0:
        raise AssertionError(f"trainer CLI: held-out PSNR {mean:.2f} dB < "
                             f"21.0 ({psnrs})")
    log("cli", card=card_name, iterations=300, seconds=seconds,
        heldout_psnr_db=mean, per_view_db=psnrs,
        n_alive=state.n_alive)


# ---------------------------------------------------------------- swin ----

# bench.py's SwinGS stage (bench.py:432-493): 200k immature rows and a
# 200k-row matured ring (a 400k-row union), swin 8, SH degree 1, deform,
# 1280x720, 4 orbit cameras, 64x16 tiles, spatial_lr_scale 4.0; num_dup /
# k_dup are the TPU records of the same scene (BENCH_r05.json's tail).
SWIN = dict(cap=200_000, sh=1, lifespan=8, width=1280, height=720, cams=4,
            wit=10, tpu_num_dup=261_237, tpu_k_dup=313_600, frames=16)
SWIN_NAME = "swin-200k-1280x720"
DYN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "quality_cudaport_dyn")
# tests/test_stream_semantic.py:45-54
SWIN_CLI_FLAGS = ["--iterations", "150", "--genesis_iterations", "300",
                  "--cap_max", "320", "--init_pts", "160", "--init_type",
                  "sfm", "--max_frame", "4", "--swin_size", "2", "--deform",
                  "--densify_from_iter", "20", "--densify_until_iter", "140",
                  "--densification_interval", "30", "--test_iterations",
                  "-1", "--save_iterations", "-1", "--dup_budget", "8192"]


def build_swin(rng, k_gt, card_name):
    """The swin setting: the ground truth (_make_scene(20k, 1, seed=1)
    through the training path at the 100k setting's budget, as bench.py
    renders it), the state from the next draws of bench.py's ``rng``, the
    frame-0 probe of num_dup and the budget (headroom 1.2)."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.model import swin
    from gsplat_tpu_torch.raster import rasterize as rast

    t0 = time.time()
    cfg = SWIN
    bg = torch.zeros(3, device=DEVICE)
    cams = orbit_cameras(cfg["cams"], cfg["width"], cfg["height"], DEVICE)
    base = rast.RasterizeSettings(k_dup=k_gt, tile_x=TRAIN_TILE[0],
                                  tile_y=TRAIN_TILE[1], chunk=128,
                                  layout="chw")
    scene = make_scene_params(TRAIN_P_GT, cfg["sh"], 1, DEVICE)
    with torch.no_grad():
        gts = [rast.rasterize(*scene, c, cfg["sh"], bg, base).image
               for c in cams]
    cap = cfg["cap"]
    pts = rng.uniform(-1, 1, (cap, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
    state = swin.create_from_points(pts, cols, cap, cfg["sh"],
                                    max_lifespan=cfg["lifespan"],
                                    buffer_size=cap, deform=True,
                                    device=DEVICE)
    probe = dc.replace(base, k_dup=1 << 20, layout="hwc")
    with torch.no_grad():
        need = [int(renderer.deformable_render(c, state, 0.0, bg,
                                               probe)["num_dup"])
                for c in cams]
    settings = dc.replace(probe, k_dup=probe_k_dup(max(need), 128,
                                                   headroom=1.2))
    rel = abs(max(need) - cfg["tpu_num_dup"]) / cfg["tpu_num_dup"]
    if rel > DUP_REL_GATE:
        raise AssertionError(f"swin: num_dup {max(need)} vs the TPU's "
                             f"{cfg['tpu_num_dup']} (rel {rel:.2e})")
    log("train_probe", card=card_name, setting=SWIN_NAME,
        immature=state.im.n_alive, union_rows=2 * cap,
        image=f"{cfg['width']}x{cfg['height']}", num_dup_per_camera=need,
        num_dup_max=max(need), tpu_num_dup=cfg["tpu_num_dup"],
        num_dup_rel=rel, k_dup=settings.k_dup, tpu_k_dup=cfg["tpu_k_dup"],
        gt_means=[round(float(g.mean()), 5) for g in gts],
        seconds=time.time() - t0)
    return dict(cams=cams, gts=gts, state=state, settings=settings)


def capture_swin(st):
    """One fused swin step with its kernel inputs recorded (the state is
    not advanced)."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.raster import binning
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig

    store = {"blend_forward": [], "blend_backward": [], "multi_cumsum": []}
    merge = []
    step = swin_step.make_swin_train_step(OptimizationConfig(),
                                          st["settings"], 4.0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    with capture_ext(store), capture(binning, "merge_expand", merge):
        step(st["state"], optim.init(st["state"].params()), gen,
             st["cams"][0], st["gts"][0], torch.zeros(3, device=DEVICE),
             1.0, 0.0, SWIN["sh"])
    torch.cuda.synchronize()
    cap = {k: v[0] for k, v in store.items() if v}
    cap["merge_expand"] = merge[0][0]
    return cap


def swin_steps(step, state, adam, st, gen, windows, first_frame, it0):
    """``windows`` x SWIN["wit"] fused steps, frame first_frame + it % 8,
    camera it % 4; returns (state, adam, window ms/step, window losses,
    max num_dup, iterations done)."""
    import torch

    bg = torch.zeros(3, device=DEVICE)
    ms, losses, dups = [], [], []
    it = it0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(SWIN["wit"]):
            state, adam, m = step(
                state, adam, gen, st["cams"][it % 4], st["gts"][it % 4], bg,
                float(it + 2), float(first_frame + it % SWIN["lifespan"]),
                SWIN["sh"])
            dups.append(m.num_dup)
            it += 1
        losses.append(float(m.loss))     # synchronises
        ms.append((time.perf_counter() - t0) * 1e3 / SWIN["wit"])
    torch.cuda.synchronize()
    return state, adam, ms, losses, max(int(d) for d in dups), it


def swin_launches_ok(launches, steps, where):
    """One blend forward, blend backward, merge_expand and multi_cumsum a
    step, no other kernel."""
    want = {k: 0 for k in launches}
    want.update(tile_blend_forward=steps, tile_blend_backward=steps,
                merge_expand=steps, multi_cumsum=steps)
    if launches != want:
        raise AssertionError(f"{where}: launches {launches}, expected {want}")


def swin_train(st, wrappers, card_name):
    """The swin setting's main path: counts zeroed, one warm step and 3
    windows of 10 fused steps, counts read."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig

    settings = st["settings"]
    step = swin_step.make_swin_train_step(OptimizationConfig(), settings,
                                          4.0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    state, adam = st["state"], optim.init(st["state"].params())
    for w in wrappers.values():
        w.launches = 0
    state, adam, m = step(state, adam, gen, st["cams"][0], st["gts"][0],
                          torch.zeros(3, device=DEVICE), 1.0, 0.0,
                          SWIN["sh"])
    torch.cuda.synchronize()
    state, adam, ms, losses, max_dup, it = swin_steps(
        step, state, adam, st, gen, 3, 0, 0)
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = 1 + it
    swin_launches_ok(launches, steps, "swin_train")
    if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 3:
        raise AssertionError(f"swin_train: window losses {losses}")
    if max_dup > settings.k_dup:
        raise AssertionError(f"swin_train: num_dup {max_dup} > "
                             f"{settings.k_dup}")
    log("swin_train", card=card_name, setting=SWIN_NAME, steps=steps,
        window_ms_per_step=ms, ms_per_step_median=statistics.median(ms),
        it_per_s_median=1e3 / statistics.median(ms), window_losses=losses,
        max_num_dup=max_dup, k_dup=settings.k_dup,
        launches_per_step={k: v / steps for k, v in launches.items()},
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches, statistics.median(ms), state, adam, gen


def swin_slide(st, state, adam, gen, wrappers, card_name):
    """decay_genesis -> tick -> evolve (mature into the ring, stream_dump,
    rollover) -> one densify (relocation over the window's 8 frames and
    the genesis growth) -> one window of steps in the new window, counts
    zeroed before it; then a render of the union at the new window's first
    frame with the ring in it."""
    import torch

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.model import swin
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train import train_swin
    from gsplat_tpu_torch.train.config import OptimizationConfig
    from gsplat_tpu_torch.utils.stream import SliWinManager, stream_load

    cap, sh = SWIN["cap"], SWIN["sh"]
    mgr = SliWinManager(SWIN["lifespan"], SWIN["frames"])
    state = swin.decay_genesis(state)
    mgr.tick()
    dump_dir = os.path.join(WORK, "swin_stream")
    dump = os.path.join(dump_dir, "streamable.dat")
    if os.path.exists(dump):
        os.remove(dump)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, adam = train_swin.evolve(state, adam, mgr, dump, sh)
    torch.cuda.synchronize()
    evolve_ms = (time.perf_counter() - t0) * 1e3
    records = stream_load(os.path.join(dump_dir, "format.json"),
                          dump)["xyz"].shape[0]
    if not 0 < state.m_count == records:
        raise AssertionError(f"swin_slide: matured {state.m_count}, "
                             f"records {records}")
    frames = list(mgr.all_frames())
    ring_active = [int(swin.union_params_at(state, float(f))["alive"][cap:]
                       .sum()) for f in frames]
    if ring_active[0] == 0:
        raise AssertionError(f"swin_slide: no matured row is active at "
                             f"frame {frames[0]}: {ring_active}")
    t0 = time.perf_counter()
    state, adam = swin_step.make_swin_densify_step(cap, SWIN["lifespan"])(
        state, adam, gen, float(mgr.frame_start), True)
    torch.cuda.synchronize()
    densify_ms = (time.perf_counter() - t0) * 1e3
    step = swin_step.make_swin_train_step(OptimizationConfig(),
                                          st["settings"], 4.0)
    for w in wrappers.values():
        w.launches = 0
    state, adam, ms, losses, max_dup, steps = swin_steps(
        step, state, adam, st, gen, 1, mgr.frame_start, 0)
    launches = {k: w.launches for k, w in wrappers.items()}
    swin_launches_ok(launches, steps, "swin_slide")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"swin_slide: losses {losses}")
    if max_dup > st["settings"].k_dup:
        raise AssertionError(f"swin_slide: num_dup {max_dup} > "
                             f"{st['settings'].k_dup}")
    with torch.no_grad():
        out = renderer.deformable_render(
            st["cams"][0], state, float(mgr.frame_start),
            torch.zeros(3, device=DEVICE), st["settings"])
    ring_used = int(out["is_used"][cap:].sum())
    if ring_used == 0:
        raise AssertionError("swin_slide: the ring was not rendered")
    log("swin_slide", card=card_name, setting=SWIN_NAME, window=str(mgr),
        matured=state.m_count, stream_records=records,
        ring_active_per_frame=dict(zip(frames, ring_active)),
        ring_rows_rendered=ring_used, evolve_ms=evolve_ms,
        densify_ms=densify_ms, immature_after=state.im.n_alive,
        steps=steps, ms_per_step=ms, losses=losses, max_num_dup=max_dup)
    return launches


def swin_cli(wrappers, card_name):
    """train_swin.main on a copy of the dynamic fixture with
    tests/test_stream_semantic.py's flags, then playback: the stream vs the
    direct deformable render of the final state (gate 24 dB) and vs the
    ground truth (gate 15 dB) at that test's settings; then
    render_stream.main on the inference path, counts zeroed before it."""
    import shutil

    import torch

    from gsplat_tpu_torch.data.scene import DynamicScene
    from gsplat_tpu_torch.eval import render_stream
    from gsplat_tpu_torch.model import swin
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.train import train_swin

    data_dir = os.path.join(WORK, "swin_dyn")
    out = os.path.join(WORK, "swin_cli_model")
    for d in (data_dir, out):
        shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(DYN_FIXTURE, data_dir)
    t0 = time.time()
    with open(os.path.join(WORK, "swin_cli.log"), "w") as lf, \
            contextlib.redirect_stdout(lf):
        state = train_swin.main(["-s", data_dir, "-m", out,
                                 "--data_device", DEVICE] + SWIN_CLI_FLAGS)
    seconds = time.time() - t0
    data = render_stream.load_stream_state(out, DEVICE)
    dyn = DynamicScene(data_dir, "", init_type="sfm", num_pts=8,
                       max_frame=4, device=DEVICE)
    settings = rast.RasterizeSettings(k_dup=8192, tile_x=16, tile_y=16,
                                      chunk=128)
    bg = torch.zeros(3, device=DEVICE)

    def psnr_db(a, b):   # the test's: 1e-12 keeps identical views finite
        return -10.0 * math.log10(float(((a - b) ** 2).mean()) + 1e-12)

    vs_direct, vs_gt = [], []
    with torch.no_grad():
        for f in range(4):
            union = swin.union_params_at(state, float(f))
            for cam_obj in dyn.get_test_cams_at([f]):
                camera, gt = cam_obj.load()
                s_img = render_stream.render_stream_frame(
                    data, camera, float(f), bg, settings)
                d_img = rast.rasterize(
                    union["means3d"], union["scales"], union["quats"],
                    union["opacities"], union["shs"], camera,
                    data["sh_degree"], bg, settings,
                    alive=union["alive"]).image
                vs_direct.append(psnr_db(s_img, torch.clamp(d_img, 0, 1)))
                vs_gt.append(psnr_db(s_img, torch.as_tensor(
                    np.clip(gt, 0, 1), device=DEVICE)))
    dyn.close()
    direct, vs_gt_mean = float(np.mean(vs_direct)), float(np.mean(vs_gt))
    if not (direct >= 24.0 and vs_gt_mean >= 15.0):
        raise AssertionError(f"swin_cli: stream vs direct {vs_direct} dB "
                             f"(gate 24), vs GT {vs_gt} dB (gate 15)")
    for w in wrappers.values():
        w.launches = 0
    with open(os.path.join(WORK, "swin_playback.log"), "w") as lf, \
            contextlib.redirect_stdout(lf):
        render_stream.main(["-m", out, "-s", data_dir, "--max_frame", "4",
                            "--skip_train", "--data_device", DEVICE])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    views = len(os.listdir(os.path.join(out, "test", "stream", "renders")))
    owner = launches["expand_scan"] + launches["merge_expand"]
    others = sum(v for k, v in launches.items()
                 if k not in ("expand_scan", "merge_expand", "render_forward"))
    if (views != 4 or launches["render_forward"] != views or owner != views
            or others):
        raise AssertionError(f"swin_cli playback: {views} views, launches "
                             f"{launches}")
    log("swin_cli", card=card_name, seconds=seconds,
        streamed=int(data["xyz"].shape[0]), immature=state.im.n_alive,
        stream_vs_direct_db=direct, stream_vs_gt_db=vs_gt_mean,
        per_view_vs_direct_db=vs_direct, per_view_vs_gt_db=vs_gt,
        playback_views=views, playback_launches=launches)
    return launches


def profile_swin(st, state, adam, gen, step_ms, card_name):
    """Device time by kernel over 3 fused swin steps."""
    import torch

    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig

    step = swin_step.make_swin_train_step(OptimizationConfig(),
                                          st["settings"], 4.0)
    bg = torch.zeros(3, device=DEVICE)
    carry = [state, adam]

    def run(i):
        carry[0], carry[1], _ = step(carry[0], carry[1], gen,
                                     st["cams"][i % 4], st["gts"][i % 4], bg,
                                     200.0 + i, float(i % SWIN["lifespan"]),
                                     SWIN["sh"])

    profile_steps("swin_profile", SWIN_NAME, run, step_ms, card_name)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from gsplat_tpu_torch.raster import cuda_ext, scan_kernel
        from gsplat_tpu_torch.raster import tile_kernel
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    t_start = time.time()
    card_name = card()
    os.makedirs(WORK, exist_ok=True)

    # ---- build
    t0 = time.time()
    cuda_ext.load()
    log("build", card=card_name, seconds=time.time() - t0,
        sources=list(cuda_ext.SOURCES), flags=list(cuda_ext.CUDA_FLAGS))

    # ---- model, cameras, probe
    sv = probe_serving(card_name)
    cams, model_dir = sv["cams"], sv["model_dir"]
    k_expand, k_merge = sv["k_dup"]["expand"], sv["k_dup"]["merge"]
    render_fns, store, cap = sv["render_fns"], sv["store"], sv["cap"]

    # ---- each kernel against its plain version
    kernels = check_kernels(cap, card_name)
    kernels["multi_cummax"] = check_multi_cummax(card_name)
    check_small(card_name)

    # ---- serving main paths, launch counts zeroed just before each and
    # read just after: one owner-expansion kernel and the render per frame
    wrappers = {"expand_scan": scan_kernel.expand_scan,
                "merge_expand": scan_kernel.merge_expand,
                "render_forward": tile_kernel.render_forward}
    per_frame = {"expand": ("expand_scan", "render_forward"),
                 "merge": ("merge_expand", "render_forward")}
    images, launches = {}, {}
    for setting, fn in render_fns.items():
        for w in wrappers.values():
            w.launches = 0
        images[setting] = [fn(cam) for cam in cams]
        torch.cuda.synchronize()
        launches[setting] = {name: w.launches for name, w in wrappers.items()}
        want = {name: len(cams) if name in per_frame[setting] else 0
                for name in wrappers}
        if launches[setting] != want:
            raise AssertionError(f"{setting}: launches {launches[setting]}, "
                                 f"expected {want}")
    for name in wrappers:
        kernels[name]["launches"] = sum(n[name] for n in launches.values())
    for setting, imgs in images.items():
        for img in imgs:
            if img.shape != (HEIGHT, WIDTH, 3) or not bool(
                    torch.isfinite(img).all()):
                raise AssertionError(f"{setting}: bad image")
            if float(img.mean()) < 0.02 or float(img.std()) < 0.02:
                raise AssertionError(f"{setting}: trivial image")
    same = [bool(torch.equal(a, b)) for a, b in zip(images["expand"],
                                                     images["merge"])]
    if not all(same):
        raise AssertionError(f"expand and merge settings differ: {same}")
    log("serve", card=card_name, frames=2 * len(cams), launches=launches,
        image_means=[round(float(i.mean()), 5) for i in images["expand"]],
        settings_identical=True)

    # ---- over the socket
    for setting, k in (("expand", k_expand), ("merge", k_merge)):
        socket_phase(model_dir, setting, k, cams, render_fns[setting],
                     card_name)

    # ---- numbers
    fps = {}
    for setting, fn in render_fns.items():
        for cam in cams:
            img = fn(cam)
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            t0 = time.time()
            for i in range(48):
                img = fn(cams[i % len(cams)])
            torch.cuda.synchronize()
            windows.append(48 / (time.time() - t0))
        fps[setting] = statistics.median(windows)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        log("fps", card=card_name, setting=setting, width=WIDTH,
            height=HEIGHT, fps_windows=windows, fps_median=fps[setting],
            clocks_after=clocks,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # unprofiled passes first: once a torch.profiler session has run, the
    # host stays slower for the rest of the process
    passes = {setting: pass_ms(fn, cams) for setting, fn in render_fns.items()}
    quality(cap_slot=store["_slot_features"][0],
            cap_render=cap["render_forward"],
            served=images["expand"][0], card_name=card_name)

    # ---- training: settings, kernels vs plain, the golden replay
    setups, rng = build_training(card_name)
    train_caps = capture_training(setups, card_name)
    train_kernels = check_training_kernels(train_caps, card_name)
    check_large_tiles(setups["100k-800x800"], card_name)
    # the swin setting continues bench.py's draws
    swin_st = build_swin(rng, setups["100k-800x800"]["settings"].k_dup,
                         card_name)
    swin_cap = capture_swin(swin_st)
    check_training_kernels({SWIN_NAME: swin_cap}, card_name)
    check_merge_expand(*swin_cap["merge_expand"], card_name,
                       setting=SWIN_NAME)
    for name, c in train_caps.items():
        starts_t, pack_t, k_t = c["merge_expand"]
        log("kernel_yardstick", card=card_name, setting=name,
            name="merge_expand", shape=f"P={starts_t.shape[0]} K={k_t}",
            ms=cuda_ms(lambda: scan_kernel.merge_expand(starts_t, pack_t,
                                                        k_t), 20),
            **merge_bound(starts_t.shape[0], k_t),
            owners_only_searchsorted_ms=searchsorted_ms(starts_t, k_t))
    train_small(card_name)

    # ---- training main paths, counts zeroed before each setting
    wrappers.update(tile_blend_forward=tile_kernel.tile_blend_forward,
                    tile_blend_backward=tile_kernel.tile_blend_backward,
                    multi_cumsum=scan_kernel.multi_cumsum,
                    multi_cummax=scan_kernel.multi_cummax)
    for name in ("tile_blend_forward", "tile_blend_backward",
                 "multi_cumsum"):
        kernels[name] = dict(train_kernels[name]["1m-1296x840"])
    train_launches, step_ms, trained = {}, {}, {}
    for name, st in setups.items():
        train_launches[name], step_ms[name], *trained[name] = train_setting(
            name, st, wrappers, card_name)
    cli_phase(card_name)

    # ---- the swin main paths, counts zeroed before each: training, the
    # window slide, the CLI and its playback
    swin_launches = {}
    swin_launches["train"], swin_ms, *swin_trained = swin_train(
        swin_st, wrappers, card_name)
    swin_launches["slide"] = swin_slide(swin_st, *swin_trained, wrappers,
                                        card_name)
    swin_launches["cli"] = swin_cli(wrappers, card_name)
    for name in wrappers:
        kernels[name]["launches"] = sum(
            n.get(name, 0) for group in (launches, train_launches,
                                         swin_launches)
            for n in group.values())

    # ---- device time by kernel, after every unprofiled timing
    for setting, fn in render_fns.items():
        profile_frames(fn, cams, setting, 1e3 / fps[setting], passes[setting],
                       card_name)
    for name, st in setups.items():
        profile_train(name, st, *trained[name], step_ms[name], card_name)
    profile_swin(swin_st, *swin_trained, swin_ms, card_name)

    log("done", card=card_name, seconds=time.time() - t_start)
    print(card_name)
    print(json.dumps({"kernels": [
        {k: v for k, v in kernels[name].items()
         if k in KERNEL_LINE_KEYS}
        for name in ("expand_scan", "merge_expand", "render_forward",
                     "tile_blend_forward", "tile_blend_backward",
                     "multi_cumsum", "multi_cummax")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
