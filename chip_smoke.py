#!/usr/bin/env python3
"""On-card smoke test of gsplat_tpu_torch (one NVIDIA GPU): the serving
path, the static training path, checkpoints, RNG replay and profiling,
SwinGS training, ARAP and playback, the eval entry points and the
multi-rank modes (ranks sharing the card over gloo).

Run from the root of a checkout:  python3 chip_smoke.py

It builds the CUDA kernels from gsplat_tpu_torch/csrc, then

- serves a 100k-Gaussian SH-3 model (written as a PLY from a seed) at
  cap_max 1M and 1920x1088 through the port's own entry points, in the
  server's two owner-expansion settings:
    expand   k_dup = 8 x cap_max = 8,000,000 (the server's default):
             scatter-max + the expand_scan kernel (2 k_dup >= 7 P)
    merge    --dup_budget 877,568 (raised by the 1.02 rule if a camera
             needs more): the merge_expand kernel (2 k_dup < 7 P)
- trains in bench.py's two static settings (bench_torch.py's recipes):
    100k-800x800  100k Gaussians, 8 orbit cameras, 64x16 tiles; the
                  per-Gaussian gradient reduction is one scatter-add
    1m-1296x840   1M Gaussians with trained-scene opacity/scale
                  statistics, 4 cameras; the reduction is sort +
                  multi_cumsum (P > 250k rows)
  both binning through merge_expand;
- renders and scores a 1M-row model through the eval entry points
  (eval/render.py, eval/metrics.py) on a synthetic COLMAP scene at
  1237x822;
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
               multi_cummax held alone (its main-path input is checked
               in the determinism phase) bit-equal to torch.cummax at
               3 x 8M, one launch a call, two launches bit-equal,
               beside torch.cummax's time
  small        a 300-Gaussian scene rendered on the card vs the port on
               the CPU
  serve        per setting, its 8 cameras rendered through
               viewer.serve.make_render_fn (each frame a replay of its
               CUDA graph, captured in the probe; the launches are counted
               in the profile phase); the 16 served uint8 frames' bytes
               against the host's numpy encode of the eager render_image's
               bf16 images of the same cameras (0 differing bytes);
               encode_rgb8 timed alone (CUDA events),
               a frame's bytes both ways and the copies into pageable and
               page-locked memory
  socket       python -m gsplat_tpu_torch.viewer.serve per setting, 3 SIBR
               requests; reply bytes must equal the in-process image
  fps          frames/s over 3 windows of 48 frames per setting
               (bench_torch.timed_windows)
  quality      the served frame vs the plain render of an f32 stream
  bench_render bench_torch.render_stage in process (the bare 100k scene
               at 1920x1088, 128x32 tiles: no dead rows, expand_scan),
               counts zeroed: one expand_scan, one render_forward and
               one encode_rgb8 a frame (8 probe, 8 warm, 3 x 48 timed),
               nothing else; the
               probed num_dup against the TPU record (rel <= 1e-3)
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
  train_small  tests/fixtures/hw_parity_golden.npz replayed without JAX
               (bench_torch.golden_replay and its gates), then one split
               densify iteration
  train        per setting, counts zeroed: one warm step, 3 windows of
               fused steps (20 / 10), counts read and held to one blend
               forward, one blend backward and one merge_expand per step
               (multi_cumsum one per step at 1M, none at 100k); then one
               untimed split densify iteration, counts zeroed: the step's
               kernels and one multi_cumsum a template draw (two)
  cli          python -m gsplat_tpu_torch.train.train_static on the
               committed Blender fixture (300 iterations), held-out PSNR
               >= 21.0 dB
  eval         eval-1m-1237x822: a synthetic COLMAP scene at MipNeRF-360
               bicycle's images_4 size (1237x822, 24 orbit views, 3 held
               out, a 100k-point points3D.bin, ground truths rendered from
               bench.py's ground-truth scene) and the 1M setting's trained
               state saved at iteration 30000; python -m
               gsplat_tpu_torch.eval.render (both splits, --cap_max 1M:
               auto k_dup 6M, expand_scan) in a subprocess whose launch
               counts must be one expand_scan and one blend forward a view
               and nothing else, num_dup <= k_dup every view, test view 0
               rendered in process to the CLI's PNG bytes; python -m
               gsplat_tpu_torch.eval.metrics with a random-weight VGG npz
               (not LPIPS weights): SSIM / PSNR equal to the port's losses
               on the same PNG pairs within 1e-6, LPIPS finite and equal
               on the card and the CPU within 1e-5 relative
  swin_train   counts zeroed: one warm step and 3 windows of 10 fused
               swin steps (frame it % 8, camera it % 4), one blend
               forward, blend backward, merge_expand and multi_cumsum a
               step and nothing else
  swin_slide   decay_genesis -> tick -> evolve (ring + stream_dump +
               rollover) -> densify (counts zeroed: one multi_cumsum a
               window frame and one for growth, nothing else) -> one
               window of steps in the new window; matured rows active and
               rendered, records = matured
  determinism  per training setting (train-100k, train-1m, swin-200k) at
               full width, n_alive cut to 95% of the rows and every 100th
               alive row dead: 3 steps, one densification (relocation and
               growth; SwinGS over the window) and 2 steps from one seeded
               generator, twice: every state and Adam leaf, n_alive and
               every draw's templates bit-equal, no zero-probability
               template drawn, launch counts (one multi_cumsum and one
               multi_cummax a draw); on the relocation's own
               probabilities the bit patterns of 4 torch.cumsum and 4
               multi_cumsum calls, multi_cummax on the CDF's bits against
               plain and twice bit-equal (the kernels line's multi_cummax
               entry at 1M), the raw CDFs' steps at zero rows and tile
               joins, densification wall ms (median of 3) beside a
               torch.cumsum CDF's; at 100k the scatter-add reduction twice
               bit-equal
  resume       bench.py's 100k setting driven as --replay_rng drives the
               trainer (a schedule written here: cameras, noise, three
               relocations), 20 steps with a checkpoint at 10, the
               checkpoint loaded and the run resumed: the checkpoint
               round-trips bit-equal, the resumed losses, final state and
               Adam moments bit-equal to the uninterrupted run's; counts
               zeroed before it
  replay       python -m gsplat_tpu_torch.train.train_static --replay_rng
               on the committed Blender fixture, on the card (launch
               counts of that process) and on the port's CPU path:
               per-iteration loss rel <= 4.1e-4
  profile_cli  that card run's --profile_iterations trace names the blend
               forward, blend backward and owner-expansion kernels once
               an iteration
  arap         one fused swin step with ARAP at the swin setting, counts
               zeroed before it; arap_loss and its gradient on the card
               vs the CPU (1e-5 / 1e-4); knn_indices' time over the
               200k immature rows and the 400k union rows
  soak         scripts/torch_soak_30k.py's set-up at full size (cap 100k,
               800x800, a 20k-Gaussian GT, 24 cameras, 3 held out) and its
               loop for 1,200 iterations (7 densifications from 600, SH
               degree 1 at 1,000, held-out PSNR at 600 and 1,200, the live
               budget policy), counts zeroed: every checked loss finite,
               n_alive as densify's +5% rule says, the PSNR at 1,200 above
               the PSNR at 600, no overflow after a budget change, one
               blend forward and one owner expansion a render, one blend
               backward a step, one multi_cummax a template draw; then
               one step and one densification from the final (just
               densified) state, the blends, the owner expansion and the
               draws' multi_cumsum and multi_cummax held against their
               plain versions (the kernel phase's gates)
  soak_swin    scripts/torch_soak_swin.py at full width (cap 200k, swin 8,
               1280x720, a moving 100k-Gaussian GT, 4 cameras) on
               soak_swin.py's CPU schedule (12 frames, genesis 60, windows
               30): genesis, decay_genesis, every evolve, mature_rest,
               then playback, counts zeroed before each: window losses
               finite, the first evolve streams all 200k genesis rows and
               each later tick 25k, the stream holds their sum with
               mature_rest's, one blend backward and one multi_cumsum a
               step, playback finite (its PSNR against the GT logged, not
               gated; one render, one encode and one owner expansion a
               played frame); the first played frame's render and owner
               expansion held against their plain versions
  parallel     (after the profiles, in processes of their own) four gloo
               ranks sharing the card: dp, pshard and dp x ps (2 x 2) at
               train-1m, swin-dp at the swin setting, a tileshard render
               of the eval model at 1237x822 (two bands), each held
               against the single-device path on the card (dp / swin-dp
               loss rel 1e-5 and params 2e-4; pshard and dp x ps loss rel
               5e-3; tileshard 2e-5); each training mode densifies after
               its second step with no broadcast, and the ranks' digests
               of the densified state and moments are equal; launch
               counts per rank and mode, and on rank 0 every kernel of
               the mode against its plain version on that mode's inputs
               (the kernel phase's gates); step times are of ranks
               sharing one card, not a scaling figure
  swin_cli     train_swin.main on the dynamic fixture (the flags of
               tests/test_stream_semantic.py), stream playback vs the
               direct render (>= 24 dB) and vs GT (>= 15 dB), then
               render_stream.main: one render, one owner expansion and
               one encode a view
  profile      device time by kernel, serving, after every unprofiled
               timing (the port's kernels each by name: their own device
               time); the idle share against the unprofiled frame time;
               the served frames' launches from the same CUDA trace, by
               kernel name (one owner expansion, render_forward and
               encode_rgb8 a replayed frame, the other expansion never)
  train_profile  the same for 3 training steps per setting
  swin_profile   the same for 3 swin steps
  cummax_profile multi_cummax's own device time beside its event time
  determinism_profile  device ms of multi_cumsum, torch.cumsum,
               multi_cummax and torch.cummax on each setting's [1, C]
               relocation probabilities; of the 100k step's reduction by
               index_put_, index_add_ and sort + multi_cumsum
  bench_cli    (last) python3 bench_torch.py at full size in a subprocess:
               rc 0, one JSON line with bench.py's keys and ``device``,
               every rate and time finite and > 0, the parity fields;
               logged beside the in-process figures of the same settings
               (train, swin_train, bench_render) and their ratios, ungated;
               its launch counts are its own process's

Then the card's name and power limit (nvidia-smi), the kernels line and
{"ok": true, "device": {...}} as the last line. Exits non-zero with no
result when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

import bench_torch as bench

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


card = bench.card


# ---------------------------------------------------------------- scene ----

def write_scene_ply(path: str, p: int, sh_degree: int, seed: int = 0):
    """The bench's render-stage model as a PLY."""
    from gsplat_tpu_torch.data import ply

    means, log_scales, quats, opa_logit, shs = bench.scene_arrays(
        p, sh_degree, seed)
    ply.save_gaussian_ply(path, means, shs[:, :1], shs[:, 1:],
                          opa_logit[:, None], log_scales, quats)


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
    two settings' k_dup and render functions (each called once, which
    captures its CUDA graph), the frame's rows, and the kernel inputs
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
    cams = bench.orbit_cameras(8, WIDTH, HEIGHT, DEVICE)
    p = state.capacity

    # num_dup per camera; kernel inputs of camera 0
    k_expand = 8 * CAP_MAX
    rows = (state.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], state.get_features())
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
            _, num_dup = rast.render_frame(*rows, cam, SH_DEGREE, bg,
                                           k_expand, alive=state.alive_mask)
            need.append(int(num_dup))
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
    render_fns["expand"](cams[0])
    for key in ("expand_scan", "merge_expand", "render_forward"):
        if not store[key]:
            raise AssertionError(f"the main path did not call {key}")
        cap[key] = store[key][0]
    log("probe", card=card_name, gaussians=state.n_alive, capacity=p,
        num_dup=need, k_dup={"expand": k_expand, "merge": k_merge})
    return dict(cams=cams, model_dir=model_dir,
                k_dup={"expand": k_expand, "merge": k_merge},
                render_fns=render_fns, store=store, cap=cap,
                rows=rows + (state.alive_mask,))


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


def cummax_input():
    """multi_cummax's input when held alone (its main-path input, the
    template CDF's bits, is checked in the determinism phase): n = 3, K =
    8M int32 drawn from numpy's generator at seed 0, INT_MIN in a
    prefix of row 0 (the TPU wrapper's padding value)."""
    import torch

    n, k = CUMMAX_SHAPE
    rng = np.random.default_rng(0)
    host = rng.integers(-2**31, 2**31, size=(n, k), dtype=np.int64)
    host[0, :4096 + 77] = -2**31
    return torch.as_tensor(host.astype(np.int32), device=DEVICE)


def device_ms(fn, reps, names):
    """Mean device milliseconds a call of ``fn`` spends in kernels whose
    name holds one of ``names`` (torch.profiler's CUDA activity): the
    kernels alone, without the host time of the call, which bounds event
    times of a few microseconds. A profiler session slows the host for the
    rest of the process: call it after every wall-clock timing. A session
    that records no such kernel (seen once on the card for a kernel that
    did run) is repeated, twice at most; then None ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if any(n in e.key for n in names))
        if total:
            return total / 1e3 / reps
    return None


def check_multi_cummax(card_name):
    """multi_cummax bit-equal to torch.cummax per row on
    ``cummax_input()``, one launch a call, two launches bit-equal; its
    event time (``ms``) beside torch.cummax's. Its device time is taken
    in the profile phase (``cummax_device_ms``)."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    x = cummax_input()
    n, k = x.shape
    before = scan_kernel.multi_cummax.launches
    got = scan_kernel.multi_cummax(x)
    again = scan_kernel.multi_cummax(x)
    want = scan_kernel.multi_cummax_plain(x)
    torch.cuda.synchronize()
    if scan_kernel.multi_cummax.launches != before + 2:
        raise AssertionError("multi_cummax: not one launch a call")
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"multi_cummax differs from plain: {err}")
    if not torch.equal(got, again):
        raise AssertionError("two multi_cummax launches differ")
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


def cummax_device_ms(entry, card_name):
    """multi_cummax's own device time (torch.profiler) on its input, beside
    the event time of the kernel phase: logged and kept in ``entry``."""
    from gsplat_tpu_torch.raster import scan_kernel

    x = cummax_input()
    entry["device_ms"] = device_ms(lambda: scan_kernel.multi_cummax(x), 20,
                                   ("multi_cummax_kernel",))
    log("cummax_profile", card=card_name, name="multi_cummax",
        shape=entry["shape"], ms=entry["ms"], device_ms=entry["device_ms"],
        bound_ms=entry["bound_ms"])


def check_small(card_name):
    """300 Gaussians, 256x64 at 128x32 tiles: card vs the CPU port."""
    import torch

    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster.rasterize import render_image

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
    imgs = []
    for dev in ("cpu", DEVICE):
        state = gaussians.state_from_numpy(par, n, 1, dev)
        cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 256, 64,
                          device=dev)
        imgs.append(render_image(
            state.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], state.get_features(), cam, 1,
            [0.2, 0.3, 0.4], 1536, alive=state.alive_mask))
    torch.cuda.synchronize()
    want, got = imgs[0][0].float(), imgs[1][0].float().cpu()
    if int(imgs[0][1]) != int(imgs[1][1]):
        raise AssertionError("num_dup differs between card and CPU")
    if not within_bf16_ulps(got, want):
        raise AssertionError("small scene: card vs CPU port beyond 2 ULPs")
    log("small", card=card_name, num_dup=int(imgs[1][1]),
        max_abs_err=float((got - want).abs().max()), mean=float(got.mean()))


def check_encode(raw, images, card_name):
    """The served frames' bytes (``encode_rgb8`` on the card) against the
    host's numpy encode of the same bf16 images (the server's bytes before
    the encode moved to the card): any differing byte fails. Times the
    kernel alone (CUDA events, through its wrapper and through the bare
    extension call, an output made once), its plain version, and a frame's
    bytes reaching the host both ways; the copies into pageable and
    page-locked memory. Returns the kernels-line entry."""
    import torch

    from gsplat_tpu_torch.raster import cuda_ext, tile_kernel
    from gsplat_tpu_torch.viewer import network_gui

    def host_encode(img):
        x = img.float().permute(1, 2, 0).cpu().numpy()
        return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8).tobytes()

    differ = frames = 0
    for setting, imgs in raw.items():
        for img, served in zip(imgs, images[setting]):
            got = np.frombuffer(network_gui.image_to_bytes(served), np.uint8)
            want = np.frombuffer(host_encode(img), np.uint8)
            differ += int((got != want).sum())
            frames += 1
    if differ or frames != sum(len(v) for v in images.values()):
        raise AssertionError(f"encode_rgb8: {differ} bytes differ from the "
                             f"host encode over {frames} frames")
    x = raw["expand"][0].contiguous()
    out = torch.empty(HEIGHT, WIDTH, 3, dtype=torch.uint8, device=DEVICE)
    ext = cuda_ext.load()
    entry = dict(
        name="encode_rgb8", route="cuda",
        source="gsplat_tpu_torch/csrc/encode_kernel.cu",
        replaces="none: gsplat_tpu/viewer/network_gui.py image_to_bytes "
                 "(numpy, host)",
        max_abs_err=0, differing_bytes=differ, frames=frames,
        ms=cuda_ms(lambda: tile_kernel.encode_rgb8(x), 200),
        ext_ms=cuda_ms(lambda: ext.encode_rgb8(x, out), 200),
        plain_ms=cuda_ms(lambda: tile_kernel.encode_rgb8_plain(x), 20),
        bound_ms=9 * WIDTH * HEIGHT / MEM_BPS * 1e3, bound_by="bytes",
        library_ms=None, shape=f"[3, {HEIGHT}, {WIDTH}] bf16")

    def wall_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    u8 = tile_kernel.encode_rgb8_plain(x).to(DEVICE)
    f32 = torch.clamp(x.float().permute(1, 2, 0), 0.0, 1.0)
    pinned = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
    log("kernel", card=card_name, **entry,
        bytes_ms_device_encode=wall_ms(
            lambda: network_gui.image_to_bytes(tile_kernel.encode_rgb8(x))),
        bytes_ms_host_encode=wall_ms(lambda: host_encode(x)),
        copy_ms={"u8_pinned": wall_ms(lambda: pinned.copy_(u8)),
                 "u8_pageable": wall_ms(lambda: u8.cpu()),
                 "f32_pageable": wall_ms(lambda: f32.cpu())})
    return entry


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
                "multi_cumsum_kernel", "encode_rgb8_kernel")


# the served frame's wrappers -> their kernels' names in the profiler
SERVED_KERNELS = {"expand_scan": "expand_scan_kernel",
                  "merge_expand": "merge_expand_kernel",
                  "render_forward": "render_kernel",
                  "encode_rgb8": "encode_rgb8_kernel"}


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
    before any profiling) and of the profiled pass are logged beside it.
    Returns {port kernel: launches in the pass}, read from the trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_pass_ms = pass_ms(fn, cams)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if (str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us
                and not getattr(e, "is_user_annotation", False)):
            rows.append((dev_us / 1e3 / len(cams), e.count // len(cams),
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    ran = {name: sum(e.count for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")
                     and name in e.key)
           for name in PORT_KERNELS}
    log("profile", card=card_name, setting=setting, frame_ms=frame_ms,
        unprofiled_pass_ms_per_frame=plain_pass_ms,
        profiled_pass_ms_per_frame=profiled_pass_ms,
        device_busy_ms_per_frame=busy if rows else "not measured",
        idle_share=(1 - busy / frame_ms) if rows else "not measured",
        kernels_per_frame=sum(r[1] for r in rows),
        port_kernels_ms_per_frame=port_kernel_ms(rows),
        port_kernel_launches=ran,
        top=[{"kernel": k[:70], "ms_per_frame": round(ms, 4), "calls": c}
             for ms, c, k in rows[:14]])
    return ran


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


# bench_torch's render stage (bench.py:337-376): the bare 100k scene (no
# dead rows) at 1920x1088, 128x32 tiles, the budget its probe x 1.02;
# num_dup / k_dup are the TPU records of the same stage (BENCH_r05.json)
BENCH_RENDER_NAME = "bench-render-100k-1080p"
BENCH_RENDER_TPU = dict(num_dup=859_464, k_dup=877_568)


def bench_render_phase(wrappers, card_name):
    """bench_torch.render_stage in process at its full size, counts zeroed
    just before it and read just after: one expand_scan, one
    render_forward and one encode_rgb8 a frame (the probe's, the warm
    pass's and the windows'), nothing else; its probed num_dup held to the TPU's record. Returns
    (launches, the stage's result)."""
    import torch

    cfg = bench.sizes(DEVICE)["render"]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    out = bench.render_stage(DEVICE, np.random.default_rng(0))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    frames = 2 * cfg["cams"] + 3 * cfg["frames"]
    want = {k: 0 for k in wrappers}
    want.update(expand_scan=frames, render_forward=frames,
                encode_rgb8=frames)
    if launches != want:
        raise AssertionError(f"{BENCH_RENDER_NAME}: launches {launches}, "
                             f"expected {want}")
    rel = abs(out["render_num_dup"] - BENCH_RENDER_TPU["num_dup"]) / \
        BENCH_RENDER_TPU["num_dup"]
    if rel > DUP_REL_GATE:
        raise AssertionError(f"{BENCH_RENDER_NAME}: num_dup "
                             f"{out['render_num_dup']} vs the TPU's "
                             f"{BENCH_RENDER_TPU['num_dup']} (rel {rel:.2e})")
    log("bench_render", card=card_name, setting=BENCH_RENDER_NAME,
        frames=frames, launches=launches,
        launches_per_frame={k: v / frames for k, v in launches.items()},
        tpu_num_dup=BENCH_RENDER_TPU["num_dup"], num_dup_rel=rel,
        k_dup=bench.render_k_dup(out["render_num_dup"]),
        tpu_k_dup=BENCH_RENDER_TPU["k_dup"], seconds=seconds, **out)
    return launches, out


# ------------------------------------------------------------- training ----

# The two static training settings: bench.py's (bench.py:254-335 and
# :379-430) at bench_torch's full sizes, built by bench_torch's recipes
# with numpy draws in bench.py's order. num_dup / k_dup are the TPU records
# of the same scenes (BENCH_r05.json).
TRAIN = {
    "100k-800x800": dict(bench.SIZES["cuda"]["train"], tpu_num_dup=138_188,
                         tpu_k_dup=154_880),
    "1m-1296x840": dict(bench.SIZES["cuda"]["train_1m"],
                        tpu_num_dup=3_063_690, tpu_k_dup=3_431_424),
}
TRAIN_P_GT = bench.SIZES["cuda"]["p_gt"]
DUP_REL_GATE = 1e-3   # bench.py's dup_rel gate against the TPU counts
TRAIN_TILE = (64, 16)
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


def build_training(card_name):
    """Both settings (bench_torch.static_setup): ground truths, initial
    states, probed budgets, each probe held to the TPU's record."""
    rng = np.random.default_rng(0)
    gt = bench.bench_gt_scene(rng, TRAIN_P_GT, DEVICE)
    out = {}
    k_first = None
    for name, cfg in TRAIN.items():
        t0 = time.time()
        if k_first is None:
            state = bench.uniform_state(rng, cfg["p"], DEVICE)
        else:
            state, _ = bench.trained_stats_state(cfg["p"], SH_DEGREE, rng,
                                                 DEVICE)
        st = bench.static_setup(DEVICE, gt, state, cfg,
                                k_first or cfg["k_probe"], TRAIN_TILE)
        need, settings, gts = st.pop("need"), st["settings"], st["gts"]
        if k_first is None:
            k_first = settings.k_dup
        rel = abs(max(need) - cfg["tpu_num_dup"]) / cfg["tpu_num_dup"]
        if rel > DUP_REL_GATE:
            raise AssertionError(f"{name}: num_dup {max(need)} vs the TPU's "
                                 f"{cfg['tpu_num_dup']} (rel {rel:.2e})")
        out[name] = st
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


def check_blend_forward(setting, forward, feat, meta, kw, want):
    """Hold one build's blend forward (a callable with the wrapper's
    signature) against the plain version's ``want`` = (ct, used): colour
    and T within 1e-5 and used > 0 identical per slot (flips at the 1e-4
    stop threshold, if any, show as whole pixels beyond tolerance; both
    counts are gated at zero). Returns the errors."""
    import torch

    want_ct, want_used = want
    got_ct, got_used = forward(feat, meta, **kw)
    torch.cuda.synchronize()
    bad_pix = int(((got_ct - want_ct).abs().amax(dim=1) > 1e-5).sum())
    bad_slots = int(((got_used > 0) != (want_used > 0)).sum())
    if bad_pix or bad_slots:
        raise AssertionError(f"{setting}: blend forward vs plain: {bad_pix} "
                             f"pixels beyond 1e-5, {bad_slots} slots differ "
                             f"in used > 0")
    return dict(fwd_max_abs_err=float((got_ct - want_ct).abs().max()),
                flips=bad_pix, used_mismatch=bad_slots)


def check_blend(setting, forward, backward, feat, meta, dpack, kw, want):
    """Hold one build's blend forward and backward (callables with the
    wrappers' signatures) against the plain versions' ``want`` = (ct,
    used, dfeat): the forward by check_blend_forward's gates, each dfeat
    row within 1e-4 of its maximum, two backward launches bit-equal.
    Returns the errors."""
    import torch

    want_ct, want_used, want_d = want
    fwd = check_blend_forward(setting, forward, feat, meta, kw,
                              (want_ct, want_used))
    got = backward(feat, meta, dpack, **kw)
    again = backward(feat, meta, dpack, **kw)
    torch.cuda.synchronize()
    row_max = want_d.abs().amax(dim=1)
    row_err = (got - want_d).abs().amax(dim=1)
    if bool((row_err > 1e-4 * row_max).any()):
        raise AssertionError(f"{setting}: blend backward vs plain, row "
                             f"errors {row_err.tolist()} vs maxima "
                             f"{row_max.tolist()}")
    if not torch.equal(got, again):
        raise AssertionError(f"{setting}: two blend backward launches differ")
    return dict(
        fwd_max_abs_err=fwd["fwd_max_abs_err"], flips=fwd["flips"],
        bwd_max_abs_err=float((got - want_d).abs().max()),
        max_rel_row_err=float((row_err / row_max.clamp(min=1e-30)).max()))


def blend_bytes(meta, kw, stats, k, out_bytes_per_slot):
    """The bytes a blend launch must move: the visited chunks' slots (9
    floats each) and the chunk table, 4 floats a pixel, and
    ``out_bytes_per_slot`` for each of the ``k`` slots. With the passing pairs'
    ops this gives bound_ms, the work this run's data needs (alpha >=
    1/255); bound_all_pairs_ms counts every pair whose pixel is not done
    (the work without culling), the first kernels' bound."""
    slot_bytes = stats["chunks"] * kw["chunk"] * 36 + meta.numel() * 4
    return (slot_bytes + kw["num_tiles"] * 16 * kw["n_pix"]
            + out_bytes_per_slot * k)


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
        k = feat.shape[1]
        shape = (f"tiles={kw['num_tiles']} slots={k} visited_chunks="
                 f"{stats['chunks']} live_pairs={stats['pairs']}")
        cull = dict(passing_pairs=stats["passing"],
                    kept_warp_slot_share=kept_slot_share(
                        feat, meta, stats["visited"], kw,
                        tile_kernel.BLEND_WARP_BLOCK),
                    kept_sub_block_slot_share=kept_slot_share(
                        feat, meta, stats["visited"], kw,
                        tile_kernel.BLEND_SUB_BLOCK))
        for kname, tpu_line, nbytes, ops, run, plain in (
                ("tile_blend_forward", 348,
                 blend_bytes(meta, kw, stats, k, 4), BLEND_FWD_OPS_PER_PAIR,
                 lambda: tile_kernel.tile_blend_forward(feat, meta, **kw),
                 lambda: tile_kernel.tile_blend_forward_plain(feat, meta,
                                                              **kw)),
                ("tile_blend_backward", 526,
                 blend_bytes(meta, kw, stats, k, 36), BLEND_BWD_OPS_PER_PAIR,
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


def train_small(card_name):
    """hw_parity_golden.npz replayed through the port
    (bench_torch.golden_replay: images, loss, num_dup and the Adam deltas
    of one train step against the golden, with its gates); then one split
    densify iteration on a state of twice the capacity."""
    from gsplat_tpu_torch.model import gaussians, optim
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    inp = bench.golden_inputs(DEVICE)
    res = bench.golden_replay(inp)

    # one split densify iteration at twice the capacity
    p_model = bench.GOLDEN["p_model"]
    cam, gt, bg, gen = inp["cam"], inp["gt"], inp["bg"], inp["gen"]
    settings, opt = inp["settings"], OptimizationConfig()
    big = gaussians.create_from_points(inp["pts"], inp["colors"],
                                       2 * p_model, SH_DEGREE, device=DEVICE)
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
    iteration, its counts read on their own. Returns (launches of both,
    ms per step, state, adam)."""
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
    state, adam, ms, losses, max_dup = bench.static_windows(
        step, state, adam, gen, st, cfg["wit"])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    it = 3 * cfg["wit"]
    steps = 1 + it
    segsum = "1m" in name
    want = {k: 0 for k in wrappers}
    want.update(tile_blend_forward=steps, tile_blend_backward=steps,
                merge_expand=steps, multi_cumsum=steps if segsum else 0)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    bench.check_windows(name, losses, max_dup, settings.k_dup)

    # one untimed split densify iteration (grad -> densify -> Adam +
    # noise), counts zeroed before it: the step's kernels and one
    # multi_cumsum and one multi_cummax a template draw (relocation and
    # growth)
    dead = int((state.alive_mask & (state.get_opacity()[:, 0] <= 0.005)
                ).sum())
    for w in wrappers.values():
        w.launches = 0
    grads, _ = step_lib.make_grad_step(opt, settings, 4.0)(
        state, cams[0], gts[0], bg, SH_DEGREE)
    n_before = state.n_alive
    state, adam = step_lib.make_densify_step(state.capacity)(state, adam,
                                                             gen)
    state, adam = step_lib.make_apply_step(opt, 4.0)(
        state, adam, grads, gen, float(it + 2), dead == 0)
    torch.cuda.synchronize()
    dens = {k: w.launches for k, w in wrappers.items()}
    want = {k: 0 for k in wrappers}
    want.update(tile_blend_forward=1, tile_blend_backward=1, merge_expand=1,
                multi_cumsum=3 if segsum else 2, multi_cummax=2)
    if dens != want:
        raise AssertionError(f"{name} densify iteration: launches {dens}, "
                             f"expected {want}")
    if segsum and dead == 0:
        raise AssertionError(f"{name}: relocation moved no rows")
    log("train", card=card_name, setting=name, steps=steps,
        window_ms_per_step=ms, ms_per_step_median=statistics.median(ms),
        it_per_s_median=1e3 / statistics.median(ms), window_losses=losses,
        max_num_dup=max_dup, k_dup=settings.k_dup,
        launches_per_step={k: v / steps for k, v in launches.items()},
        densify_relocated=dead, n_alive_before=n_before,
        n_alive_after=state.n_alive, densify_iteration_launches=dens,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return ({k: v + dens[k] for k, v in launches.items()},
            statistics.median(ms), state, adam)


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
        if (str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us
                and not getattr(e, "is_user_annotation", False)):
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


# ---------------------------------------------------------------- eval ----

# The evaluation path at MipNeRF-360 bicycle's images_4 size (the
# "-i images_4" job of eval/full_eval.py): a synthetic COLMAP scene of 24
# views on a circle of radius 4 around the origin, looking at it (llffhold
# 8: 3 test views), with a 100k-point points3D.bin,
# ground truths rendered by the port from bench.py's ground-truth scene, a
# 1M-row trained-statistics SH-3 model at iteration 30000, rendered at
# --cap_max 1000000 (auto k_dup 6,000,000: 2 K >= 7 P, expand_scan).
EVAL = dict(width=1237, height=822, views=24, points=100_000, cap=1_000_000,
            iteration=30_000, images="images_4")
EVAL_NAME = "eval-1m-1237x822"
# runs a module as __main__ (what python -m does) and prints the kernel
# wrappers' launch counts of that process afterwards
RUN_COUNTED = (
    "import json, runpy, sys\n"
    "from gsplat_tpu_torch.raster import scan_kernel as s, tile_kernel as t\n"
    "mod = sys.argv[1]\n"
    "sys.argv = [mod] + sys.argv[2:]\n"
    "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
    "print('LAUNCHES ' + json.dumps({f.__name__: f.launches for f in (\n"
    "    s.expand_scan, s.merge_expand, s.multi_cumsum, s.multi_cummax,\n"
    "    t.render_forward, t.tile_blend_forward, t.tile_blend_backward)}))\n")


def write_eval_scene(root, state):
    """The synthetic COLMAP scene (binary sparse/0, one PINHOLE camera,
    EVAL["views"] orbit images written as PNGs rendered from
    bench_gt_scene) and the model directory (``state`` saved as
    point_cloud/iteration_30000/point_cloud.ply, a cfg_args)."""
    import argparse
    import shutil

    import torch

    from gsplat_tpu_torch.core.camera import fov2focal, make_camera
    from gsplat_tpu_torch.data import colmap, readers
    from gsplat_tpu_torch.eval.render import save_png
    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.train.config import ModelConfig, save_cfg_args

    w, h, n = EVAL["width"], EVAL["height"], EVAL["views"]
    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    for d in (src, model):
        shutil.rmtree(d, ignore_errors=True)
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    rng = np.random.default_rng(7)
    focal = fov2focal(0.9, w)
    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", w, h,
                               np.array([focal, focal, w / 2, h / 2]))})
    imgs = {}
    for i, (rcw, pos) in enumerate(bench.orbit_poses(
            n, radius=4.0, center=(0.0, 0.0, 0.0))):
        imgs[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(rcw.T), -rcw.T @ pos, 1,
            f"view_{i:03d}.png")
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), imgs)
    colmap.write_points3d_binary(
        os.path.join(sparse, "points3D.bin"),
        rng.uniform(-1, 1, (EVAL["points"], 3)),
        rng.integers(0, 256, (EVAL["points"], 3)).astype(np.uint8))
    info = readers.read_colmap_scene(src, images=EVAL["images"])
    gt = bench.bench_gt_scene(rng, TRAIN_P_GT, DEVICE)
    settings = rast.RasterizeSettings(k_dup=4_000_000, tile_x=64,
                                      tile_y=16, chunk=128)
    bg = torch.zeros(3, device=DEVICE)
    dups = []
    with torch.no_grad():
        for c in info.train_cameras + info.test_cameras:
            out = rast.rasterize(*gt, make_camera(c.R, c.T, c.fovx, c.fovy,
                                                  w, h, device=DEVICE),
                                 SH_DEGREE, bg, settings)
            dups.append(int(out.num_dup))
            save_png(c.image_path, out.image.clamp(0, 1).cpu().numpy())
    if max(dups) > settings.k_dup:
        raise AssertionError(f"eval ground truths: num_dup {max(dups)}")
    gaussians.save_ply(state, os.path.join(
        model, "point_cloud", f"iteration_{EVAL['iteration']}",
        "point_cloud.ply"))
    save_cfg_args(model, argparse.Namespace(**{
        **{f: getattr(ModelConfig(), f) for f in (
            "sh_degree", "resolution", "white_background", "data_device",
            "init_pts", "init_type")},
        "source_path": src, "model_path": model, "images": EVAL["images"],
        "eval": True, "cap_max": EVAL["cap"]}))
    return src, model, len(info.test_cameras)


def run_counted(args, log_path, env=None):
    """``python -m args[0] args[1:]`` in a subprocess (RUN_COUNTED), its
    output in ``log_path``; returns (stdout, the wrappers' launch counts of
    that process)."""
    res = subprocess.run([sys.executable, "-c", RUN_COUNTED] + args,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    with open(log_path, "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError(f"{args[0]} rc={res.returncode}: "
                           + (res.stdout + res.stderr)[-3000:])
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("LAUNCHES ")][-1]
    return res.stdout, json.loads(line[len("LAUNCHES "):])


def check_eval_kernels(expand_args, blend_args):
    """The eval render's two kernels against their plain versions on the
    inputs of one view (recorded: expand_scan's arguments, the blend
    forward's launch): expand_scan bit-equal (check_expand), the blend
    forward by check_blend_forward's gates; their times at this shape.
    Returns the eval line's fields."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel

    with torch.no_grad():
        marks, base_in = expand_args
        k = marks.shape[0]
        expand_err = check_expand(
            scan_kernel.expand_scan, marks, base_in,
            scan_kernel.expand_scan_plain(marks, base_in))
        feat, meta, kw = blend_kwargs(blend_args)
        stats = {}
        want = tile_kernel._blend_plain(feat, meta, stats=stats, **kw)
        errs = check_blend_forward(EVAL_NAME, tile_kernel.tile_blend_forward,
                                   feat, meta, kw, want)
        b_ms, b_by = bound(blend_bytes(meta, kw, stats, feat.shape[1], 4),
                           stats["passing"] * BLEND_FWD_OPS_PER_PAIR)
        return dict(
            expand_scan=dict(
                shape=f"K={k}", max_abs_err=expand_err,
                ms=cuda_ms(lambda: scan_kernel.expand_scan(marks, base_in),
                           20),
                plain_ms=cuda_ms(lambda: scan_kernel.expand_scan_plain(
                    marks, base_in), 2),
                bound_ms=20 * k / MEM_BPS * 1e3,
                bound_by="bytes", repeat_bit_equal=True),
            tile_blend_forward=dict(
                shape=f"tiles={kw['num_tiles']} slots={feat.shape[1]} "
                      f"visited_chunks={stats['chunks']} "
                      f"live_pairs={stats['pairs']}",
                passing_pairs=stats["passing"],
                max_abs_err=errs["fwd_max_abs_err"], flips=errs["flips"],
                used_mismatch=errs["used_mismatch"],
                ms=cuda_ms(lambda: tile_kernel.tile_blend_forward(
                    feat, meta, **kw), 10),
                plain_ms=cuda_ms(lambda: tile_kernel.tile_blend_forward_plain(
                    feat, meta, **kw), 1, warmup=0),
                bound_ms=b_ms, bound_by=b_by))


def eval_phase(state, card_name):
    """The eval entry points on the card, each in a subprocess: render
    (both splits, launch counts of that process: one expand_scan and one
    blend forward a view, nothing else), then metrics with a random-weight
    VGG npz (NOT LPIPS weights: the numbers exercise the path, they are no
    quality measure). Checks: test view 0 rendered in process gives the
    CLI's PNG bytes, and its expand_scan and blend forward inputs give the
    plain versions' results (check_eval_kernels); num_dup <= k_dup in
    every view; results.json's SSIM
    and PSNR equal the port's losses on the same PNG pairs within 1e-6;
    LPIPS finite, and on the card within 1e-5 relative of the same call on
    the CPU (view 0)."""
    import torch

    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.eval import lpips as lp
    from gsplat_tpu_torch.eval import metrics
    from gsplat_tpu_torch.eval.render import render_view, save_png
    from gsplat_tpu_torch.model import gaussians
    from gsplat_tpu_torch.raster import binning
    from gsplat_tpu_torch.train import losses
    from gsplat_tpu_torch.train.config import PipelineConfig
    from gsplat_tpu_torch.train.train_static import make_settings

    root = os.path.join(WORK, "eval")
    t0 = time.time()
    src, model, n_test = write_eval_scene(root, state)
    setup_s = time.time() - t0
    it = EVAL["iteration"]
    # the entry points default to the card; a rehearsal on the CPU says so
    device = [] if DEVICE == "cuda" else ["--data_device", DEVICE]
    torch.cuda.empty_cache()   # the subprocesses need the card's memory
    t0 = time.time()
    out, launches = run_counted(
        ["gsplat_tpu_torch.eval.render", "-m", model, "-s", src, "--eval",
         "--cap_max", str(EVAL["cap"]), "-i", EVAL["images"]] + device,
        os.path.join(root, "render.log"))
    render_s = time.time() - t0
    views = [ln.split() for ln in out.splitlines() if ln.startswith("view ")]
    fields = [dict(kv.split("=") for kv in v[3:]) for v in views]
    n_views = len(views)
    want = {k: 0 for k in launches}
    want.update(expand_scan=n_views, tile_blend_forward=n_views)
    if n_views != EVAL["views"] or launches != want:
        raise AssertionError(f"eval render: {n_views} views, launches "
                             f"{launches}, expected {want}")
    num_dup = [int(f["num_dup"]) for f in fields]
    k_dup = int(fields[0]["k_dup"])
    if max(num_dup) > k_dup or 2 * k_dup < 7 * EVAL["cap"]:
        raise AssertionError(f"eval render: num_dup {num_dup}, k_dup {k_dup}")

    # test view 0 in process, through the same functions, its two kernels'
    # inputs recorded
    scene = Scene(src, "", images=EVAL["images"], shuffle=False,
                  device=DEVICE)
    loaded = gaussians.load_ply(os.path.join(
        model, "point_cloud", f"iteration_{it}", "point_cloud.ply"),
        capacity=EVAL["cap"], max_sh_degree=SH_DEGREE, device=DEVICE)
    settings = make_settings(PipelineConfig(), EVAL["cap"])
    cam, _ = scene.test_cameras[0].load()
    expand, store = [], {"blend_forward": []}
    with capture_ext(store), capture(binning, "expand_scan", expand):
        img, _ = render_view(cam, loaded, settings,
                             torch.zeros(3, device=DEVICE))
    if not expand or not store["blend_forward"]:
        raise AssertionError("eval: the in-process render called no "
                             "expand_scan or no blend forward")
    kernels = check_eval_kernels(expand[0][0], store["blend_forward"][0])
    mine = os.path.join(root, "inprocess_test_00000.png")
    save_png(mine, img.cpu().numpy())
    test_dir = os.path.join(model, "test", f"ours_{it}")
    with open(mine, "rb") as a, open(os.path.join(
            test_dir, "renders", "00000.png"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("eval: the in-process render of test view "
                                 "0 differs from the CLI's PNG")

    npz = os.path.join(root, "lpips_vgg_random.npz")
    np.savez(npz, **lp.random_params("vgg", seed=0))
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.eval.metrics", "-m", model]
        + device,
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "LPIPS_WEIGHTS_NPZ": npz})
    metrics_s = time.time() - t0
    with open(os.path.join(root, "metrics.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError("eval metrics rc={}: {}".format(
            res.returncode, (res.stdout + res.stderr)[-3000:]))
    with open(os.path.join(model, "results.json")) as f:
        got = json.load(f)[f"ours_{it}"]
    names = sorted(os.listdir(os.path.join(test_dir, "renders")))
    pairs = [[torch.as_tensor(metrics.read_image(os.path.join(
        test_dir, d, name)), device=DEVICE) for d in ("renders", "gt")]
        for name in names]
    with torch.no_grad():
        ssim = float(np.mean([float(losses.ssim(a, b)) for a, b in pairs]))
        psnr_ = float(np.mean([float(losses.psnr(a, b)) for a, b in pairs]))
    if (len(names) != n_test or abs(got["SSIM"] - ssim) > 1e-6
            or abs(got["PSNR"] - psnr_) > 1e-6):
        raise AssertionError(f"eval metrics {got} vs direct SSIM {ssim}, "
                             f"PSNR {psnr_} over {names}")
    weights = lp.random_params("vgg", seed=0)
    card_l = float(lp.lpips_from_params(weights, *pairs[0]))
    cpu_l = float(lp.lpips_from_params(weights, pairs[0][0].cpu(),
                                       pairs[0][1].cpu()))
    if not (math.isfinite(got["LPIPS"]) and math.isfinite(card_l)
            and abs(card_l - cpu_l) <= 1e-5 * abs(cpu_l)):
        raise AssertionError(f"eval LPIPS {got['LPIPS']}: card {card_l} vs "
                             f"cpu {cpu_l}")
    log("eval", card=card_name, setting=EVAL_NAME,
        image=f"{EVAL['width']}x{EVAL['height']}", gaussians=state.n_alive,
        views=n_views, test_views=n_test, k_dup=k_dup, num_dup=num_dup,
        render_s_per_view=[float(f["render_s"]) for f in fields],
        write_s_per_view=[float(f["write_s"]) for f in fields],
        setup_s=setup_s, render_cli_s=render_s, metrics_cli_s=metrics_s,
        launches=launches, png_identical_in_process=True, **kernels,
        psnr=got["PSNR"], ssim=got["SSIM"], lpips=got["LPIPS"],
        lpips_weights="random (NOT LPIPS weights), seed 0",
        lpips_card_view0=card_l, lpips_cpu_view0=cpu_l,
        lpips_rel_card_cpu=abs(card_l - cpu_l) / abs(cpu_l))
    return launches


# ---------------------------------------------------------------- swin ----

# bench.py's SwinGS stage (bench.py:432-493) at bench_torch's full size:
# 200k immature rows and a 200k-row matured ring (a 400k-row union), swin
# 8, SH degree 1, deform, 1280x720, 4 orbit cameras, 64x16 tiles,
# spatial_lr_scale 4.0; num_dup / k_dup are the TPU records of the same
# scene (BENCH_r05.json's tail).
SWIN = dict(bench.SIZES["cuda"]["swin"], tpu_num_dup=261_237,
            tpu_k_dup=313_600, frames=16)
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
    """The swin setting (bench_torch.swin_setup: the state from the next
    draws of bench.py's ``rng``, the ground truths at the 100k setting's
    budget ``k_gt``), its frame-0 probe held to the TPU's record."""
    t0 = time.time()
    cfg = SWIN
    st = bench.swin_setup(DEVICE, rng, cfg, TRAIN_P_GT, k_gt, TRAIN_TILE)
    need, settings, state = st.pop("need"), st["settings"], st["state"]
    rel = abs(max(need) - cfg["tpu_num_dup"]) / cfg["tpu_num_dup"]
    if rel > DUP_REL_GATE:
        raise AssertionError(f"swin: num_dup {max(need)} vs the TPU's "
                             f"{cfg['tpu_num_dup']} (rel {rel:.2e})")
    log("train_probe", card=card_name, setting=SWIN_NAME,
        immature=state.im.n_alive, union_rows=2 * cfg["cap"],
        image=f"{cfg['width']}x{cfg['height']}", num_dup_per_camera=need,
        num_dup_max=max(need), tpu_num_dup=cfg["tpu_num_dup"],
        num_dup_rel=rel, k_dup=settings.k_dup, tpu_k_dup=cfg["tpu_k_dup"],
        gt_means=[round(float(g.mean()), 5) for g in st["gts"]],
        seconds=time.time() - t0)
    return st


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
    state, adam, ms, losses, max_dup = bench.swin_windows(
        step, state, adam, gen, st, SWIN)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = 1 + 3 * SWIN["wit"]
    swin_launches_ok(launches, steps, "swin_train")
    bench.check_windows("swin_train", losses, max_dup, settings.k_dup)
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
    the genesis growth; one multi_cumsum a draw, nothing else) -> one
    window of steps in the new window, counts zeroed before each of the
    two; then a render of the union at the new window's first frame with
    the ring in it."""
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
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    state, adam = swin_step.make_swin_densify_step(cap, SWIN["lifespan"])(
        state, adam, gen, float(mgr.frame_start), True)
    torch.cuda.synchronize()
    densify_ms = (time.perf_counter() - t0) * 1e3
    dens = {k: w.launches for k, w in wrappers.items()}
    # one multi_cumsum and one multi_cummax a template draw: a window
    # frame each, then growth
    want = {k: 0 for k in wrappers}
    want["multi_cumsum"] = want["multi_cummax"] = SWIN["lifespan"] + 1
    if dens != want:
        raise AssertionError(f"swin_slide densify: launches {dens}, "
                             f"expected {want}")
    step = swin_step.make_swin_train_step(OptimizationConfig(),
                                          st["settings"], 4.0)
    for w in wrappers.values():
        w.launches = 0
    state, adam, ms, losses, max_dup = bench.swin_windows(
        step, state, adam, gen, st, SWIN, windows=1,
        first_frame=mgr.frame_start)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = SWIN["wit"]
    swin_launches_ok(launches, steps, "swin_slide")
    bench.check_windows("swin_slide", losses, max_dup, st["settings"].k_dup)
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
        densify_ms=densify_ms, densify_launches=dens,
        immature_after=state.im.n_alive, steps=steps, ms_per_step=ms,
        losses=losses, max_num_dup=max_dup)
    return {k: v + dens[k] for k, v in launches.items()}


def swin_cli(wrappers, card_name):
    """train_swin.main on a copy of the dynamic fixture with
    tests/test_stream_semantic.py's flags, then playback: the stream vs the
    direct render of the final state (gate 24 dB, the direct one at that
    test's settings) and vs the ground truth (gate 15 dB); then
    render_stream.main, counts zeroed before it."""
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
                    data, camera, float(f), bg, 8192).float() / 255
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
                 if k not in ("expand_scan", "merge_expand", "render_forward",
                              "encode_rgb8"))
    if (views != 4 or launches["render_forward"] != views or owner != views
            or launches["encode_rgb8"] != views or others):
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


# ---------------------------------------------------------- determinism ----

# per setting: fused steps before and after the one densification; the
# share of the rows left alive (growth fills them) and the stride of the
# alive rows whose opacity is set below the relocation threshold
DETERMINISM = dict(before=3, after=2, alive=0.95, dead_every=100)
DET_SEGSUM = ("1m-1296x840", SWIN_NAME)   # settings on the sort reduction


def determinism_state(name, st):
    """The setting's state with n_alive cut to DETERMINISM["alive"] of its
    rows and every DETERMINISM["dead_every"]-th alive row's opacity logit
    at -8 (0.0003 < 0.005), so one densification both relocates and
    grows. The rows, the widths and the cameras are the setting's."""
    import dataclasses as dc

    state = st["state"]
    im = state.im if name == SWIN_NAME else state
    n = int(DETERMINISM["alive"] * im.capacity)
    opa = im.opacity.clone()
    opa[:n:DETERMINISM["dead_every"]] = -8.0
    im = dc.replace(im, n_alive=n, opacity=opa)
    return dc.replace(state, im=im) if name == SWIN_NAME else im


@contextlib.contextmanager
def record_draws(store):
    """Record (probs, templates) of every template draw: the static and
    the SwinGS densifications both call mcmc._sample_templates through
    the module."""
    from gsplat_tpu_torch.model import mcmc

    orig = mcmc._sample_templates

    def recorder(gen, probs, capacity):
        t = orig(gen, probs, capacity)
        store.append((probs, t))
        return t

    mcmc._sample_templates = recorder
    try:
        yield
    finally:
        mcmc._sample_templates = orig


def _det_fns(name, st):
    """(step(state, adam, gen, i) -> (state, adam, metrics),
    densify(state, adam, gen) -> (state, adam)) of the setting."""
    import torch

    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig

    opt = OptimizationConfig()
    bg = torch.zeros(3, device=DEVICE)
    cams, gts = st["cams"], st["gts"]
    if name == SWIN_NAME:
        step = swin_step.make_swin_train_step(opt, st["settings"], 4.0)
        dens = swin_step.make_swin_densify_step(SWIN["cap"],
                                                SWIN["lifespan"])
        return (lambda s, a, g, i: step(
            s, a, g, cams[i % 4], gts[i % 4], bg, float(i + 1),
            float(i % SWIN["lifespan"]), SWIN["sh"]),
            lambda s, a, g: dens(s, a, g, 0.0, True))
    step = step_lib.make_train_step(opt, st["settings"], 4.0)
    return (lambda s, a, g, i: step(s, a, g, cams[i % len(cams)],
                                    gts[i % len(cams)], bg, float(i + 1),
                                    SH_DEGREE),
            step_lib.make_densify_step(st["state"].capacity))


def determinism_run(name, st, state, wrappers, scatter=None):
    """DETERMINISM["before"] fused steps, one densification and
    DETERMINISM["after"] steps from ``state`` and a generator seeded 0,
    launch counts zeroed before and read after; with ``scatter`` (a list)
    the first step's scatter-add reduction inputs are recorded into it.
    Returns (leaves, draws, launches, (state, adam, generator state)
    before the densification)."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.utils.checkpoint import flatten_with_keys

    step, dens = _det_fns(name, st)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    s, a = state, optim.init(state.params())
    draws = []
    for w in wrappers.values():
        w.launches = 0
    for i in range(DETERMINISM["before"] + DETERMINISM["after"]):
        if i == DETERMINISM["before"]:
            before = (s, a, gen.get_state())
            with record_draws(draws):
                s, a = dens(s, a, gen)
        with (capture(rast, "_scatter_reduce", scatter)
              if i == 0 and scatter is not None
              else contextlib.nullcontext()):
            s, a, _ = step(s, a, gen, i)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    leaves = [(f"state{k}", v) for k, v in flatten_with_keys(s)] + [
        (f"adam{k}", v) for k, v in flatten_with_keys(a)]
    return leaves, draws, launches, before


def scatter_index_add(dfeat, gid, p1):
    """``rasterize._scatter_reduce`` with ``index_add_`` in place of
    ``index_put_(accumulate=True)`` (atomic adds on the card): the
    yardstick of the determinism phase."""
    import torch

    k = gid.shape[0]
    idx = torch.where(gid == p1 - 1, p1 + torch.arange(k, device=gid.device),
                      gid.long())
    out = torch.zeros(p1 + k, dfeat.shape[0], device=dfeat.device)
    return out.index_add_(0, idx, dfeat.t())[:p1]


def bit_patterns(fn, n=4) -> int:
    """Distinct bit patterns among n calls of fn()."""
    return len({_digest([fn()]) for _ in range(n)})


def cdf_steps(cdf, probs) -> dict:
    """A raw CDF's down-steps and its up-steps at zero-probability rows,
    everywhere and at multi_cumsum's 16384-element tile joins."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    prev, cur = cdf[:-1], cdf[1:]
    join = torch.arange(1, cdf.shape[0], device=cdf.device) \
        % scan_kernel.CUMSUM_BLOCK == 0
    down, up = cur < prev, (probs[1:] == 0) & (cur > prev)
    return dict(down_steps=int(down.sum()),
                down_steps_at_joins=int((down & join).sum()),
                zero_rows=int((probs == 0).sum()),
                zero_row_up_steps=int(up.sum()),
                zero_row_up_steps_at_joins=int((up & join).sum()))


def determinism_phase(setups, swin_st, wrappers, card_name):
    """Per training setting (train-100k, train-1m, swin-200k) at full
    width, from ``determinism_state``: ``determinism_run`` twice; every
    state and Adam leaf (n_alive too) and every draw's templates
    bit-equal between the runs, no zero-probability template drawn, the
    launches those of the steps plus one multi_cumsum and one
    multi_cummax a draw (relocation and growth; SwinGS one a window
    frame, then growth). On the relocation's own probabilities: the
    distinct bit patterns of 4 torch.cumsum and of 4 multi_cumsum calls
    (1), multi_cummax on the CDF's bits against plain and twice bit-equal
    (at 1M also timed: the kernels line's entry), the raw CDFs' steps at
    zero rows and tile joins (``cdf_steps``), and the densification's wall
    ms (median of 3) beside the same densification with a torch.cumsum
    CDF. On train-100k, the scatter-add reduction's inputs of the first
    step: two ``_scatter_reduce`` calls bit-equal, the bit patterns of 4
    of them and of 4 ``scatter_index_add`` calls. Returns ({setting:
    launches}, inputs for ``determinism_profile``)."""
    import torch

    from gsplat_tpu_torch.model import mcmc
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.raster import scan_kernel

    launches_by, keep = {}, {"probs": {}, "bits": {}}
    for name, st in [*setups.items(), (SWIN_NAME, swin_st)]:
        t0 = time.time()
        state = determinism_state(name, st)
        scatter = [] if name == "100k-800x800" else None
        (la, da, na, before), (lb, db, nb, _) = [
            determinism_run(name, st, state, wrappers,
                            scatter if r == 0 else None) for r in range(2)]
        diff = [k for (k, x), (_, y) in zip(la, lb, strict=True)
                if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                        else x == y)]
        diff += [f"draw {i}" for i, ((_, x), (_, y)) in
                 enumerate(zip(da, db, strict=True)) if not torch.equal(x, y)]
        if diff:
            raise AssertionError(f"determinism {name}: the runs differ at "
                                 f"{diff[:8]}")
        steps = DETERMINISM["before"] + DETERMINISM["after"]
        draws = SWIN["lifespan"] + 1 if name == SWIN_NAME else 2
        want = {k: 0 for k in wrappers}
        want.update(tile_blend_forward=steps, tile_blend_backward=steps,
                    merge_expand=steps, multi_cummax=draws,
                    multi_cumsum=draws + (steps if name in DET_SEGSUM
                                          else 0))
        if len(da) != draws or na != want or nb != want:
            raise AssertionError(f"determinism {name}: {len(da)} draws, "
                                 f"launches {na} / {nb}, expected {want}")
        zero_drawn = sum(int((p[t] == 0).sum()) for p, t in da)
        if zero_drawn:
            raise AssertionError(f"determinism {name}: {zero_drawn} "
                                 f"zero-probability templates drawn")
        probs = da[0][0].contiguous()
        mc_patterns = bit_patterns(lambda: scan_kernel.multi_cumsum(
            probs[None]))
        if mc_patterns != 1:
            raise AssertionError(f"determinism {name}: multi_cumsum gave "
                                 f"{mc_patterns} bit patterns")
        raw = scan_kernel.multi_cumsum(probs[None])
        # multi_cummax on the sampler's input: the positive rows' CDF bits
        bits = torch.where(probs[None] > 0, raw,
                           torch.zeros_like(raw)).view(torch.int32)
        got = scan_kernel.multi_cummax(bits)
        if not (torch.equal(got, scan_kernel.multi_cummax_plain(bits))
                and torch.equal(got, scan_kernel.multi_cummax(bits))):
            raise AssertionError(f"determinism {name}: multi_cummax differs "
                                 f"from plain or from itself")
        keep["bits"][name] = bits
        if name == "1m-1296x840":
            keep["cummax_entry"] = entry = dict(
                name="multi_cummax", route="cuda",
                source="gsplat_tpu_torch/csrc/scan_kernels.cu",
                replaces="gsplat_tpu/raster/scan_kernel.py:66",
                max_abs_err=0.0,
                ms=cuda_ms(lambda: scan_kernel.multi_cummax(bits), 20),
                plain_ms=cuda_ms(
                    lambda: scan_kernel.multi_cummax_plain(bits), 20),
                bound_ms=2 * bits.numel() * 4 / MEM_BPS * 1e3,
                bound_by="bytes",
                library_ms=cuda_ms(lambda: torch.cummax(bits, dim=1), 20),
                shape=f"n=1 K={bits.shape[1]} (the relocation CDF's bits)")
            log("kernel", card=card_name, setting=name, **entry)
        s0, a0, g0 = before
        im0 = s0.im if name == SWIN_NAME else s0
        _, dens = _det_fns(name, st)

        def densify_ms():
            out = []
            for _ in range(3):
                g = torch.Generator(device=DEVICE)
                g.set_state(g0)
                torch.cuda.synchronize()
                t = time.perf_counter()
                s1, _ = dens(s0, a0, g)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t) * 1e3)
            return out, (s1.im if name == SWIN_NAME else s1).n_alive

        ms, n_after = densify_ms()
        orig = mcmc._template_cdf
        mcmc._template_cdf = lambda p: torch.cumsum(p, 0)
        try:
            ms_cumsum, _ = densify_ms()
        finally:
            mcmc._template_cdf = orig
        extra = {}
        if scatter:
            dfeat, gid, p1 = scatter[0][0]
            dfeat = dfeat.detach()
            outs = [rast._scatter_reduce(dfeat, gid, p1) for _ in range(2)]
            if not torch.equal(*outs):
                raise AssertionError("determinism: two scatter-add "
                                     "reductions of the 100k step differ")
            keep["scatter"] = (dfeat, gid, p1)
            old = scatter_index_add(dfeat, gid, p1)
            extra = dict(
                reduction_slots=int(gid.shape[0]), reduction_rows=p1,
                scatter_reduce_patterns=bit_patterns(
                    lambda: rast._scatter_reduce(dfeat, gid, p1)),
                index_add_patterns=bit_patterns(
                    lambda: scatter_index_add(dfeat, gid, p1)),
                scatter_vs_index_add_rel=float((outs[0] - old).abs().max())
                / float(old.abs().max()))
        keep["probs"][name] = probs
        launches_by[name] = na
        log("determinism", card=card_name, setting=name,
            rows=int(probs.shape[0]), steps=steps, draws=len(da),
            leaves_bit_equal=len(la), templates_bit_equal=True,
            relocated=int((im0.alive_mask & (im0.get_opacity()[:, 0]
                                             <= 0.005)).sum()),
            n_alive_before=im0.n_alive, n_alive_after=n_after,
            zero_prob_templates=zero_drawn,
            multi_cumsum_patterns=mc_patterns,
            torch_cumsum_patterns=bit_patterns(
                lambda: torch.cumsum(probs, 0)),
            multi_cumsum_cdf=cdf_steps(raw[0], probs),
            torch_cumsum_cdf=cdf_steps(torch.cumsum(probs, 0), probs),
            densify_wall_ms=ms, densify_wall_ms_median=statistics.median(ms),
            densify_torch_cumsum_wall_ms=ms_cumsum,
            densify_torch_cumsum_wall_ms_median=statistics.median(
                ms_cumsum),
            launches=na, seconds=time.time() - t0, **extra)
    return launches_by, keep


def determinism_profile(keep, card_name):
    """Device ms (torch.profiler, after every wall-clock timing) of
    multi_cumsum and of torch.cumsum on each setting's [1, C] relocation
    probabilities, of multi_cummax on their CDF's bits and of
    torch.cummax on the probabilities, beside the bytes bound (C read, C
    written, either kernel); and of the
    100k step's scatter-add reduction: ``_scatter_reduce``
    (index_put_), ``scatter_index_add`` and ``_segsum_reduce`` (sort +
    multi_cumsum) on the same inputs, every kernel of each call."""
    import torch

    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.raster import scan_kernel

    for name, probs in keep["probs"].items():
        x, bits = probs[None], keep["bits"][name]
        cummax_ms = device_ms(lambda: scan_kernel.multi_cummax(bits), 20,
                              ("multi_cummax_kernel",))
        if name == "1m-1296x840":
            keep["cummax_entry"]["device_ms"] = cummax_ms
        log("determinism_profile", card=card_name, setting=name,
            shape=f"[1, {x.shape[1]}]",
            multi_cumsum_device_ms=device_ms(
                lambda: scan_kernel.multi_cumsum(x), 20,
                ("multi_cumsum_kernel",)),
            torch_cumsum_device_ms=device_ms(
                lambda: torch.cumsum(probs, 0), 20, ("",)),
            multi_cummax_device_ms=cummax_ms,
            torch_cummax_device_ms=device_ms(
                lambda: torch.cummax(x, dim=1), 20, ("",)),
            bound_ms=8 * x.shape[1] / MEM_BPS * 1e3, bound_by="bytes")
    dfeat, gid, p1 = keep["scatter"]
    seg_bounds = torch.searchsorted(
        torch.sort(gid).values,
        torch.arange(p1, dtype=gid.dtype, device=gid.device)).to(
            torch.int32)
    seg = rast._segsum_reduce(dfeat, gid, seg_bounds, p1)
    put = rast._scatter_reduce(dfeat, gid, p1)
    log("determinism_profile", card=card_name, setting="100k-800x800",
        reduction=f"dfeat [9, {gid.shape[0]}] -> [{p1}, 9]",
        index_put_device_ms=device_ms(
            lambda: rast._scatter_reduce(dfeat, gid, p1), 20, ("",)),
        index_add_device_ms=device_ms(
            lambda: scatter_index_add(dfeat, gid, p1), 20, ("",)),
        segsum_device_ms=device_ms(
            lambda: rast._segsum_reduce(dfeat, gid, seg_bounds, p1), 20,
            ("",)),
        segsum_vs_index_put_rel=float((seg - put).abs().max())
        / float(put.abs().max()))


# ------------------------------------- checkpoint, replay, profile, ARAP ----

def write_replay_schedule(path, names, n_init, cap, iters, densify_at, seed,
                          dead=4):
    """A schedule in train/replay.py's format: a random camera name per
    iteration, standard normal noise ([cap, 3] each), and at each
    densification ``dead`` rows relocated onto live ones and growth to
    1.05 x the alive count (capped). Returns the final alive count."""
    rng = np.random.default_rng(seed)
    z = {"camera_names": np.array([names[i] for i in
                                   rng.integers(0, len(names), iters)])}
    n = n_init
    for j, it in enumerate(densify_at):
        mask = np.zeros(n, bool)
        mask[rng.choice(n, dead, replace=False)] = True
        z[f"densify_iter_{j}"] = np.asarray(it)
        z[f"dead_{j}"] = mask
        z[f"reloc_t_{j}"] = rng.choice(np.nonzero(~mask)[0], dead).astype(
            np.int32)
        z[f"add_p_{j}"] = np.asarray(n)
        grow = min(cap, int(1.05 * n)) - n
        z[f"add_t_{j}"] = rng.integers(0, n, grow).astype(np.int32)
        n += grow
    for it in range(1, iters):
        z[f"noise_{it:05d}"] = rng.normal(size=(cap, 3)).astype(np.float32)
    np.savez(path, **z)
    return n


RESUME = dict(iters=20, ckpt=10, densify_at=(4, 8, 14), dead=64)


def resume_phase(st, wrappers, card_name):
    """bench.py's 100k setting driven the way --replay_rng drives the
    trainer (the split grad -> densify -> Adam + noise step every
    iteration, cameras, noise and relocations from a schedule written
    here): RESUME["iters"] steps with a checkpoint (utils/checkpoint.py)
    at RESUME["ckpt"], then the checkpoint loaded and the run resumed from
    it. Gates: the checkpoint round-trips bit-equal, and every resumed
    loss, the final state and its Adam moments are bit-equal to the
    uninterrupted run's (the scatter-add reduction sorts, no atomics)."""
    import torch

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig
    from gsplat_tpu_torch.train.replay import ReplaySchedule
    from gsplat_tpu_torch.utils import checkpoint as ckpt_lib

    cams, gts, settings = st["cams"], st["gts"], st["settings"]
    names = [f"cam{i}" for i in range(len(cams))]
    state = st["state"]
    path = os.path.join(WORK, "resume_schedule.npz")
    write_replay_schedule(path, names, state.n_alive, state.capacity,
                          RESUME["iters"], RESUME["densify_at"], seed=3,
                          dead=RESUME["dead"])
    sched = ReplaySchedule(path, state.capacity)
    opt = OptimizationConfig()
    grad_step = step_lib.make_grad_step(opt, settings, 4.0)
    apply_step = step_lib.make_apply_step(opt, 4.0, external_noise=True)
    densify = step_lib.make_densify_replay_step()
    bg = torch.zeros(3, device=DEVICE)

    def run(state, adam, first, last):
        losses = {}
        for it in range(first, last + 1):
            i = names.index(sched.camera_name(it))
            grads, m = grad_step(state, cams[i], gts[i], bg, SH_DEGREE)
            surgery = False
            if sched.has_densify(it):
                dm, rt, at, target = sched.densify_arrays(it)
                surgery = bool(dm.any()) or target > state.n_alive
                state, adam = densify(
                    state, adam, *(torch.as_tensor(a, device=DEVICE)
                                   for a in (dm, rt, at)), target)
            state, adam = apply_step(
                state, adam, grads, None, float(it), not surgery,
                torch.as_tensor(sched.noise(it), device=DEVICE))
            losses[it] = float(m.loss)
        return state, adam, losses

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    n_ckpt, n_all = RESUME["ckpt"], RESUME["iters"]
    s_half, a_half, first = run(state, optim.init(state.params()), 1, n_ckpt)
    ckpt = os.path.join(WORK, f"chkpnt{n_ckpt}.npz")
    ckpt_lib.save(ckpt, s_half, a_half, n_ckpt)
    s_full, a_full, rest = run(s_half, a_half, n_ckpt + 1, n_all)
    uninterrupted_s = time.perf_counter() - t0
    s_load, a_load, it_load, _ = ckpt_lib.load(ckpt, DEVICE)
    same = (it_load == n_ckpt and s_load.n_alive == s_half.n_alive
            and a_load.count == a_half.count
            and all(torch.equal(v, s_half.params()[k])
                    for k, v in s_load.params().items())
            and all(torch.equal(a_load.mu[k], a_half.mu[k])
                    and torch.equal(a_load.nu[k], a_half.nu[k])
                    for k in a_half.mu))
    if not same:
        raise AssertionError("resume: the checkpoint does not round-trip")
    s_res, a_res, resumed = run(s_load, a_load, n_ckpt + 1, n_all)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = n_all + (n_all - n_ckpt)
    owner = launches["expand_scan"] + launches["merge_expand"]
    if (launches["tile_blend_forward"] != steps or owner != steps
            or launches["tile_blend_backward"] != steps
            or sum(launches.values()) != 3 * steps
            + launches["multi_cumsum"] or (launches["multi_cumsum"]
                                           not in (0, steps))):
        raise AssertionError(f"resume: launches {launches} over {steps} "
                             f"steps")
    rel = {it: abs(resumed[it] - rest[it]) / abs(rest[it]) for it in rest}
    if resumed != rest or not all(map(math.isfinite, rest.values())):
        raise AssertionError(f"resume: losses {resumed} vs {rest}")
    differ = [k for k, v in s_full.params().items()
              if not torch.equal(v, s_res.params()[k])]
    differ += [f"{m}[{k}]" for m in ("mu", "nu") for k in a_full.mu
               if not torch.equal(getattr(a_full, m)[k],
                                  getattr(a_res, m)[k])]
    if differ or s_res.n_alive != s_full.n_alive:
        raise AssertionError(f"resume: the final state differs at {differ}")
    log("resume", card=card_name, setting="100k-800x800", iterations=n_all,
        checkpoint_at=n_ckpt, densify_at=list(RESUME["densify_at"]),
        relocated_per_event=RESUME["dead"], checkpoint_round_trip=True,
        losses_uninterrupted={**first, **rest}, losses_resumed=resumed,
        max_loss_rel=max(rel.values()), losses_bit_equal=True,
        state_and_moments_bit_equal=True,
        uninterrupted_s=uninterrupted_s,
        launches_per_step={k: v / steps for k, v in launches.items()})
    return launches


# the trainer CLI on the committed Blender fixture, replaying a schedule
# written here: 12 iterations, densifications at 3, 6 and 9, cap 320
REPLAY_FLAGS = ["-s", CLI_FIXTURE, "-w", "--cap_max", "320",
                "--iterations", "12", "--densify_from_iter", "2",
                "--densify_until_iter", "10", "--densification_interval",
                "3", "--test_iterations", "-1", "--save_iterations", "-1",
                "--dup_budget", "16384", "--tile_x", "16", "--tile_y", "16"]
PROFILE_RANGE = (3, 8)


def replay_phase(card_name):
    """``python -m gsplat_tpu_torch.train.train_static --replay_rng`` on
    the card (in RUN_COUNTED, with --profile_iterations) and on the port's
    CPU path, one schedule; per-iteration loss rel <= 4.1e-4 (the
    JAX-vs-reference bound). The card run's launch counts: one blend
    forward, one blend backward and one owner expansion an iteration.
    Returns (launches, the card run's model directory)."""
    sched = os.path.join(WORK, "replay_schedule.npz")
    write_replay_schedule(sched, [f"r_{i}" for i in range(8)], 256, 320,
                          12, (3, 6, 9), seed=0)
    outs = {d: os.path.join(WORK, f"replay_{d}") for d in ("card", "cpu")}
    t0 = time.time()
    _, launches = run_counted(
        ["gsplat_tpu_torch.train.train_static", "-m", outs["card"],
         "--replay_rng", sched, "--profile_iterations",
         *map(str, PROFILE_RANGE)] + REPLAY_FLAGS
        + ([] if DEVICE == "cuda" else ["--data_device", DEVICE]),
        os.path.join(WORK, "replay_card.log"))
    card_s = time.time() - t0
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.train.train_static", "-m",
         outs["cpu"], "--replay_rng", sched, "--data_device", "cpu"]
        + REPLAY_FLAGS, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    if res.returncode:
        raise RuntimeError("replay (CPU) rc={}: {}".format(
            res.returncode, (res.stdout + res.stderr)[-3000:]))
    cpu_s = time.time() - t0
    losses = {}
    for d, out in outs.items():
        with open(os.path.join(out, "parity_ours.json")) as f:
            losses[d] = {it: loss for it, _, loss in json.load(f)["losses"]}
    rel = [abs(losses["card"][it] - losses["cpu"][it]) / abs(losses["cpu"][it])
           for it in losses["cpu"]]
    if sorted(losses["card"]) != list(range(1, 13)) or max(rel) > 4.1e-4:
        raise AssertionError(f"replay: card {losses['card']} vs CPU "
                             f"{losses['cpu']}")
    owner = launches["expand_scan"] + launches["merge_expand"]
    want = dict(tile_blend_forward=12, tile_blend_backward=12)
    if (any(launches[k] != v for k, v in want.items()) or owner != 12
            or launches["multi_cumsum"] or launches["render_forward"]
            or launches["multi_cummax"]):
        raise AssertionError(f"replay: launches {launches}")
    log("replay", card=card_name, iterations=12, densify_at=[3, 6, 9],
        losses_card=losses["card"], losses_cpu=losses["cpu"],
        max_loss_rel=max(rel), card_cli_s=card_s, cpu_cli_s=cpu_s,
        launches_per_iteration={k: v / 12 for k, v in launches.items()})
    return launches, outs["card"]


def profile_phase(model_dir, card_name):
    """The card replay run's --profile_iterations trace
    (<model>/profile/trace.json): it must name the port's blend forward,
    blend backward and owner-expansion kernels."""
    with open(os.path.join(model_dir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            for name in PORT_KERNELS:
                if name in e.get("name", ""):
                    kernels[name] = kernels.get(name, 0) + 1
    steps = PROFILE_RANGE[1] - PROFILE_RANGE[0]
    owner = kernels.get("expand_scan_kernel", 0) + kernels.get(
        "merge_expand_kernel", 0)
    if (kernels.get("blend_forward_kernel") != steps
            or kernels.get("blend_backward_kernel") != steps
            or owner != steps):
        raise AssertionError(f"profile: kernels in the trace {kernels}, "
                             f"{steps} iterations")
    log("profile_cli", card=card_name, iterations=list(PROFILE_RANGE),
        trace_events=len(events), port_kernel_events=kernels)


ARAP_KNN_ROWS = 400_000


def arap_phase(st, state, wrappers, card_name):
    """One fused swin step with ARAP (the trainer's --enable_arap weights
    0.1, the k = 20 graph of the immature rows) at the SwinGS setting,
    counts zeroed before it; ``arap_loss`` and its gradient on the card
    against the same call on the CPU (1e-5 / 1e-4 of each leaf's max);
    knn_indices' time over the immature rows and over ARAP_KNN_ROWS
    rows (the union's)."""
    import torch

    from gsplat_tpu_torch.model import knn, optim
    from gsplat_tpu_torch.train import losses, swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig

    t0 = time.perf_counter()
    nbr = knn.knn_indices(state.im.xyz, k=20)[1]
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    union = torch.cat([state.im.xyz, state.m_xyz])[:ARAP_KNN_ROWS]
    t0 = time.perf_counter()
    knn.knn_indices(union, k=20)
    torch.cuda.synchronize()
    knn_union_s = time.perf_counter() - t0
    step = swin_step.make_swin_train_step(OptimizationConfig(),
                                          st["settings"], 4.0,
                                          arap_weights=(0.1, 0.1, 0.1))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    _, _, m = step(state, optim.init(state.params()), gen, st["cams"][1],
                   st["gts"][1], torch.zeros(3, device=DEVICE), 3.0, 1.0,
                   SWIN["sh"], nbr_indices=nbr)
    loss = float(m.loss)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: w.launches for k, w in wrappers.items()}
    swin_launches_ok(launches, 1, "arap")
    xyz = state.im.xyz.detach()
    pens, grads = {}, {}
    for dev in (DEVICE, "cpu"):
        paras = [getattr(state, k).detach().to(dev).requires_grad_(True)
                 for k in ("rigid_v", "rigid_rotvec", "rigid_rotcen")]
        p = losses.arap_loss(xyz.to(dev), paras, nbr.to(dev))
        p.sum().backward()
        pens[dev] = p.detach().cpu()
        grads[dev] = [q.grad.cpu() for q in paras]
    rel = ((pens[DEVICE] - pens["cpu"]).abs()
           / pens["cpu"].abs().clamp(min=1e-30))
    grad_rel = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(grads[DEVICE], grads["cpu"])]
    if not math.isfinite(loss) or float(rel.max()) > 1e-5 or \
            max(grad_rel) > 1e-4:
        raise AssertionError(f"arap: loss {loss}, penalties {pens}, "
                             f"gradient rel {grad_rel}")
    log("arap", card=card_name, setting=SWIN_NAME,
        immature_rows=state.capacity, k=20, loss=loss,
        penalties=pens[DEVICE].tolist(), penalty_rel_card_cpu=float(rel.max()),
        grad_rel_card_cpu=grad_rel, step_ms=step_ms,
        knn_s_immature=knn_s, knn_rows_union=union.shape[0],
        knn_s_union=knn_union_s, launches=launches)
    return launches


# ------------------------------------------------------------- parallel ----

# The long-run soaks (scripts/torch_soak_30k.py, scripts/torch_soak_swin.py)
# at full width, cut in length: the 30k soak's first 1,200 iterations
# (across densify_from_iter: 7 densifications, SH degree 1 at 1,000, two
# held-out evals) and the swin soak on soak_swin.py's CPU schedule (12
# frames, genesis 60, windows 30)
SOAK = dict(iterations=1200, report_every=600)
SOAK_SWIN = dict(cap=200_000, frames=12, swin_size=8, genesis_iters=60,
                 window_iters=30)


def load_script(name):
    """scripts/<name>.py as a module (scripts/ is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def expected_n_alive(n0, cap, densifications):
    """n_alive after ``densifications`` of add_new_gs's +5% to the cap
    (relocation keeps the count)."""
    n = n0
    for _ in range(densifications):
        n = max(min(cap, int(np.float32(1.05) * np.float32(n))), n)
    return n


def check_owner_expansion(name, store, card_name):
    """The recorded owner expansion (merge_expand or expand_scan, whichever
    binning took) bit-equal to its plain version; its log fields."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    with torch.no_grad():
        if store["merge_expand"]:
            entry = check_merge_expand(*store["merge_expand"][0][0],
                                       card_name, setting=name)
            return {"merge_expand": entry["max_abs_err"]}
        marks, base_in = store["expand_scan"][0][0]
        err = check_expand(scan_kernel.expand_scan, marks, base_in,
                           scan_kernel.expand_scan_plain(marks, base_in))
        log("kernel", card=card_name, setting=name, name="expand_scan",
            max_abs_err=err, shape=f"K={marks.shape[0]}",
            repeat_bit_equal=True)
        return {"expand_scan": err}


@contextlib.contextmanager
def capture_step(store):
    """Record the kernel inputs of the renders and steps inside: the
    blends' (and multi_cumsum's) launches under store["ext"], binning's
    owner expansion under store["merge_expand"] / store["expand_scan"]."""
    from gsplat_tpu_torch.raster import binning

    ext = {"blend_forward": [], "blend_backward": [], "multi_cumsum": []}
    store.update(ext=ext, merge_expand=[], expand_scan=[])
    with capture_ext(ext), \
            capture(binning, "merge_expand", store["merge_expand"]), \
            capture(binning, "expand_scan", store["expand_scan"]):
        yield


def check_template_scans(name, probs, card_name):
    """A template draw's two scans on its own probabilities: multi_cumsum
    within 2e-3 + 1e-5 |x| of a float64 cumsum, multi_cummax on the CDF's
    bits equal to plain; each twice bit-equal."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    x = probs.detach().contiguous()[None]
    raw = scan_kernel.multi_cumsum(x)
    ref = torch.cumsum(x.double(), dim=1)
    err = (raw.double() - ref).abs()
    bits = torch.where(x > 0, raw, torch.zeros_like(raw)).view(torch.int32)
    got = scan_kernel.multi_cummax(bits)
    ok = (bool((err <= 2e-3 + 1e-5 * ref.abs()).all())
          and torch.equal(raw, scan_kernel.multi_cumsum(x))
          and torch.equal(got, scan_kernel.multi_cummax_plain(bits))
          and torch.equal(got, scan_kernel.multi_cummax(bits)))
    if not ok:
        raise AssertionError(f"{name}: a template draw's scans differ from "
                             f"plain or from themselves (cumsum max abs "
                             f"{float(err.max())})")
    log("kernel", card=card_name, setting=name, name="multi_cumsum+"
        "multi_cummax", shape=f"n=1 K={x.shape[1]} (a template draw)",
        cumsum_max_abs_err=float(err.max()), cummax_max_abs_err=0.0,
        repeat_bit_equal=True)
    return float(err.max())


def soak_phase(wrappers, card_name):
    """scripts/torch_soak_30k.py's set-up at full size (cap 100k, 800x800,
    p_gt 20k, 24 cameras) and its run for SOAK["iterations"], counts
    zeroed before the run and read after it. Gates: every checked loss
    finite (the run raises), n_alive at each report as densify's +5% rule
    says, the later held-out PSNR above the earlier, no overflow after a
    budget change, launches (one blend forward and one owner expansion a
    render, one blend backward a step, one multi_cummax a template draw).
    Then one step and one densification from the final state (just
    densified), their kernel inputs held against the plain versions."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train.config import OptimizationConfig

    soak = load_script("torch_soak_30k")
    t0 = time.time()
    rng = np.random.default_rng(0)
    su = soak.setup(DEVICE, rng)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    lines = []
    for w in wrappers.values():
        w.launches = 0
    t1 = time.time()
    res, state, adam = soak.run(
        su, rng, SOAK["iterations"], SOAK["report_every"],
        os.path.join(WORK, "soak_trained_stats.npz"), say=lines.append)
    torch.cuda.synchronize()
    run_s = time.time() - t1
    launches = {k: w.launches for k, w in wrappers.items()}
    opt = OptimizationConfig()
    sched = soak.Schedule(opt, su["train_ids"], SOAK["iterations"],
                          SOAK["report_every"], su["settings"].chunk)
    steps, reports = SOAK["iterations"], len(res["eval_log"])
    dens = [it for it in range(1, steps + 1) if sched.densify_due(it)]
    cap, n0 = su["cfg"]["cap"], su["state"].n_alive
    want_n = [expected_n_alive(n0, cap, sum(d <= e["it"] for d in dens))
              for e in res["eval_log"]]
    got_n = [e["n_alive"] for e in res["eval_log"]]
    psnrs = [e["psnr"] for e in res["eval_log"]]
    late = [o for o in res["overflows"]
            if any(c["it"] < o["it"] for c in res["budget_changes"])]
    renders = steps + reports * len(soak.TEST_IDX)
    if (got_n != want_n or not psnrs[-1] > psnrs[0] or late
            or res["densify_ms"]["count"] != len(dens) or len(dens) != 7):
        raise AssertionError(f"soak: n_alive {got_n} (want {want_n}), "
                             f"psnr {psnrs}, overflows after a budget "
                             f"change {late}, densifications "
                             f"{res['densify_ms']['count']}")
    want = dict(tile_blend_forward=renders, tile_blend_backward=steps,
                multi_cummax=2 * len(dens), render_forward=0)
    got = {k: launches[k] for k in want}
    segsum_steps = launches["multi_cumsum"] - 2 * len(dens)
    if (got != want or launches["merge_expand"] + launches["expand_scan"]
            != renders or segsum_steps < 0
            or (not res["budget_changes"] and segsum_steps)):
        raise AssertionError(f"soak: launches {launches}, expected {want}, "
                             f"an owner expansion a render ({renders}) and "
                             f"multi_cumsum 2 a densification")

    # one step and one densification from the final (just densified) state
    final_settings = dc.replace(su["settings"], k_dup=res["final_k_dup"])
    gen = bench.generator(DEVICE, 1)
    ci = su["train_ids"][0]
    store, draws = {}, []
    with capture_step(store):
        step_lib.make_train_step(opt, final_settings, 4.0)(
            state, adam, gen, su["cams"][ci], su["gts"][ci], su["bg"],
            float(steps + 1), sched.sh_degree(steps + 1))
    with record_draws(draws):
        step_lib.make_densify_step(cap)(state, adam, gen)
    torch.cuda.synchronize()
    cap_in = {k: v[0] for k, v in store["ext"].items() if v}
    name = "soak-100k-800x800"
    errs = check_owner_expansion(name, store, card_name)
    kern = check_training_kernels({name: cap_in}, card_name)
    errs.update({k: v[name]["max_abs_err"] for k, v in kern.items()})
    errs["template_scans"] = [check_template_scans(name, p, card_name)
                              for p, _ in draws]
    ms = [e["ms_it"] for e in res["eval_log"]]
    log("soak", card=card_name, setting=name, iterations=steps,
        report_every=SOAK["report_every"], seconds=time.time() - t0,
        setup_seconds=setup_s, run_seconds=run_s, ms_per_step_by_report=ms,
        eval_log=res["eval_log"], psnr=psnrs, n_alive=got_n,
        densifications=len(dens),
        densify_ms=res["densify_ms"], k_dup_start=su["settings"].k_dup,
        budget_changes=res["budget_changes"], overflows=res["overflows"],
        dup_peak=res["dup_peak"], launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        peak_mem_gb=res["peak_mem_gb"], kernel_max_abs_err=errs,
        report_lines=lines)
    return launches


def soak_swin_phase(wrappers, card_name):
    """scripts/torch_soak_swin.py at full width (cap 200k, 1280x720, p_gt
    100k, 4 cameras) on SOAK_SWIN's schedule: genesis, decay_genesis,
    every evolve up to the last frame and mature_rest, counts zeroed
    before; then the playback, counts zeroed before it, its first frame's
    kernel inputs held against the plain versions. Gates: window losses
    finite; the first evolve streams every genesis row, each later tick
    cap / swin rows, the stream's records their sum with mature_rest's;
    playback finite (its PSNR against the GT logged, not gated: windows of
    60 and 30 iterations are too short for a quality floor); launches (one
    blend backward and one multi_cumsum a training step: the 400k-row
    union reduces by segment sums; one blend forward and one owner
    expansion a training render; one render, one encode and one owner
    expansion a played frame)."""
    import argparse

    import torch

    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.raster import tile_kernel

    sw = load_script("torch_soak_swin")
    t0 = time.time()
    args = argparse.Namespace(**SOAK_SWIN, device=DEVICE,
                              out=os.path.join(WORK, "soak_swin"))
    rng = np.random.default_rng(0)
    su = sw.setup(DEVICE, rng, args)
    soak = sw.Soak(su, rng, args, say=lambda s: None)
    for w in wrappers.values():
        w.launches = 0
    tr = sw.train(soak, args.out)
    torch.cuda.synchronize()
    train_launches = {k: w.launches for k, w in wrappers.items()}
    steps = args.genesis_iters + args.window_iters * (len(tr["matured"]) - 1)
    cap, per_tick = args.cap, args.cap // args.swin_size
    ticks = args.frames - args.swin_size
    losses = [w["loss"] for w in soak.window_stats]
    if (not all(math.isfinite(x) for x in losses)
            or tr["matured"][:-1] != [cap] + [per_tick] * (ticks - 1)):
        raise AssertionError(f"soak_swin: window losses {losses}, matured "
                             f"{tr['matured']}")
    fwd = train_launches["tile_blend_forward"]
    # the union's 2 x cap rows take the segment-sum reduction at full size
    # (one multi_cumsum a step); K stays below its slot threshold
    segsum = 2 * cap + 1 > rast._SCATTER_MAX_ROWS
    if soak.box.settings.k_dup >= rast._SEGSUM_MIN_SLOTS:
        raise AssertionError(f"soak_swin: k_dup {soak.box.settings.k_dup}")
    want = dict(tile_blend_backward=steps,
                multi_cumsum=steps if segsum else 0, multi_cummax=0,
                render_forward=0)
    if ({k: train_launches[k] for k in want} != want or fwd < steps
            or train_launches["merge_expand"]
            + train_launches["expand_scan"] != fwd):
        raise AssertionError(f"soak_swin training: launches {train_launches}"
                             f", expected {want}, one owner expansion a "
                             f"blend forward")
    for w in wrappers.values():
        w.launches = 0
    store, renders = {}, []
    frames = len(range(0, args.frames, max(args.frames // 8, 1)))
    with capture_step(store), capture(rast, "tile_kernel", renders,
                                      attr="render_forward"):
        psnrs, records = sw.playback(soak, args.out)
    torch.cuda.synchronize()
    pb_launches = {k: w.launches for k, w in wrappers.items()}
    if records != sum(tr["matured"]) or not all(
            math.isfinite(p) for _, p in psnrs):
        raise AssertionError(f"soak_swin playback: {records} records, "
                             f"matured {tr['matured']}, psnr {psnrs}")
    gt_renders = pb_launches["tile_blend_forward"]
    want = dict(tile_blend_backward=0, multi_cumsum=0, multi_cummax=0,
                render_forward=frames, encode_rgb8=frames)
    if ({k: pb_launches[k] for k in want} != want
            or pb_launches["merge_expand"] + pb_launches["expand_scan"]
            != frames + gt_renders):
        raise AssertionError(f"soak_swin playback: launches {pb_launches}")
    name = "soak-swin-200k-1280x720"
    errs = check_owner_expansion(name, store, card_name)
    with torch.no_grad():
        feat, meta, bg, rkw = render_kwargs(renders[0])
        errs["render_forward"] = check_render(
            tile_kernel.render_forward, feat, meta, bg, rkw,
            tile_kernel.render_forward_plain(feat, meta, bg, **rkw))
    log("soak_swin", card=card_name, setting=name, **SOAK_SWIN,
        seconds=time.time() - t0, train_seconds=tr["wall"],
        windows=soak.window_stats, matured_per_tick=tr["matured"],
        stream_records=records, stream_bytes=os.path.getsize(
            tr["dump_path"]), budget_regrows=soak.regrows,
        playback_psnr=psnrs, playback_psnr_mean=statistics.mean(
            p for _, p in psnrs), train_launches=train_launches,
        playback_launches=pb_launches, kernel_max_abs_err=errs,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return {k: train_launches[k] + pb_launches[k] for k in train_launches}


# the multi-rank modes, four gloo ranks sharing the one card; "two" modes
# run on ranks 0 and 1 while 2 and 3 wait, dp x ps on all four
PARALLEL_STEPS = 3     # per mode: step A (noise off, compared) + 2 timed
# pshard's and dp x ps's first Adam moment against the gradient of the
# same slab-composited loss taken in one process (_slab_reference_grads),
# as a share of the leaf's largest
PS_MU_REL = 1e-4


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _masked_diff(got, ref, grad):
    """Max |got - ref| over the entries whose gradient is at least 2e-4
    of the leaf's max (Adam's first step is lr * sign(g))."""
    keep = grad.abs() >= 2e-4 * grad.abs().max()
    return float((got - ref).abs()[keep].max()) if bool(keep.any()) else 0.0


def _shard_update_diffs(params, adam, ref, grad, mesh):
    """This rank's ps rows after step A against a reference step's
    (params ``ref`` from gradient ``grad``, whole rows): (the masked
    parameter difference of ``_masked_diff``, the largest
    |mu - (1 - b1) g| over the leaf's largest |(1 - b1) g|). Adam's first
    moment carries the gradient's scale, which the first update (about
    lr * sign(g)) does not."""
    from gsplat_tpu_torch.parallel import mesh as mesh_lib

    p_diff = mu_rel = 0.0
    for k in ref:
        g = mesh_lib.shard_rows(grad[k], mesh, "ps")
        p_diff = max(p_diff, _masked_diff(
            params[k], mesh_lib.shard_rows(ref[k], mesh, "ps"), g))
        want = (1 - 0.9) * g
        top = float(want.abs().max())
        err = float((adam.mu[k] - want).abs().max())
        mu_rel = max(mu_rel, err / top if top > 0 else err)
    return p_diff, mu_rel


def _slab_reference_grads(params, alive, cams, gts, bg, settings, opt,
                          n_alive, mesh):
    """The gradient of pshard's loss for whole rows, taken in this one
    process and averaged over ``cams``: both depth slabs rasterized here
    and folded in depth order, the regularisers summed over all rows, no
    collective in the loss or its backward. The slab bounds (bookkeeping,
    not differentiated) come from ``pshard._slab_bounds`` over ``mesh``'s
    ps axis, as in the step, so the ranks of that axis call this
    together. What it holds the ranks' step to: the all-gather, its
    reduce-scatter backward, the /n loss and the regulariser sums."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.core.quaternion import normalize
    from gsplat_tpu_torch.parallel import pshard as ps
    from gsplat_tpu_torch.raster.rasterize import rasterize
    from gsplat_tpu_torch.train import losses

    settings = dc.replace(settings, layout="chw")
    n = mesh.shape["ps"]
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    for cam, gt in zip(cams, gts):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        opa = torch.sigmoid(p["opacity"])
        depth = ps._view_depth(p["xyz"].detach(), cam)
        bounds, hi = ps._slab_bounds(depth, alive & (depth > ps.ZNEAR_CULL),
                                     n, mesh, "ps")
        logd = ps._log_depth(depth, hi)
        c = t = None
        for d in range(n):
            mine = (logd >= bounds[d]) & (logd < bounds[d + 1])
            out = rasterize(p["xyz"], torch.exp(p["scaling"]),
                            normalize(p["rotation"]), opa[:, 0],
                            torch.cat([p["f_dc"], p["f_rest"]], dim=1), cam,
                            SH_DEGREE, torch.zeros(3, device=bg.device),
                            settings, alive=alive & mine)
            c = out.image if c is None else c + t * out.image
            t = (out.final_t[None] if t is None
                 else t * out.final_t[None])
        img = c + t * bg[:, None, None]
        loss = ((1 - opt.lambda_dssim) * losses.l1_loss(img, gt)
                + opt.lambda_dssim * (1 - losses.ssim(img, gt)))
        af = alive.to(torch.float32)
        denom = float(max(n_alive, 1))
        loss = loss + opt.opacity_reg * torch.sum(opa[:, 0] * af) / denom
        loss = loss + opt.scale_reg * torch.sum(
            torch.mean(torch.exp(p["scaling"]), dim=1) * af) / denom
        for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
            total[k] += g / len(cams)
    return total


def _slab_reference_diffs(state, adam_a, params_a, cams, gts, bg, settings,
                          opt, mesh):
    """(masked param diff, first-moment share) of this rank's step-A rows
    against the step that ``_slab_reference_grads`` gives."""
    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.train import step as step_lib

    grad = _slab_reference_grads(state.params(), state.alive_mask, cams,
                                 gts, bg, settings, opt, state.n_alive, mesh)
    _, lrs = step_lib.learning_rates(opt, 4.0, 1.0)
    ref = optim.step(state.params(), grad, optim.init(state.params()),
                     lrs)[0]
    return _shard_update_diffs(params_a, adam_a, ref, grad, mesh)


def parallel_inputs(setups, swin_st, eval_state, card_name):
    """The inputs of the parallel phase and their single-device references
    on the card: the dp / pshard / dp x ps setting (bench.py's train-1m,
    cameras 0 and 1), the swin setting (cameras 0 and 1 at frames 0 and
    1), the eval phase's 1M-row model at 1237 x 822 for the tileshard
    render. Saved for the ranks; returns the path."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import (OptimizationConfig,
                                               PipelineConfig)
    from gsplat_tpu_torch.train.train_static import make_settings

    opt0 = OptimizationConfig(noise_lr=0.0)
    bg = torch.zeros(3, device=DEVICE)
    st = setups["1m-1296x840"]
    chw = dc.replace(st["settings"], layout="chw")
    grads, losses = [], []
    for i in (0, 1):
        g, m = step_lib._loss_and_grads(opt0, chw, st["state"],
                                        st["cams"][i], st["gts"][i], bg,
                                        SH_DEGREE)
        grads.append(g)
        losses.append(float(m.loss))
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    _, lrs = step_lib.learning_rates(opt0, 4.0, 1.0)
    ref = optim.step(st["state"].params(), mean,
                     optim.init(st["state"].params()), lrs)[0]
    # pshard trains camera 0 alone: its reference is camera 0's step
    ref0 = optim.step(st["state"].params(), grads[0],
                      optim.init(st["state"].params()), lrs)[0]
    train = dict(state=st["state"], cams=st["cams"][:2], gts=st["gts"][:2],
                 settings=st["settings"], loss_cam=losses, ref=ref,
                 mean_grad=mean, ref0=ref0, grad0=grads[0])
    del grads

    schw = dc.replace(swin_st["settings"], layout="chw")
    sgrads, slosses = [], []
    for i in (0, 1):
        g, m = swin_step._loss_and_grads(opt0, schw, swin_st["state"],
                                         swin_st["cams"][i],
                                         swin_st["gts"][i], bg, float(i),
                                         SWIN["sh"])
        sgrads.append(g)
        slosses.append(float(m.loss))
    smean = {k: (sgrads[0][k] + sgrads[1][k]) / 2 for k in sgrads[0]}
    _, slrs = swin_step.swin_learning_rates(opt0, 4.0, 1.0)
    sref = optim.step(swin_st["state"].params(), smean,
                      optim.init(swin_st["state"].params()), slrs)[0]
    swin = dict(state=swin_st["state"], cams=swin_st["cams"][:2],
                gts=swin_st["gts"][:2], settings=swin_st["settings"],
                frames=[0.0, 1.0], loss_cam=slosses, ref=sref,
                mean_grad=smean)
    del sgrads

    rcw, pos = bench.orbit_poses(1, radius=4.0,
                                 center=(0.0, 0.0, 0.0))[0]
    cam = make_camera(rcw, -rcw.T @ pos, 0.9, 0.9, EVAL["width"],
                      EVAL["height"], device=DEVICE)
    ts_settings = make_settings(PipelineConfig(), EVAL["cap"])
    with torch.no_grad():
        ts_ref = rast.rasterize(
            eval_state.xyz, eval_state.get_scaling(),
            eval_state.get_rotation(), eval_state.get_opacity()[:, 0],
            eval_state.get_features(), cam, SH_DEGREE, bg, ts_settings,
            alive=eval_state.alive_mask)
    tile = dict(state=eval_state, camera=cam, settings=ts_settings,
                ref=ts_ref.image, num_dup=int(ts_ref.num_dup))
    path = os.path.join(WORK, "parallel_inputs.pt")
    torch.save(dict(train=train, swin=swin, tile=tile, card=card_name),
               path)
    return path


def _rank_wrappers():
    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel

    return {"expand_scan": scan_kernel.expand_scan,
            "merge_expand": scan_kernel.merge_expand,
            "render_forward": tile_kernel.render_forward,
            "tile_blend_forward": tile_kernel.tile_blend_forward,
            "tile_blend_backward": tile_kernel.tile_blend_backward,
            "multi_cumsum": scan_kernel.multi_cumsum,
            "multi_cummax": scan_kernel.multi_cummax}


def _run_mode(mode, steps, run, capture_on, card_name, out):
    """Run ``run(i)`` for i < steps with the launch counts
    zeroed before and read after (in all), the first step's kernel
    inputs recorded when ``capture_on``; wall ms of the later steps.
    Returns the recorded inputs."""
    import torch
    import torch.distributed as dist

    from gsplat_tpu_torch.raster import binning

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    wrappers = _rank_wrappers()
    for w in wrappers.values():
        w.launches = 0
    store = {"blend_forward": [], "blend_backward": [], "multi_cumsum": []}
    owners = {"merge_expand": [], "expand_scan": []}
    ms = []
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        if i == 0 and capture_on:
            with capture_ext(store), \
                    capture(binning, "merge_expand", owners["merge_expand"]), \
                    capture(binning, "expand_scan", owners["expand_scan"]):
                run(i)
        else:
            run(i)
        sync()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    out.setdefault("launches", {})[mode] = {
        k: w.launches for k, w in wrappers.items()}
    out.setdefault("ms_per_step", {})[mode] = ms
    out.setdefault("rank", dist.get_rank())
    cap = {k: v[0] for k, v in store.items() if v}
    for k, v in owners.items():
        if v:
            cap[k] = v[0][0]
    return cap


def _check_mode_kernels(mode, cap, card_name):
    """Rank 0: each kernel of the mode against its plain version on the
    recorded inputs, by the train and eval phases' gates."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel

    with torch.no_grad():
        if "blend_backward" in cap:
            _check_training_kernels({mode: cap}, card_name)
            if "merge_expand" in cap:
                check_merge_expand(*cap["merge_expand"], card_name,
                                   setting=mode)
            else:
                marks, base_in = cap["expand_scan"]
                check_expand(scan_kernel.expand_scan, marks, base_in,
                             scan_kernel.expand_scan_plain(marks, base_in))
        else:
            log("kernel_eval_path", card=card_name, setting=mode,
                **check_eval_kernels(cap["expand_scan"],
                                     cap["blend_forward"]))


def parallel_rank(inputs_path, card_name):
    """One rank of the parallel phase (gloo, every rank on card 0)."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    from gsplat_tpu_torch.model import optim
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.parallel import pshard as pshard_mod
    from gsplat_tpu_torch.parallel.dp import make_dp_train_step
    from gsplat_tpu_torch.parallel.pshard import make_pshard_train_step
    from gsplat_tpu_torch.parallel.swin_dp import make_dp_swin_train_step
    from gsplat_tpu_torch.parallel.tileshard import make_tileshard_render
    from gsplat_tpu_torch.train import step as step_lib
    from gsplat_tpu_torch.train import swin_step
    from gsplat_tpu_torch.train.config import OptimizationConfig
    from gsplat_tpu_torch.train.train_static import (_gather_adam,
                                                     _shard_adam)

    rank = dist.get_rank()
    # every rank on the card (the CPU in a rehearsal without one)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    check = dev.type == "cuda"
    cap_on = rank == 0 and check      # rank 0 records the kernel inputs
    inp = torch.load(inputs_path, map_location=dev, weights_only=False)
    g01 = dist.new_group([0, 1])
    mesh2d = mesh_lib.make_mesh_2d(2, 2, device=dev)
    out = {}
    opt0, opt = OptimizationConfig(noise_lr=0.0), OptimizationConfig()
    bg = torch.zeros(3, device=dev)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def timed(key, fn, *args):
        """fn(*args), its wall ms (the card synchronised) in out[key]."""
        if check:
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*args)
        if check:
            torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t) * 1e3
        return res

    def state_digest(s, a):
        return _digest(list(s.params().values()) + list(a.mu.values())
                       + list(a.nu.values()))

    def densify_shards(p, a, m, g):
        """The trainer's pshard densification: the gathered state and
        moments densified on every rank from the replicated generator
        ``g``, no broadcast after it; returns this rank's rows, moments,
        alive rows and n_alive, and the densified whole (state, moments)
        for a digest outside the timed step."""
        s = tr["state"].replace_params(mesh_lib.gather_rows(p, m, "ps"))
        s, full = step_lib.make_densify_step(s.capacity)(
            s, _gather_adam(a, m), g)
        return ({k: mesh_lib.shard_rows(v, m, "ps")
                 for k, v in s.params().items()}, _shard_adam(full, m),
                mesh_lib.shard_rows(s.alive_mask, m, "ps"), s.n_alive,
                (s, full))

    tr = inp["train"]
    if rank < 2:
        mesh = mesh_lib.Mesh({a: mesh_lib.Axis(g01, 2, rank)
                              for a in ("dp", "ps", "sp")}, dev)
        # dp: step A without noise, then noisy steps and a relocation
        carry = {}
        step0 = make_dp_train_step(mesh, opt0, tr["settings"], 4.0)
        stepn = make_dp_train_step(mesh, opt, tr["settings"], 4.0)
        densify = step_lib.make_densify_step(tr["state"].capacity)
        g = gen(0)

        def run_dp(i):
            s, a = carry.get("s", tr["state"]), carry.get(
                "a", optim.init(tr["state"].params()))
            fn = step0 if i == 0 else stepn
            s, a, m = timed(f"dp_train_ms_{i}", fn, s, a, g,
                            tr["cams"][rank], tr["gts"][rank], bg,
                            float(i + 1), SH_DEGREE)
            if i == 0:
                out["dp_loss"] = float(m.loss)
                out["dp_param_diff"] = max(
                    _masked_diff(s.params()[k], tr["ref"][k],
                                 tr["mean_grad"][k]) for k in tr["ref"])
                out["dp_param_max_diff_all"] = max(
                    float((s.params()[k] - tr["ref"][k]).abs().max())
                    for k in tr["ref"])
            if i == 1:
                carry["pre"] = (s, a, g.get_state())
                s, a = timed("dp_densify_ms", densify, s, a, g)
                carry["dense"] = (s, a)
            carry.update(s=s, a=a)

        cap = _run_mode("dp", PARALLEL_STEPS, run_dp, cap_on,
                        card_name, out)
        out["dp_digest"] = state_digest(carry["s"], carry["a"])
        out["dp_densified_digest"] = state_digest(*carry["dense"])
        # the same densification again, its kernels loaded by the first
        s0, a0, g_state = carry["pre"]
        g.set_state(g_state)
        timed("dp_densify_again_ms", densify, s0, a0, g)
        if rank == 0 and check:
            _check_mode_kernels("dp-1m-1296x840", cap, card_name)
        carry.clear()

        # pshard train over two shards, camera 0
        state = tr["state"]
        rows = {k: mesh_lib.shard_rows(v, mesh, "ps")
                for k, v in state.params().items()}
        alive = mesh_lib.shard_rows(state.alive_mask, mesh, "ps")
        ps0 = make_pshard_train_step(mesh, opt0, tr["settings"], 4.0,
                                     SH_DEGREE)
        psn = make_pshard_train_step(mesh, opt, tr["settings"], 4.0,
                                     SH_DEGREE)
        ng, dg = gen(1 + rank), gen(0)

        def run_ps(i):
            p, a = carry.get("p", rows), carry.get("a", optim.init(rows))
            al, n = carry.get("alive", alive), carry.get("n", state.n_alive)
            slab = []
            with capture(pshard_mod, "rasterize", slab):
                p, a, m = (ps0 if i == 0 else psn)(
                    p, al, a, ng, tr["cams"][0], tr["gts"][0], bg,
                    float(i + 1), n)
            if i == 0:
                out["ps_loss"] = float(m.loss)
                # the slabs' semantics against the single device (not a
                # gate: the back slab goes on where the front one stopped)
                (out["ps_vs_single_param_diff"],
                 out["ps_vs_single_mu_rel"]) = _shard_update_diffs(
                    p, a, tr["ref0"], tr["grad0"], mesh)
                carry["A"] = (p, a)
                # the rows of this rank's depth slab
                out["ps_slab_rows"] = int(slab[0][1]["alive"].sum())
            if i == 1:
                p, a, carry["alive"], carry["n"], carry["dense"] = timed(
                    "ps_densify_ms", densify_shards, p, a, mesh, dg)
            carry.update(p=p, a=a)

        cap = _run_mode("pshard", PARALLEL_STEPS, run_ps, cap_on,
                        card_name, out)
        out["ps_densified_digest"] = state_digest(*carry["dense"])
        if rank == 0 and check:
            _check_mode_kernels("pshard-1m-1296x840", cap, card_name)
        out["ps_param_diff"], out["ps_mu_rel"] = _slab_reference_diffs(
            state, carry["A"][1], carry["A"][0], tr["cams"][:1],
            tr["gts"][:1], bg, tr["settings"], opt0, mesh)
        carry.clear()

        # swin-dp, cameras 0 / 1 at frames 0 / 1
        sw = inp["swin"]
        sstep0 = make_dp_swin_train_step(mesh, opt0, sw["settings"], 4.0)
        sstepn = make_dp_swin_train_step(mesh, opt, sw["settings"], 4.0)
        sg = gen(0)
        sdens = swin_step.make_swin_densify_step(SWIN["cap"],
                                                 SWIN["lifespan"])

        def run_sdp(i):
            s, a = carry.get("s", sw["state"]), carry.get(
                "a", optim.init(sw["state"].params()))
            s, a, m = (sstep0 if i == 0 else sstepn)(
                s, a, sg, sw["cams"][rank], sw["gts"][rank],
                sw["frames"][rank], sw["frames"][0], bg, float(i + 1),
                SWIN["sh"])
            if i == 0:
                out["sdp_loss"] = float(m.loss)
                out["sdp_param_diff"] = max(
                    _masked_diff(s.params()[k], sw["ref"][k],
                                 sw["mean_grad"][k]) for k in sw["ref"])
            if i == 1:
                s, a = timed("sdp_densify_ms", sdens, s, a, sg, 0.0, True)
                carry["dense"] = (s, a)
            carry.update(s=s, a=a)

        cap = _run_mode("swin_dp", PARALLEL_STEPS, run_sdp, cap_on,
                        card_name, out)
        out["sdp_digest"] = state_digest(carry["s"], carry["a"])
        out["sdp_densified_digest"] = state_digest(*carry["dense"])
        if rank == 0 and check:
            _check_mode_kernels(f"swin_dp-{SWIN_NAME}", cap, card_name)
        carry.clear()

        # tileshard render of the eval model, two bands
        tl = inp["tile"]
        es = tl["state"]
        render = make_tileshard_render(mesh, tl["settings"], SH_DEGREE)
        args = (es.xyz, es.get_scaling(), es.get_rotation(),
                es.get_opacity()[:, 0], es.get_features(), es.alive_mask)

        def run_ts(i):
            img = render(*args, tl["camera"], bg)
            if i == 0:
                out["ts_max_abs"] = float(
                    (img - tl["ref"]).abs().max())

        cap = _run_mode("tileshard", PARALLEL_STEPS, run_ts, cap_on,
                        card_name, out)
        if rank == 0 and check:
            _check_mode_kernels(f"tileshard-{EVAL_NAME}", cap, card_name)
    dist.barrier()

    # dp x ps: dp rows take cameras 0 / 1, ps shards of each row
    state = tr["state"]
    rows = {k: mesh_lib.shard_rows(v, mesh2d, "ps")
            for k, v in state.params().items()}
    alive = mesh_lib.shard_rows(state.alive_mask, mesh2d, "ps")
    row = mesh2d.axis_index("dp")
    d0 = make_pshard_train_step(mesh2d, opt0, tr["settings"], 4.0,
                                SH_DEGREE, dp_axis="dp")
    dn = make_pshard_train_step(mesh2d, opt, tr["settings"], 4.0,
                                SH_DEGREE, dp_axis="dp")
    ng, dg = gen(1 + mesh2d.axis_index("ps")), gen(0)
    carry = {}

    def run_2d(i):
        p, a = carry.get("p", rows), carry.get("a", optim.init(rows))
        al, n = carry.get("alive", alive), carry.get("n", state.n_alive)
        slab = []
        with capture(pshard_mod, "rasterize", slab):
            p, a, m = (d0 if i == 0 else dn)(
                p, al, a, ng, tr["cams"][row], tr["gts"][row], bg,
                float(i + 1), n)
        if i == 0:
            out["dps_loss"] = float(m.loss)
            (out["dps_vs_single_param_diff"],
             out["dps_vs_single_mu_rel"]) = _shard_update_diffs(
                p, a, tr["ref"], tr["mean_grad"], mesh2d)
            carry["A"] = (p, a)
            out["dps_slab_rows"] = int(slab[0][1]["alive"].sum())
        if i == 1:
            p, a, carry["alive"], carry["n"], carry["dense"] = timed(
                "dps_densify_ms", densify_shards, p, a, mesh2d, dg)
        carry.update(p=p, a=a)

    cap = _run_mode("dp_x_ps", PARALLEL_STEPS, run_2d, cap_on,
                    card_name, out)
    out["dps_densified_digest"] = state_digest(*carry["dense"])
    out["dps_digest"] = _digest(list(carry["p"].values())
                                + list(carry["a"].mu.values())
                                + list(carry["a"].nu.values()))
    if rank == 0 and check:
        _check_mode_kernels("dp_x_ps-1m-1296x840", cap, card_name)
    out["dps_param_diff"], out["dps_mu_rel"] = _slab_reference_diffs(
        state, carry["A"][1], carry["A"][0], tr["cams"], tr["gts"], bg,
        tr["settings"], opt0, mesh2d)
    if check:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return gathered if rank == 0 else None


def parallel_phase(setups, swin_st, eval_state, card_name):
    """The multi-rank modes on four gloo ranks sharing the card, each held
    against the single-device path on the card: dp and swin-dp loss rel
    <= 1e-5 of the camera mean and params within 2e-4 over the entries
    whose mean gradient is at least 2e-4 of the leaf's max; pshard and
    dp x ps loss rel <= 5e-3 of the
    single-device loss, their parameters after step A within 2e-4 over
    the same masked entries, and their first Adam moment within
    PS_MU_REL of the leaf's largest, of the step that the same
    slab-composited loss gives in one process (camera 0 for pshard, the
    camera mean for dp x ps; ``_slab_reference_grads``), dp x ps shards
    bit-equal across dp rows;
    tileshard within 2e-5 of the single-device frame. Each training mode
    densifies after its second step with no broadcast after it (dp and
    swin-dp on the replicated state, pshard and dp x ps on the gathered
    one, as the trainers do): the densified state and moments, and the
    state after the last step, bit-equal across the ranks that replicate
    them (``*_digest``). Every step launches one blend forward, blend
    backward and owner expansion per rank, and multi_cumsum where the
    rows exceed 250k (all three settings); each densification one
    multi_cumsum a template draw. Step times are of N ranks sharing one
    card, not a scaling figure; the second step's includes the
    densification. Returns the launches summed over the ranks."""
    import torch

    from gsplat_tpu_torch.parallel import launch

    t0 = time.time()
    path = parallel_inputs(setups, swin_st, eval_state, card_name)
    tr = torch.load(path, map_location="cpu", weights_only=False)
    loss_cam = tr["train"]["loss_cam"]
    sloss_cam = tr["swin"]["loss_cam"]
    del tr
    torch.cuda.empty_cache()
    setup_s = time.time() - t0
    t0 = time.time()
    res = launch.run(parallel_rank, 4, DEVICE, (path, card_name),
                     backend="gloo")
    run_s = time.time() - t0
    r0, r1, r2, r3 = res
    dp_mean, sdp_mean = float(np.mean(loss_cam)), float(np.mean(sloss_cam))

    def rel(a, b):
        return abs(a - b) / abs(b)

    fails = []
    for r in (r0, r1):
        if rel(r["dp_loss"], dp_mean) > 1e-5 or r["dp_param_diff"] > 2e-4:
            fails.append(f"dp rank {r['rank']}: {r['dp_loss']} vs {dp_mean}"
                         f", params {r['dp_param_diff']}")
        if rel(r["sdp_loss"], sdp_mean) > 1e-5 or r["sdp_param_diff"] > 2e-4:
            fails.append(f"swin-dp rank {r['rank']}: {r['sdp_loss']} vs "
                         f"{sdp_mean}, params {r['sdp_param_diff']}")
        if rel(r["ps_loss"], loss_cam[0]) > 5e-3 or \
                r["ps_param_diff"] > 2e-4 or r["ps_mu_rel"] > PS_MU_REL:
            fails.append(f"pshard rank {r['rank']}: {r['ps_loss']} vs "
                         f"{loss_cam[0]}, params {r['ps_param_diff']}, "
                         f"mu {r['ps_mu_rel']}")
        if r["ts_max_abs"] > 2e-5:
            fails.append(f"tileshard rank {r['rank']}: {r['ts_max_abs']}")
    for r in res:
        if rel(r["dps_loss"], dp_mean) > 5e-3 or \
                r["dps_param_diff"] > 2e-4 or r["dps_mu_rel"] > PS_MU_REL:
            fails.append(f"dp x ps rank {r['rank']}: {r['dps_loss']} vs "
                         f"{dp_mean}, params {r['dps_param_diff']}, "
                         f"mu {r['dps_mu_rel']}")
    same = {"dp_densified_digest": (r0, r1), "dp_digest": (r0, r1),
            "sdp_densified_digest": (r0, r1), "sdp_digest": (r0, r1),
            "ps_densified_digest": (r0, r1),
            "dps_densified_digest": res, "dps_digest": (r0, r2)}
    for key, ranks in same.items():
        if len({r[key] for r in ranks}) != 1:
            fails.append(f"{key}: the ranks differ")
    if r1["dps_digest"] != r3["dps_digest"]:
        fails.append("dps_digest: the shards differ across dp rows")
    # template draws of each mode's densification
    draws = dict(dp=2, pshard=2, dp_x_ps=2, swin_dp=SWIN["lifespan"] + 1)
    n = PARALLEL_STEPS
    for r in res:
        for mode, got in r["launches"].items():
            if mode == "tileshard":
                owner = got["expand_scan"] + got["merge_expand"]
                ok = (got["tile_blend_forward"] == n and owner == n
                      and sum(got.values()) == 2 * n)
            else:
                want = dict(tile_blend_forward=n, tile_blend_backward=n,
                            merge_expand=n, multi_cumsum=n + draws[mode],
                            multi_cummax=draws[mode])
                ok = all(got[k] == want.get(k, 0) for k in got)
            if not ok:
                fails.append(f"rank {r['rank']} {mode}: launches {got}")
    if fails:
        raise AssertionError("parallel: " + "; ".join(fails))
    launches = {k: 0 for k in r0["launches"]["dp"]}
    for r in res:
        for got in r["launches"].values():
            for k, v in got.items():
                launches[k] += v
    log("parallel", card=card_name, ranks=4, backend="gloo",
        note="N ranks sharing one H100 over gloo: not a scaling figure",
        settings={"dp / pshard / dp_x_ps": "1m-1296x840",
                  "swin_dp": SWIN_NAME, "tileshard": EVAL_NAME},
        single_device_loss_cam01=loss_cam, swin_loss_cam01=sloss_cam,
        per_rank=[{k: v for k, v in r.items() if not k.endswith("digest")}
                  for r in res],
        replicated_bit_equal=True, densified_bit_equal=True,
        dp_densify_step_ms=r0["ms_per_step"]["dp"][0],
        setup_s=setup_s, ranks_s=run_s)
    return launches


# bench.py's result line (bench.py:495-525) and bench_torch's ``device``
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "config")
BENCH_CONFIG_KEYS = (
    "gaussians", "image", "tile", "backend", "device", "k_dup",
    "ms_per_iter", "windows_it_per_s", "render_fps_1080p", "render_image",
    "render_num_dup", "render_ms", "train_1m_ms_per_iter",
    "train_1m_vs_anchor", "train_1m_workload", "train_1m_gaussians",
    "train_1m_image", "train_1m_num_dup", "train_1m_windows_ms",
    "swin_ms_per_iter", "swin_cap", "swin_image", "swin_windows_ms",
    "hw_parity_psnr", "hw_parity_train_psnr", "hw_parity_infer_psnr",
    "hw_parity_loss_rel", "hw_parity_param_delta_rel",
    "hw_parity_param_delta_rel_masked")
# its rates and times (each must be finite and > 0) and parity fields
BENCH_RATES = ("ms_per_iter", "windows_it_per_s", "render_fps_1080p",
               "render_ms", "train_1m_ms_per_iter", "train_1m_windows_ms",
               "swin_ms_per_iter", "swin_windows_ms")
BENCH_CLI_TIMEOUT = 600


def bench_cli_phase(in_process, card_name):
    """``python3 bench_torch.py`` at full size in a process of its own
    (after the build, so it finds the kernels built): rc 0, exactly one
    JSON line on stdout with bench.py's keys and ``device``, every rate and
    time finite and > 0, the parity fields finite. Its kernels' launches
    are that process's own and are not counted here. The line is logged
    beside ``in_process``, the figures this process measured in the same
    settings (``train``, ``swin_train``, ``bench_render``), with the ratio
    of each pair; no gate on the ratios, since the two processes carry
    different host work (a fresh process has run nothing else)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    res = subprocess.run([sys.executable,
                          os.path.join(ROOT, "bench_torch.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=BENCH_CLI_TIMEOUT)
    seconds = time.time() - t0
    with open(os.path.join(WORK, "bench_torch.log"), "w") as f:
        f.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_cli: rc {res.returncode}, stdout "
                             f"{res.stdout[-2000:]!r}, stderr "
                             f"{res.stderr[-3000:]}")
    out = json.loads(lines[0])
    cfg = out.get("config", {})
    missing = [k for k in BENCH_KEYS if k not in out] + [
        k for k in BENCH_CONFIG_KEYS if k not in cfg]
    if missing:
        raise AssertionError(f"bench_cli: missing {missing}, line {out}")
    numbers = [out["value"]] + [x for k in BENCH_RATES
                                for x in np.ravel(cfg[k]).tolist()]
    parity = [cfg[k] for k in BENCH_CONFIG_KEYS if k.startswith("hw_")]
    if not all(math.isfinite(x) and x > 0 for x in numbers) or \
            not all(math.isfinite(x) for x in parity):
        raise AssertionError(f"bench_cli: a rate or time not finite and "
                             f"> 0, or a parity field not finite: {out}")
    log("bench_cli", card=card_name, seconds=seconds, rc=res.returncode,
        note="launch counts are the bench process's own, not counted here",
        stage_seconds={m[1]: float(m[2]) for m in re.finditer(
            r"stage: (\w+_stage): ([\d.]+) s", res.stderr)},
        result=out, in_process=in_process,
        ratio_bench_over_in_process={k: cfg[k] / v
                                     for k, v in in_process.items()})


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
        from gsplat_tpu_torch.raster import rasterize as rast
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
    cummax_alone = check_multi_cummax(card_name)
    check_small(card_name)

    # ---- serving main paths (a graph replay a frame; their launches are
    # counted from the profile phase's trace); then the same cameras'
    # bf16 images, rendered eagerly, for the encode's check
    wrappers = {"expand_scan": scan_kernel.expand_scan,
                "merge_expand": scan_kernel.merge_expand,
                "render_forward": tile_kernel.render_forward,
                "encode_rgb8": tile_kernel.encode_rgb8}
    images, launches, raw = {}, {}, {}
    *frame_rows, alive = sv["rows"]
    bg = torch.zeros(3, device=DEVICE)
    for setting, fn in render_fns.items():
        images[setting] = [fn(cam) for cam in cams]
        torch.cuda.synchronize()
        raw[setting] = [rast.render_image(
            *frame_rows, cam, SH_DEGREE, bg, sv["k_dup"][setting],
            alive=alive)[0] for cam in cams]
    kernels["encode_rgb8"] = check_encode(raw, images, card_name)
    for setting, imgs in images.items():
        for img in imgs:
            if img.shape != (HEIGHT, WIDTH, 3) or img.dtype != torch.uint8:
                raise AssertionError(f"{setting}: bad image")
            img01 = img.float() / 255
            if float(img01.mean()) < 0.02 or float(img01.std()) < 0.02:
                raise AssertionError(f"{setting}: trivial image")
    same = [bool(torch.equal(a, b)) for a, b in zip(images["expand"],
                                                     images["merge"])]
    if not all(same):
        raise AssertionError(f"expand and merge settings differ: {same}")
    log("serve", card=card_name, frames=2 * len(cams),
        image_means=[round(float(i.float().mean()) / 255, 5)
                     for i in images["expand"]],
        settings_identical=True)

    # ---- over the socket
    for setting, k in (("expand", k_expand), ("merge", k_merge)):
        socket_phase(model_dir, setting, k, cams, render_fns[setting],
                     card_name)

    # ---- numbers
    fps = {}
    for setting, fn in render_fns.items():
        for cam in cams:
            fn(cam)
        torch.cuda.synchronize()
        ms, _ = bench.timed_windows(
            lambda i: fn(cams[i % len(cams)]),  # noqa: B023
            bench.SIZES["cuda"]["render"]["frames"],
            lambda _: torch.cuda.synchronize())
        windows = [1e3 / x for x in ms]
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
            served=torch.clamp(raw["expand"][0].float().permute(1, 2, 0),
                               0.0, 1.0), card_name=card_name)
    # bench_torch's render stage in process: the bare 100k scene at 1080p
    launches[BENCH_RENDER_NAME], bench_render = bench_render_phase(
        wrappers, card_name)

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
    # ---- the eval entry points (render, metrics) on the 1M setting's
    # model; launch counts of the render process
    eval_launches = eval_phase(trained["1m-1296x840"][0], card_name)

    # ---- the swin main paths, counts zeroed before each: training, the
    # window slide, the CLI and its playback
    swin_launches = {}
    swin_launches["train"], swin_ms, *swin_trained = swin_train(
        swin_st, wrappers, card_name)
    swin_launches["slide"] = swin_slide(swin_st, *swin_trained, wrappers,
                                        card_name)
    swin_launches["cli"] = swin_cli(wrappers, card_name)

    # ---- two runs of steps around a densification, bit for bit, per
    # training setting; counts zeroed before each run
    det_launches, det_keep = determinism_phase(setups, swin_st, wrappers,
                                               card_name)
    more_launches = {"determinism": {
        k: sum(n[k] for n in det_launches.values()) for k in wrappers}}
    # multi_cummax's main-path shape: the 1M relocation's CDF bits
    kernels["multi_cummax"] = det_keep["cummax_entry"]

    # ---- resume from a checkpoint under replayed draws, the replay CLI
    # on the card and the CPU (its trace read back), ARAP; counts zeroed
    # before each
    more_launches["resume"] = resume_phase(setups["100k-800x800"], wrappers,
                                           card_name)
    more_launches["replay"], replay_dir = replay_phase(card_name)
    profile_phase(replay_dir, card_name)
    # ARAP on the trained swin state (its rigid motion is not zero)
    more_launches["arap"] = arap_phase(swin_st, swin_trained[0], wrappers,
                                       card_name)
    # ---- the long-run soaks at full width, cut in length; counts zeroed
    # before each
    more_launches["soak"] = soak_phase(wrappers, card_name)
    more_launches["soak_swin"] = soak_swin_phase(wrappers, card_name)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- device time by kernel, after every unprofiled timing
    # the served frames' launches, by kernel name, from each pass's trace
    per_frame = {"expand": ("expand_scan", "render_forward", "encode_rgb8"),
                 "merge": ("merge_expand", "render_forward", "encode_rgb8")}
    for setting, fn in render_fns.items():
        ran = profile_frames(fn, cams, setting, 1e3 / fps[setting],
                             passes[setting], card_name)
        launches[setting] = {name: ran[kernel]
                             for name, kernel in SERVED_KERNELS.items()}
        want = {name: len(cams) if name in per_frame[setting] else 0
                for name in SERVED_KERNELS}
        if launches[setting] != want:
            raise AssertionError(f"{setting}: launches {launches[setting]} "
                                 f"in the trace, expected {want}")
    for name, st in setups.items():
        profile_train(name, st, *trained[name], step_ms[name], card_name)
    profile_swin(swin_st, *swin_trained, swin_ms, card_name)
    cummax_device_ms(cummax_alone, card_name)
    determinism_profile(det_keep, card_name)

    # ---- the multi-rank modes, in processes of their own (their times are
    # not slowed by this process's profiles); this process first lets go
    # of what they do not need
    eval_state = trained["1m-1296x840"][0]
    del sv, render_fns, store, cap, images, raw, train_caps, swin_cap
    del trained
    del swin_trained, det_keep
    gc.collect()
    torch.cuda.empty_cache()
    more_launches["parallel"] = parallel_phase(setups, swin_st, eval_state,
                                               card_name)
    # ---- bench_torch.py at full size in a process of its own, beside the
    # in-process figures of the same settings
    del setups, swin_st, eval_state
    bench_cli_phase({"ms_per_iter": step_ms["100k-800x800"],
                     "train_1m_ms_per_iter": step_ms["1m-1296x840"],
                     "swin_ms_per_iter": swin_ms,
                     "render_ms": bench_render["render_ms"]}, card_name)
    for name in wrappers:
        kernels[name]["launches"] = sum(
            n.get(name, 0) for group in (launches, train_launches,
                                         swin_launches,
                                         {EVAL_NAME: eval_launches},
                                         more_launches)
            for n in group.values())

    log("done", card=card_name, seconds=time.time() - t_start)
    print(card_name)
    print(json.dumps({"kernels": [
        {k: v for k, v in kernels[name].items()
         if k in KERNEL_LINE_KEYS}
        for name in ("expand_scan", "merge_expand", "render_forward",
                     "tile_blend_forward", "tile_blend_backward",
                     "multi_cumsum", "multi_cummax", "encode_rgb8")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
