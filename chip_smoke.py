#!/usr/bin/env python3
"""On-card smoke test of the gsplat_tpu_torch serving path (one NVIDIA GPU).

Run from the root of a checkout:  python3 chip_smoke.py

It builds the CUDA kernels from gsplat_tpu_torch/csrc, then serves a
100k-Gaussian SH-3 model (written as a PLY from a seed) at cap_max 1M and
1920x1088 through the port's own entry points, in the server's two owner
expansion settings:

  expand   k_dup = 8 x cap_max = 8,000,000 (the server's default):
           scatter-max + the expand_scan kernel (2 k_dup >= 7 P)
  merge    --dup_budget 877,568 (raised by the 1.02 rule if a camera
           needs more): the merge_expand kernel (2 k_dup < 7 P)

Phases, one JSON line each; any failure raises and exits non-zero before
the result line is printed:

  build    compile the kernels (seconds)
  probe    num_dup of the 8 orbit cameras; the merge budget; kernel inputs
           captured from the first camera of each setting
  kernels  each kernel against its plain PyTorch version on those inputs,
           on the card: expand_scan and merge_expand bit-equal, the render
           within two bf16 ULPs per pixel; CUDA-event times of both
  small    a 300-Gaussian scene rendered on the card vs the port on the CPU
  serve    per setting, launch counts zeroed, its 8 cameras rendered
           through viewer.serve.make_render_fn, counts read: each frame
           launched its setting's expansion kernel and the render once;
           images finite, non-trivial and identical across the settings
  socket   python -m gsplat_tpu_torch.viewer.serve as a subprocess per
           setting, 3 SIBR requests with keep_alive; reply bytes must equal
           the in-process image
  fps      frames/s over 3 windows of 48 frames per setting
  profile  device time by kernel over 8 frames; the device idle share
           against the unprofiled frame time of the fps phase
  quality  PSNR of the served frame vs the plain render of an f32 feature
           stream (the bf16 global x/y rounding of the reference)

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


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- scene ----

def write_scene_ply(path: str, p: int, sh_degree: int, seed: int = 0):
    """The bench's render-stage model (__graft_entry__._make_scene recipe)
    as raw PLY leaves: uniform cloud at z in [2, 6], log-uniform scales,
    random quaternions, opacity logits in [-2, 4], SH DC around 1."""
    from gsplat_tpu_torch.data import ply

    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.2, 1.2, size=(p, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2.0, 6.0, size=p)
    log_scales = rng.uniform(-3.5, -2.0, size=(p, 3)).astype(np.float32)
    quats = rng.normal(size=(p, 4)).astype(np.float32)
    opa_logit = rng.uniform(-2, 4, size=p).astype(np.float32)
    shs = (0.3 * rng.normal(size=(p, (sh_degree + 1) ** 2, 3))
           ).astype(np.float32)
    shs[:, 0, :] += 1.0
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

def check_kernels(cap, card_name):
    """Each kernel vs its plain version on main-path inputs; returns the
    kernels-line entries (launch counts filled in later)."""
    import torch

    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel

    out = {}
    (marks, base_in), _ = cap["expand_scan"]
    k = marks.shape[0]
    got = scan_kernel.expand_scan(marks, base_in)
    want = scan_kernel.expand_scan_plain(marks, base_in)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"expand_scan differs from plain: {err}")
    nbytes = 20 * k            # 2 int32 in, 3 int32 out per slot
    out["expand_scan"] = dict(
        name="expand_scan", route="cuda",
        source="gsplat_tpu_torch/csrc/scan_kernels.cu",
        replaces="gsplat_tpu/raster/scan_kernel.py:202",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: scan_kernel.expand_scan(marks, base_in), 20),
        plain_ms=cuda_ms(lambda: scan_kernel.expand_scan_plain(marks,
                                                               base_in), 5),
        bound_ms=nbytes / MEM_BPS * 1e3, bound_by="bytes", library_ms=None,
        shape=f"K={k}")
    log("kernel", card=card_name, **out["expand_scan"])

    (starts, pack, kk), _ = cap["merge_expand"]
    got = scan_kernel.merge_expand(starts, pack, kk)
    want = scan_kernel.merge_expand_plain(starts, pack, kk)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"merge_expand differs from plain: {err}")
    p = starts.shape[0]
    nbytes = 8 * p + 12 * kk   # starts + pack read once, 3 int32 out
    ops = kk * max(1, math.ceil(math.log2(p + 1)))  # binary-search steps
    out["merge_expand"] = dict(
        name="merge_expand", route="cuda",
        source="gsplat_tpu_torch/csrc/scan_kernels.cu",
        replaces="gsplat_tpu/raster/scan_kernel.py:260",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: scan_kernel.merge_expand(starts, pack, kk), 20),
        plain_ms=cuda_ms(lambda: scan_kernel.merge_expand_plain(
            starts, pack, kk), 5),
        bound_ms=max(nbytes / MEM_BPS, ops / FP32_OPS) * 1e3,
        bound_by="bytes" if nbytes / MEM_BPS >= ops / FP32_OPS
        else "operations", library_ms=None, shape=f"P={p} K={kk}")
    log("kernel", card=card_name, **out["merge_expand"])

    args, kw = cap["render_forward"]
    feat, meta, bg = args[:3]
    rkw = dict(zip(("num_tiles", "n_pix", "tile_x", "tile_y", "grid_x",
                    "chunk"), args[3:]), **kw)
    got = tile_kernel.render_forward(feat, meta, bg, **rkw)
    want, visits = tile_kernel.render_plain_with_visits(feat, meta, bg,
                                                        **rkw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not within_bf16_ulps(got.float(), want.float()):
        raise AssertionError(f"render_forward differs from plain by more "
                             f"than 2 bf16 ULPs (max abs {err})")
    chunk = rkw["chunk"]
    visited = int(visits.sum())
    # data-dependent work: the chunks the tile-wide stop lets each tile
    # visit (18 B of bf16 features per slot), plus meta and the image
    nbytes = (visited * chunk * 18 + meta.numel() * 4 + 12
              + rkw["num_tiles"] * 3 * rkw["n_pix"] * 2)
    ops = visited * chunk * rkw["n_pix"] * RENDER_OPS_PER_PAIR
    out["render_forward"] = dict(
        name="render_forward", route="cuda",
        source="gsplat_tpu_torch/csrc/render_kernel.cu",
        replaces="gsplat_tpu/raster/tile_kernel.py:816",
        max_abs_err=err,
        ms=cuda_ms(lambda: tile_kernel.render_forward(feat, meta, bg,
                                                      **rkw), 10),
        plain_ms=cuda_ms(lambda: tile_kernel.render_forward_plain(
            feat, meta, bg, **rkw), 2),
        bound_ms=max(nbytes / MEM_BPS, ops / FP32_OPS) * 1e3,
        bound_by="bytes" if nbytes / MEM_BPS >= ops / FP32_OPS
        else "operations", library_ms=None,
        shape=f"tiles={rkw['num_tiles']} slots={feat.shape[1]} "
              f"visited_chunks={visited}")
    log("kernel", card=card_name, **out["render_forward"])
    return out


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
                         e.key[:70]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", card=card_name, setting=setting, frame_ms=frame_ms,
        unprofiled_pass_ms_per_frame=plain_pass_ms,
        profiled_pass_ms_per_frame=profiled_pass_ms,
        device_busy_ms_per_frame=busy if rows else "not measured",
        idle_share=(1 - busy / frame_ms) if rows else "not measured",
        kernels_per_frame=sum(r[1] for r in rows),
        top=[{"kernel": k, "ms_per_frame": round(ms, 4), "calls": c}
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
        from gsplat_tpu_torch.model import gaussians
        from gsplat_tpu_torch.raster import binning, cuda_ext, scan_kernel
        from gsplat_tpu_torch.raster import rasterize as rast
        from gsplat_tpu_torch.raster import tile_kernel
        from gsplat_tpu_torch.viewer import serve
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

    # ---- model and cameras
    model_dir = os.path.join(WORK, "model")
    ply_path = os.path.join(model_dir, "point_cloud", "iteration_1",
                            "point_cloud.ply")
    write_scene_ply(ply_path, N_GAUSS, SH_DEGREE, seed=0)
    state = gaussians.load_ply(ply_path, capacity=CAP_MAX,
                               max_sh_degree=SH_DEGREE, device=DEVICE)
    cams = orbit_cameras(8, WIDTH, HEIGHT, DEVICE)
    p = state.capacity

    # ---- probe: num_dup per camera; capture kernel inputs of camera 0
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

    # ---- each kernel against its plain version
    kernels = check_kernels(cap, card_name)
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
    for setting, fn in render_fns.items():
        profile_frames(fn, cams, setting, 1e3 / fps[setting], passes[setting],
                       card_name)
    quality(cap_slot=store["_slot_features"][0],
            cap_render=cap["render_forward"],
            served=images["expand"][0], card_name=card_name)

    log("done", card=card_name, seconds=time.time() - t_start)
    print(card_name)
    print(json.dumps({"kernels": [
        {k: v for k, v in kernels[name].items() if k != "shape"}
        for name in ("expand_scan", "merge_expand", "render_forward")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
