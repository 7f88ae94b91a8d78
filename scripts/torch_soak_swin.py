#!/usr/bin/env python3
"""Sliding-window long-run soak of gsplat_tpu_torch on one NVIDIA GPU:
scripts/soak_swin.py's recipe run through the PyTorch/CUDA port.

The window machinery at run_exp1 scale end to end (cap 200k, swin 8,
1280x720, 4 orbit cameras, 44 frames, deform): genesis -> decay_genesis
-> per-window training with the deformable render -> evolve (mature +
stream to streamable.dat + rollover) on each tick -> mature_rest, then
playback of the dumped stream (eval/render_stream) scored against the
procedural dynamic GT: a 100k-Gaussian scene whose per-Gaussian rigid
motion (core/quaternion.rigid_deform) is integrated per frame and
rendered per (frame, camera) as the window slides. All draws come from one
``np.random.default_rng(0)`` in soak_swin.py's order; JAX's PRNG key
chain becomes one seeded ``torch.Generator`` on the device.

Run from the root of a checkout:

    python3 scripts/torch_soak_swin.py                # on the card
    python3 scripts/torch_soak_swin.py --device cpu   # soak_swin.py's CPU
                                                      # sizes, plain kernels

The last line of stdout is JSON with soak_swin.py's keys (soak_swin.py:
226-240) and ``config.device`` (nvidia-smi's name and power limit, "cpu"
with --device cpu), ``peak_mem_gb`` (torch.cuda.max_memory_allocated;
null on the CPU), ``matured_per_tick`` (the records each evolve and the
final mature_rest streamed), ``budget_changes`` (each regrow with the
peak memory of the stretches before and after it) and
``kernel_launches`` (the hand kernels' launch counts over the training
and playback). With ``--device cuda`` and no card it prints a failure
line and exits 1; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from gsplat_tpu_torch.train import swin_step as sstep  # noqa: E402
from gsplat_tpu_torch.train import train_swin  # noqa: E402

OUT = os.path.join(ROOT, "build", "soak_swin")
# soak_swin.py's CPU sizes (:68-73), which --device cpu takes in place of
# the flags'; on the card the flags' and these widths
CPU = dict(cap=2000, frames=12, genesis_iters=60, window_iters=30)
SIZES = {"cuda": dict(width=1280, height=720, p_gt=100_000, cams=4,
                      k_gt=1 << 20, tile_x=64),
         "cpu": dict(width=160, height=96, p_gt=800, cams=3, k_gt=1 << 15,
                     tile_x=16)}
SH = 1
CHUNK = 128
SPATIAL_LR_SCALE = 4.0
GT_CACHE = 80   # rendered ground truths kept on the device


def setup(device, rng, args, cfg=None) -> dict:
    """soak_swin.py:74-136: the dynamic GT (``_make_scene(p_gt, 1,
    seed=1)`` with half its rows moving, drawn from ``rng``), its renders
    by (frame, camera) through a bounded cache, the cap-row uniform cloud
    with a ring of as many rows (deform), the window manager, and the
    frame-0 budget probe at headroom 1.25."""
    import torch

    from gsplat_tpu_torch.core.quaternion import rigid_deform
    from gsplat_tpu_torch.model import optim, swin
    from gsplat_tpu_torch.raster.rasterize import (RasterizeSettings,
                                                   rasterize)
    from gsplat_tpu_torch.utils.stream import SliWinManager

    cfg = cfg or SIZES[torch.device(device).type]
    p_gt = cfg["p_gt"]
    bg = torch.zeros(3, device=device)
    gt_means, gt_scales, gt_quats, gt_opa, gt_shs = \
        bench_torch.make_scene_params(p_gt, SH, 1, device)
    means = gt_means.cpu().numpy()
    moving = rng.random(p_gt) < 0.5
    gt_v = np.zeros((p_gt, 3), np.float32)
    gt_rotvec = np.zeros((p_gt, 3), np.float32)
    gt_rotcen = np.zeros((p_gt, 3), np.float32)
    gt_v[moving] = rng.normal(0, 0.008, (int(moving.sum()), 3))
    gt_rotvec[moving] = rng.normal(0, 0.01, (int(moving.sum()), 3))
    gt_rotcen[moving] = means[moving] + rng.normal(
        0, 0.3, (int(moving.sum()), 3))
    motion = [torch.as_tensor(a, device=device)
              for a in (gt_v, gt_rotvec, gt_rotcen)]
    cams = bench_torch.orbit_cameras(cfg["cams"], cfg["width"],
                                     cfg["height"], device)
    settings = RasterizeSettings(k_dup=cfg["k_gt"], tile_x=cfg["tile_x"],
                                 tile_y=16, chunk=CHUNK, layout="chw")
    gt_cache = {}

    @torch.no_grad()
    def gt_at(frame, ci):
        k = (frame, ci)
        if k not in gt_cache:
            mv, q = rigid_deform(gt_means, gt_quats, *motion,
                                 torch.tensor(float(frame), device=device))
            gt_cache[k] = rasterize(mv, gt_scales, q, gt_opa, gt_shs,
                                    cams[ci], SH, bg, settings).image
            if len(gt_cache) > GT_CACHE:
                gt_cache.pop(next(iter(gt_cache)))
        return gt_cache[k]

    cap = args.cap
    state = swin.create_from_points(
        rng.uniform(-1, 1, (cap, 3)).astype(np.float32),
        rng.uniform(0, 1, (cap, 3)).astype(np.float32), capacity=cap,
        max_sh_degree=SH, max_lifespan=args.swin_size, buffer_size=cap,
        deform=True, device=device)
    with torch.no_grad():
        kw = swin.union_params_at(state, 0.0)
        need = max(int(rasterize(kw["means3d"], kw["scales"], kw["quats"],
                                 kw["opacities"], kw["shs"], c, SH, bg,
                                 settings, alive=kw["alive"]).num_dup)
                   for c in cams)
    settings = dataclasses.replace(settings, k_dup=bench_torch.probe_k_dup(
        need, CHUNK, headroom=1.25))
    return dict(device=device, cfg=cfg, bg=bg, cams=cams, gt_at=gt_at,
                motion=(gt_v, gt_rotvec, gt_rotcen), state=state,
                adam=optim.init(state.params()), settings=settings,
                need=need, mgr=SliWinManager(args.swin_size, args.frames,
                                             10))


def build_steps(args, opt):
    """soak_swin.py:126-132: the steps at a budget, for StepBox."""
    def build(s):
        return (sstep.make_swin_train_step(opt, s, SPATIAL_LR_SCALE),
                sstep.make_swin_densify_step(args.cap, args.swin_size),
                sstep.make_swin_eval_step(s),
                sstep.make_swin_grad_step(opt, s, SPATIAL_LR_SCALE),
                sstep.make_swin_apply_step(opt, SPATIAL_LR_SCALE))
    return build


class Soak:
    """The run's state between windows: the model, its Adam state, the
    generator, the step box and the records."""

    def __init__(self, su, rng, args, say=print):
        from gsplat_tpu_torch.train.config import OptimizationConfig

        self.su, self.rng, self.args, self.say = su, rng, args, say
        self.opt = OptimizationConfig()
        self.state, self.adam = su["state"], su["adam"]
        self.gen = bench_torch.generator(su["device"], 0)
        self.box = train_swin.StepBox(build_steps(args, self.opt),
                                      su["settings"])
        self.regrows = 0
        self.budget_changes = []
        self.window_stats = []

    def run_window(self, genesis: bool) -> None:
        """soak_swin.py:139-192: a frame of the window and a camera drawn
        each iteration; densification iterations split the step into
        grad, densify and apply (no Adam), the others take the fused
        step; the budget may grow every 10 iterations."""
        su, args, box, rng = self.su, self.args, self.box, self.rng
        mgr, cams, bg = su["mgr"], su["cams"], su["bg"]
        total = args.genesis_iters if genesis else args.window_iters
        frames_in_window = list(mgr.sampled_frames())
        n_cams = len(cams)
        t0 = time.time()
        m = None
        for it in range(1, total + 1):
            f = frames_in_window[int(rng.integers(len(frames_in_window)))]
            ci = int(rng.integers(n_cams))
            gt = su["gt_at"](f, ci)
            if train_swin.densify_due(self.opt, it, genesis):
                grads, m = box.grad(self.state, cams[ci], gt, bg, float(f),
                                    SH)
                self.state, self.adam = box.densify(
                    self.state, self.adam, self.gen, float(mgr.frame_start),
                    genesis)
                self.state, self.adam = box.apply(
                    self.state, self.adam, grads, self.gen, float(it),
                    float(f), False)
            else:
                self.state, self.adam, m = box.train(
                    self.state, self.adam, self.gen, cams[ci], gt, bg,
                    float(it), float(f), SH)
            k_before = box.settings.k_dup
            if it % 10 == 0 and box.maybe_grow(int(m.num_dup), CHUNK):
                self.regrows += 1
                self.budget_changes.append({
                    "window": str(mgr), "it": it, "num_dup": int(m.num_dup),
                    "from": k_before, "to": box.settings.k_dup,
                    "peak_mem_gb_before": bench_torch.peak_gb(su["device"],
                                                   reset=True)})
        loss = float(m.loss)
        dt = (time.time() - t0) * 1000 / total
        self.window_stats.append({
            "window": str(mgr), "genesis": genesis,
            "ms_per_iter": round(dt, 1), "loss": round(loss, 5),
            "n_active": int(m.n_active), "num_dup": int(m.num_dup),
            "k_dup": box.settings.k_dup})
        self.say(f"[{mgr}] {dt:.1f} ms/it loss={loss:.5f} "
                 f"active={int(m.n_active)} dup={int(m.num_dup)}/"
                 f"{box.settings.k_dup}")


def _record_bytes() -> int:
    from gsplat_tpu_torch.utils.stream import _record_dtype

    return _record_dtype(SH).itemsize


def _streamed(path) -> int:
    return os.path.getsize(path) // _record_bytes() \
        if os.path.exists(path) else 0


def train(soak, out) -> dict:
    """soak_swin.py:194-207: genesis, decay_genesis, then per tick evolve
    and a window, then mature_rest; the stream goes to
    ``out``/streamable.dat. Returns the wall seconds, the records each
    evolve and the mature_rest streamed, and the stream's path."""
    from gsplat_tpu_torch.model import swin

    mgr = soak.su["mgr"]
    os.makedirs(out, exist_ok=True)
    dump_path = os.path.join(out, "streamable.dat")
    if os.path.exists(dump_path):
        os.remove(dump_path)
    matured = []
    t_start = time.time()
    soak.run_window(genesis=True)
    soak.state = swin.decay_genesis(soak.state)
    mgr.tick()
    while mgr.frame_end <= mgr.max_frame:
        n = _streamed(dump_path)
        soak.state, soak.adam = train_swin.evolve(soak.state, soak.adam, mgr,
                                                  dump_path, SH)
        matured.append(_streamed(dump_path) - n)
        soak.run_window(genesis=False)
        mgr.tick()
    n = _streamed(dump_path)
    soak.state, soak.adam = train_swin.mature_rest(soak.state, soak.adam,
                                                   dump_path, SH)
    matured.append(_streamed(dump_path) - n)
    return dict(wall=time.time() - t_start, matured=matured,
                dump_path=dump_path)


def playback(soak, out) -> tuple:
    """soak_swin.py:209-224: the dumped stream played (the stream
    player's uint8 frame) from camera 0 every frames // 8 frames at the
    final budget against the GT; returns ([(frame, PSNR dB)], the
    stream's record count)."""
    from gsplat_tpu_torch.eval.render_stream import (load_stream_state,
                                                     render_stream_frame)

    su, frames = soak.su, soak.args.frames
    data = load_stream_state(out, device=su["device"])
    psnrs = []
    for f in range(0, frames, max(frames // 8, 1)):
        img = render_stream_frame(data, su["cams"][0], float(f), su["bg"],
                                  soak.box.settings.k_dup).cpu().numpy() / 255
        gt_hwc = su["gt_at"](f, 0).permute(1, 2, 0).cpu().numpy()
        mse = np.mean((np.clip(img, 0, 1) - np.clip(gt_hwc, 0, 1)) ** 2)
        psnrs.append((f, float(-10 * np.log10(mse + 1e-12))))
    return psnrs, int(data["xyz"].shape[0])


def result(soak, tr, psnrs, records) -> dict:
    """soak_swin.py's result line (:226-240) and the port's keys."""
    ws = soak.window_stats
    ms_list = [w["ms_per_iter"] for w in ws if not w["genesis"]]
    return {
        "frames": soak.args.frames,
        "wall_minutes": round(tr["wall"] / 60, 2),
        "genesis_ms_per_iter": ws[0]["ms_per_iter"],
        "window_ms_first": ms_list[0] if ms_list else None,
        "window_ms_last": ms_list[-1] if ms_list else None,
        "window_ms_median": float(np.median(ms_list)) if ms_list else None,
        "stream_bytes": os.path.getsize(tr["dump_path"]),
        "stream_records": records,
        "budget_regrows": soak.regrows,
        "playback_psnr": psnrs,
        "windows": ws,
        "config": {"device": None},
        "peak_mem_gb": None,
        "matured_per_tick": tr["matured"],
        "budget_changes": soak.budget_changes,
        "kernel_launches": None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=44)
    ap.add_argument("--swin_size", type=int, default=8)
    ap.add_argument("--cap", type=int, default=200_000)
    ap.add_argument("--genesis_iters", type=int, default=500)
    ap.add_argument("--window_iters", type=int, default=150)
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu for soak_swin.py's CPU "
                         "sizes on the plain versions")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"frames": args.frames,
                          "config": {"error": "CUDA device unavailable: "
                                              "torch.cuda.is_available() "
                                              "is False"}}))
        return 1
    if args.device == "cpu":
        args.cap, args.frames = CPU["cap"], CPU["frames"]
        args.swin_size = min(args.swin_size, 8)
        args.genesis_iters = CPU["genesis_iters"]
        args.window_iters = CPU["window_iters"]
    rng = np.random.default_rng(0)
    su = setup(args.device, rng, args)
    say = lambda s: print(s, flush=True)  # noqa: E731
    say(f"swin soak: cap {args.cap}, {args.frames} frames, swin "
        f"{args.swin_size}, {su['cfg']['width']}x{su['cfg']['height']}, "
        f"dup budget {su['settings'].k_dup} (probe {su['need']})")
    soak = Soak(su, rng, args, say)
    launches0 = bench_torch.kernel_launches()
    bench_torch.peak_gb(args.device, reset=True)
    tr = train(soak, args.out)
    psnrs, records = playback(soak, args.out)
    res = result(soak, tr, psnrs, records)
    res["kernel_launches"] = {
        k: v - launches0[k] for k, v in bench_torch.kernel_launches().items()}
    # each change's "after" is the peak of the stretch that follows it
    changes, last = soak.budget_changes, bench_torch.peak_gb(args.device)
    for before, after in zip(changes, changes[1:] + [None]):
        before["peak_mem_gb_after"] = (after["peak_mem_gb_before"] if after
                                       else last)
    if args.device == "cuda":
        res["config"]["device"] = bench_torch.card()
        res["peak_mem_gb"] = max(
            [last] + [c["peak_mem_gb_before"] for c in changes])
    else:
        res["config"]["device"] = "cpu"
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
