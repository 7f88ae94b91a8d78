#!/usr/bin/env python3
"""Full-default 30k-iteration training soak of gsplat_tpu_torch on one
NVIDIA GPU: scripts/soak_30k.py's recipe run through the PyTorch/CUDA port.

The reference's complete default schedule (arguments/__init__.py:76-110:
30,010 iterations, densification every 100 in [500, 25,000], exponential
xyz LR over 30k, the SH ramp every 1,000, regs 1e-4, noise_lr 5e4) on the
procedural Lego-scale scene of soak_30k.py (cap 100k, 800x800, 24 orbit
cameras, 0 / 8 / 16 held out), with the adaptive duplicate budget and
held-out PSNR every ``--report_every`` iterations, each report printed as
it happens. All draws come from one ``np.random.default_rng(0)`` in
soak_30k.py's order; JAX's PRNG key chain becomes one seeded
``torch.Generator`` on the device.

Run from the root of a checkout:

    python3 scripts/torch_soak_30k.py                # on the card
    python3 scripts/torch_soak_30k.py --device cpu   # soak_30k.py's CPU
                                                     # sizes, plain kernels

The last line of stdout is JSON with soak_30k.py's keys (soak_30k.py:
186-193) and ``config.device`` (nvidia-smi's name and power limit, "cpu"
with --device cpu), ``peak_mem_gb`` (torch.cuda.max_memory_allocated;
null on the CPU), ``budget_changes`` (each with the peak memory of the
stretches before and after it), ``overflows``, ``densify_ms`` and
``kernel_launches`` (the hand kernels' launch counts over the run). ``recompiles`` keeps its
name and counts budget changes: eager PyTorch compiles nothing, but the
steps are rebuilt at the new budget where the JAX soak recompiled them.
With ``--device cuda`` and no card it prints a failure line and exits 1;
it never falls back to the CPU.

The trained-scene statistics (soak_30k.py's ``_dump_stats`` keys,
quantile grids and subsample rule) go to ``--stats_out``, by default
build/soak_30k/trained_stats.npz: the committed
tests/fixtures/trained_stats.npz is the TPU run's and stays as it is.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from gsplat_tpu_torch.train import step as step_lib  # noqa: E402

STATS_OUT = os.path.join(ROOT, "build", "soak_30k", "trained_stats.npz")
# soak_30k.py's sizes (:54-55, :71-72, :116): on the card its full ones,
# on the CPU its toy ones; k_gt renders the ground truths, k_eval is the
# eval step's own fixed budget
SIZES = {
    "cuda": dict(p_gt=20_000, cap=100_000, width=800, height=800,
                 k_gt=1 << 20, k_eval=1 << 21),
    "cpu": dict(p_gt=500, cap=1_000, width=128, height=128, k_gt=1 << 15,
                k_eval=1 << 15),
}
SH_MAX = 3
N_CAMS = 24
TEST_IDX = (0, 8, 16)
TILE = (64, 16)
CHUNK = 128
SPATIAL_LR_SCALE = 4.0
PROBE_CAMS = 8


def setup(device, rng) -> dict:
    """soak_30k.py:57-104: the ground truth of the 24 orbit cameras
    (``_make_scene(p_gt, 3, seed=5)`` through the training path, CHW for
    the steps, HWC for the eval), n0 = cap // 20 points inside the GT
    volume with uniform colours from the next draws of ``rng``, their
    state and Adam state, and the budget probed over the first 8 training
    cameras at headroom 8.0 with floor 2^19."""
    import torch

    from gsplat_tpu_torch.model import gaussians, optim
    from gsplat_tpu_torch.raster.rasterize import (RasterizeSettings,
                                                   rasterize)

    cfg = SIZES[torch.device(device).type]
    bg = torch.zeros(3, device=device)
    gt_scene = bench_torch.make_scene_params(cfg["p_gt"], SH_MAX, 5, device)
    cams = bench_torch.orbit_cameras(N_CAMS, cfg["width"], cfg["height"],
                                     device)
    settings = RasterizeSettings(k_dup=cfg["k_gt"], tile_x=TILE[0],
                                 tile_y=TILE[1], chunk=CHUNK)
    chw = dataclasses.replace(settings, layout="chw")
    with torch.no_grad():
        gts = [rasterize(*gt_scene, c, SH_MAX, bg, chw).image for c in cams]
    train_ids = [i for i in range(N_CAMS) if i not in TEST_IDX]

    cap = cfg["cap"]
    n0 = cap // 20
    pts0 = rng.uniform(-1.2, 1.2, (n0, 3)).astype(np.float32)
    pts0[:, 2] = rng.uniform(2.0, 6.0, n0).astype(np.float32)
    state = gaussians.create_from_points(
        pts0, rng.uniform(0, 1, (n0, 3)).astype(np.float32), capacity=cap,
        max_sh_degree=SH_MAX, device=device)
    with torch.no_grad():
        need = max(int(rasterize(
            state.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], state.get_features(), cams[i],
            SH_MAX, bg, settings, alive=state.alive_mask).num_dup)
            for i in train_ids[:PROBE_CAMS])
    settings = dataclasses.replace(settings, k_dup=bench_torch.probe_k_dup(
        need, CHUNK, headroom=8.0, floor=1 << 19))
    return dict(device=device, cfg=cfg, bg=bg, cams=cams, gts=gts,
                gts_hwc=[g.permute(1, 2, 0) for g in gts],
                train_ids=train_ids, state=state,
                adam=optim.init(state.params()), settings=settings,
                eval_settings=dataclasses.replace(settings,
                                                  k_dup=cfg["k_eval"]),
                need=need)


class Schedule:
    """The soak's decisions for each iteration (soak_30k.py:128-175): the
    camera (a stack of the training cameras refilled when empty, popped at
    ``rng.integers``), the SH degree, the densify condition, the budget
    policy every 100 iterations, and the report and stats-dump
    iterations."""

    def __init__(self, opt, train_ids, iterations, report_every, chunk):
        self.opt, self.train_ids = opt, list(train_ids)
        self.iterations, self.report_every = iterations, report_every
        self.chunk = chunk
        self.stack = []
        self.dup_peak, self.dup_tightened = 0, False

    def camera(self, rng) -> int:
        if not self.stack:
            self.stack = list(self.train_ids)
        return self.stack.pop(int(rng.integers(len(self.stack))))

    @staticmethod
    def sh_degree(it: int) -> int:
        return min(it // 1000, SH_MAX)

    def densify_due(self, it: int) -> bool:
        o = self.opt
        return (o.densify_from_iter < it < o.densify_until_iter
                and it % o.densification_interval == 0)

    @staticmethod
    def budget_due(it: int) -> bool:
        return it % 100 == 0

    def budget(self, it: int, num_dup: int, k_dup: int) -> int | None:
        """next_dup_budget with soak_30k.py's damping (:148-160): growth
        in x2 jumps, no shrink while densification is still running. The
        JAX soak damps to spare XLA recompiles; the port compiles nothing
        but keeps the same decisions, so that K follows the same recipe."""
        from gsplat_tpu_torch.train.train_static import next_dup_budget

        new_k, self.dup_peak, self.dup_tightened = next_dup_budget(
            num_dup, k_dup, it, self.dup_peak, self.dup_tightened,
            self.opt.densify_until_iter, self.chunk)
        if new_k is not None and new_k < k_dup \
                and it < self.opt.densify_until_iter:
            new_k = None
        if new_k is not None and new_k > k_dup:
            new_k = -(-new_k * 2 // self.chunk) * self.chunk
        return new_k

    def report_due(self, it: int) -> bool:
        return it % self.report_every == 0 or it == self.iterations

    def dump_due(self, it: int) -> bool:
        return self.report_due(it) and it >= 2000


def run(su, rng, iterations, report_every, stats_out, say=print) -> tuple:
    """soak_30k.py:106-198 from ``setup``'s result and the ``rng`` it drew
    from: the loop, the reports (each printed by ``say``), the stats dumps
    and the final one; returns (the result line as a dict, the final
    state, its Adam state)."""
    from gsplat_tpu_torch.train.config import OptimizationConfig

    device, bg, cams = su["device"], su["bg"], su["cams"]
    gts, gts_hwc = su["gts"], su["gts_hwc"]
    state, adam, settings = su["state"], su["adam"], su["settings"]
    cap = su["cfg"]["cap"]
    opt = OptimizationConfig()  # reference defaults
    sched = Schedule(opt, su["train_ids"], iterations, report_every,
                     settings.chunk)

    def build(s):
        return step_lib.make_train_step(opt, s, SPATIAL_LR_SCALE)

    train_step = build(settings)
    densify_step = step_lib.make_densify_step(cap)
    eval_step = step_lib.make_eval_step(su["eval_settings"])
    gen = bench_torch.generator(device, 0)
    recompiles, overflows = 0, []
    changes, densify_ms, eval_log = [], [], []
    launches0 = bench_torch.kernel_launches()
    bench_torch.peak_gb(device, reset=True)
    say(f"soak: cap {cap}, {su['cfg']['width']}x{su['cfg']['height']}, "
        f"{iterations} iterations, k_dup {settings.k_dup}")
    t0 = time.time()
    t_win = t0
    m = None
    for it in range(1, iterations + 1):
        sh_degree = sched.sh_degree(it)
        ci = sched.camera(rng)
        state, adam, m = train_step(state, adam, gen, cams[ci], gts[ci], bg,
                                    float(it), sh_degree)
        if sched.densify_due(it):
            bench_torch.sync(device)
            td = time.perf_counter()
            state, adam = densify_step(state, adam, gen)
            bench_torch.sync(device)
            densify_ms.append((time.perf_counter() - td) * 1e3)
        if sched.budget_due(it):
            loss = float(m.loss)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite loss at iter {it}")
            num_dup = int(m.num_dup)
            if num_dup > settings.k_dup:
                overflows.append({"it": it, "num_dup": num_dup,
                                  "k_dup": settings.k_dup})
                say(f"  WARNING overflow {num_dup} > {settings.k_dup}")
            new_k = sched.budget(it, num_dup, settings.k_dup)
            if new_k is not None:
                changes.append({"it": it, "num_dup": num_dup,
                                "from": settings.k_dup, "to": new_k,
                                "peak_mem_gb_before": bench_torch.peak_gb(
                                    device, reset=True)})
                settings = dataclasses.replace(settings, k_dup=new_k)
                train_step = build(settings)
                recompiles += 1
                say(f"  [it {it}] budget -> {new_k} (recompile "
                    f"#{recompiles})")
        if sched.report_due(it):
            if sched.dump_due(it):
                # incremental: a run that is cut leaves its latest stats
                dump_stats(state, stats_out,
                           f"torch_soak_30k cap={cap} it={it} (incremental)")
            psnrs = [float(eval_step(state, cams[i], gts_hwc[i], bg,
                                     sh_degree)[2]) for i in TEST_IDX]
            dt = time.time() - t_win
            t_win = time.time()
            eval_log.append({"it": it,
                             "psnr": round(float(np.mean(psnrs)), 2),
                             "n_alive": int(state.n_alive),
                             "dup": int(m.num_dup), "k_dup": settings.k_dup,
                             "ms_it": round(dt / report_every * 1000, 2)})
            say(f"[it {it}] loss={float(m.loss):.5f} "
                f"psnr={np.mean(psnrs):.2f} n={int(state.n_alive)} "
                f"dup={int(m.num_dup)}/{settings.k_dup} "
                f"{dt / report_every * 1000:.1f}ms/it")
    bench_torch.sync(device)
    wall = time.time() - t0
    final = eval_log[-1]
    # each change's "after" is the peak of the stretch that follows it
    last = bench_torch.peak_gb(device)
    for before, after in zip(changes, changes[1:] + [None]):
        before["peak_mem_gb_after"] = (after["peak_mem_gb_before"] if after
                                       else last)
    launches = {k: v - launches0[k]
                for k, v in bench_torch.kernel_launches().items()}
    dump_stats(state, stats_out,
               f"torch_soak_30k cap={cap} iters={iterations} "
               f"psnr={final['psnr']}")
    return {"soak_iterations": iterations,
            "wall_minutes": round(wall / 60, 2),
            "final_psnr": final["psnr"],
            "recompiles": recompiles,
            "dup_peak": sched.dup_peak,
            "final_k_dup": settings.k_dup,
            "eval_log": eval_log,
            "config": {"device": None},
            "peak_mem_gb": (None if last is None else max(
                [last] + [c["peak_mem_gb_before"] for c in changes])),
            "budget_changes": changes,
            "overflows": overflows,
            "densify_ms": {"count": len(densify_ms),
                           "median": (float(np.median(densify_ms))
                                      if densify_ms else None),
                           "max": max(densify_ms, default=None)},
            "kernel_launches": launches}, state, adam


def dump_stats(state, path: str, source: str) -> None:
    """soak_30k.py's ``_dump_stats`` (:201-238) on the port's state: the
    alive rows' opacity quantiles, pooled and per-Gaussian sorted log-scale
    quantiles, anisotropy quantiles, the position spread and a 50k
    position subsample from ``default_rng(0)``, on a 257-point grid."""
    alive = state.alive_mask.cpu().numpy()
    opac = state.get_opacity()[:, 0].detach().cpu().numpy()[alive]
    logscale = state.scaling.detach().cpu().numpy()[alive]
    xyz = state.xyz.detach().cpu().numpy()[alive]
    q = np.linspace(0, 1, 257)
    triples = np.sort(logscale, axis=1)
    sorted_triple_q = np.stack(
        [np.quantile(triples[:, i], q) for i in range(3)],
        axis=1).astype(np.float32)
    rng = np.random.default_rng(0)
    n_pos = min(len(xyz), 50_000)
    xyz_sample = xyz[rng.choice(len(xyz), n_pos, replace=False)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        opacity_quantiles=np.quantile(opac, q).astype(np.float32),
        logscale_quantiles=np.quantile(logscale.reshape(-1),
                                       q).astype(np.float32),
        logscale_sorted_quantiles=sorted_triple_q,
        aniso_quantiles=np.quantile(logscale.max(1) - logscale.min(1),
                                    q).astype(np.float32),
        xyz_std=xyz.std(0).astype(np.float32),
        xyz_sample=xyz_sample.astype(np.float32),
        n_alive=np.int64(alive.sum()),
        source=np.bytes_(source))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=30_010)
    ap.add_argument("--stats_out", type=str, default=STATS_OUT)
    ap.add_argument("--report_every", type=int, default=1000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu for soak_30k.py's CPU "
                         "sizes on the plain versions")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"soak_iterations": args.iterations,
                          "config": {"error": "CUDA device unavailable: "
                                              "torch.cuda.is_available() "
                                              "is False"}}))
        return 1
    rng = np.random.default_rng(0)
    su = setup(args.device, rng)
    res, _, _ = run(su, rng, args.iterations, args.report_every,
                    args.stats_out, say=lambda s: print(s, flush=True))
    res["config"]["device"] = (bench_torch.card() if args.device == "cuda"
                               else "cpu")
    print(json.dumps(res))
    print(f"wrote {args.stats_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
