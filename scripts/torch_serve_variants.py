#!/usr/bin/env python3
"""Time versions of the serving path's two kernels, the inference render
and expand_scan, side by side on the serving frame's inputs (one NVIDIA
GPU).

Run from the root of a checkout:

    python3 scripts/torch_serve_variants.py [--render NAME=PATH.cu ...]
                                            [--scan NAME=PATH.cu ...]

It builds ``gsplat_tpu_torch/csrc/render_kernel.cu`` as ``current`` and as
its ablations, each the same source with one feature switched off by a
define:

    no_split   -DRENDER_BLOCK_WARPS=32: one block per tile, no cluster
    blocks2    -DRENDER_BLOCK_WARPS=16: clusters of two blocks, not four
    no_cull    -DRENDER_CULL=0: every (pixel, slot) pair evaluated
    no_ilp     -DRENDER_ILP=0: no straight-line path for slots that meet
               all four sub-blocks (each pixel behind its own branch)

and ``csrc/scan_kernels.cu`` as ``current``, plus every ``--render`` /
``--scan`` file with the same C entry points (an earlier version of the
source: the two-launch expand_scan of earlier revisions is called through
its own signature). Each build is one nvcc with ``raster/cuda_ext.py``'s
flags into a shared library called through ctypes, with its
``-Xptxas=-v`` report. It then records the kernels' inputs on chip_smoke.py's
serving scene (100k Gaussians at cap_max 1M, 1920x1088, 128x32 tiles, k_dup
8M) through chip_smoke.py's own setup: camera 0's, as chip_smoke.py's
kernel phase takes them, and the render's for each of the 8 orbit cameras.
It holds every build against the plain versions on camera 0
(``chip_smoke.check_render``: within two bf16 ULPs, two launches bit-equal;
``chip_smoke.check_expand``: bit-equal, two launches bit-equal) and times
them with ``chip_smoke.cuda_ms`` in turns, in order and then in reverse
order: expand_scan on camera 0, the render on every camera. One JSON line a
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
CSRC = os.path.join(ROOT, "gsplat_tpu_torch", "csrc")
RENDER = os.path.join(CSRC, "render_kernel.cu")
SCAN = os.path.join(CSRC, "scan_kernels.cu")
# the render ablations: one define each on the checkout's source
RENDER_ABLATIONS = {"no_split": ["-DRENDER_BLOCK_WARPS=32"],
                    "blocks2": ["-DRENDER_BLOCK_WARPS=16"],
                    "no_cull": ["-DRENDER_CULL=0"],
                    "no_ilp": ["-DRENDER_ILP=0"]}
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def kernel_label(entry):
    """The report's name of a kernel entry function, or None (the render's
    instantiation for pixel groups and chunk pieces, template argument
    true, is "render_kernel_split")."""
    for name in ("render_kernel", "expand_scan_kernel",
                 "expand_reduce_kernel"):
        if name in entry:
            return name + ("_split" if "Lb1E" in entry else "")
    return None


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


class Render:
    """gsplat_render_forward of one build, with the wrapper's signature (a
    scratch buffer for tiles of several pixel groups, or, in earlier
    revisions, none)."""

    def __init__(self, so):
        lib = ctypes.CDLL(so)
        self.fn = lib.gsplat_render_forward
        self.fn.restype = I
        self.scratch = getattr(lib, "gsplat_render_scratch_floats", None)
        if self.scratch is None:
            self.fn.argtypes = [P, LL, P, I, P, P] + [I] * 6 + [P]
        else:
            self.scratch.argtypes, self.scratch.restype = [I] * 4, LL
            self.fn.argtypes = [P, LL, P, I, P, P, P] + [I] * 6 + [P]

    def __call__(self, feat, meta, bg, num_tiles, n_pix, tile_x, tile_y,
                 grid_x, chunk):
        import torch

        out = torch.empty(num_tiles, 3, n_pix, dtype=torch.bfloat16,
                          device=feat.device)
        head = [feat.data_ptr(), feat.shape[1], meta.data_ptr(),
                meta.numel(), bg.data_ptr(), out.data_ptr()]
        if self.scratch is not None:
            scratch = torch.empty(self.scratch(num_tiles, n_pix, tile_x,
                                               tile_y),
                                  dtype=torch.float32, device=feat.device)
            head.append(scratch.data_ptr() if scratch.numel() else None)
        err = self.fn(*head, num_tiles, n_pix, tile_x, tile_y, grid_x, chunk,
                      stream())
        if err:
            raise RuntimeError(f"render launch failed: {err}")
        return out


class Expand:
    """gsplat_expand_scan of one build: the single-pass kernel (a look-back
    state buffer, zeroed once, that holds the kernel's epoch) or the
    two-launch one of earlier revisions (a scratch of per-tile
    aggregates)."""

    def __init__(self, so):
        lib = ctypes.CDLL(so)
        self.fn = lib.gsplat_expand_scan
        self.fn.restype = I
        self.single = hasattr(lib, "gsplat_expand_scan_state_words")
        if self.single:
            self.words = lib.gsplat_expand_scan_state_words
            self.words.argtypes, self.words.restype = [LL], LL
            self.fn.argtypes = [P, P, LL, P, P, P, P, P]
            self.state = None
        else:
            self.tiles = lib.gsplat_expand_scan_tiles
            self.tiles.argtypes, self.tiles.restype = [LL], I
            self.fn.argtypes = [P, P, LL, P, P, P, P, P]

    def __call__(self, marks, base_in):
        import torch

        k = marks.shape[0]
        outs = [torch.empty_like(marks) for _ in range(3)]
        ptrs = [o.data_ptr() for o in outs]
        if self.single:
            words = self.words(k)
            if self.state is None or self.state.numel() < words:
                self.state = torch.zeros(words, dtype=torch.int64,
                                         device=marks.device)
            err = self.fn(marks.data_ptr(), base_in.data_ptr(), k,
                          self.state.data_ptr(), *ptrs, stream())
        else:
            agg = torch.empty(3 * self.tiles(k), dtype=torch.int32,
                              device=marks.device)
            err = self.fn(marks.data_ptr(), base_in.data_ptr(), k,
                          agg.data_ptr(), *ptrs, stream())
        if err:
            raise RuntimeError(f"expand_scan launch failed: {err}")
        return tuple(outs)


def passing_sub_block_share(feat, meta, visited, rkw):
    """Share of the (8 x 4 sub-block, slot) pairs of the visited chunks
    that hold a pixel passing 1/255 (the plain render's arithmetic): what
    a cull exact at sub-block granularity would keep. Needs tile sides
    that are multiples of 8 and 4."""
    import torch

    tx, ty, chunk = rkw["tile_x"], rkw["tile_y"], rkw["chunk"]
    sx, sy = 8, 4
    cidx = torch.cat(visited)
    tiles = (meta[cidx] >> 2).long()
    f = feat.float().reshape(9, -1, chunk)
    pix = torch.arange(tx * ty, device=feat.device)
    px, py = (pix % tx).float(), (pix // tx).float()
    held = 0
    for s in range(0, cidx.numel(), 64):
        c, t = cidx[s:s + 64], tiles[s:s + 64]
        fc = f[:, c]                                        # [9, A, C]
        xl = fc[0] - ((t % rkw["grid_x"]) * tx).float()[:, None]
        yl = fc[1] - ((t // rkw["grid_x"]) * ty).float()[:, None]
        dx = px - xl[..., None]
        dy = py - yl[..., None]
        a, b, cc, opa = (fc[i][..., None] for i in (2, 3, 4, 5))
        power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
        alpha = torch.clamp(opa * torch.exp(power), max=0.99)
        ok = (power <= 0) & (alpha >= 1.0 / 255.0)         # [A, C, n_pix]
        ok = ok.reshape(*ok.shape[:2], ty // sy, sy, tx // sx, sx)
        held += int(ok.any(dim=5).any(dim=3).sum())
    return held / (cidx.numel() * chunk * (tx // sx) * (ty // sy))


def pairs(specs):
    return dict(spec.split("=", 1) for spec in specs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--render", action="append", default=[],
                    metavar="NAME=PATH", help="another render source")
    ap.add_argument("--scan", action="append", default=[],
                    metavar="NAME=PATH", help="another scan source")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gsplat_tpu_torch.raster import rasterize as rast
    from gsplat_tpu_torch.raster import scan_kernel, tile_kernel
    from torch_blend_variants import build_all

    card_name = cs.card()
    renders = {"current": RENDER, **{n: RENDER for n in RENDER_ABLATIONS},
               **pairs(args.render)}
    scans = {"current": SCAN, **pairs(args.scan)}
    sources = {f"render_{n}": p for n, p in renders.items()}
    sources.update((f"scan_{n}", p) for n, p in scans.items())
    defines = {f"render_{n}": d for n, d in RENDER_ABLATIONS.items()}
    t0 = time.time()
    built = build_all(sources, defines, label=kernel_label)
    for name, (_, report) in built.items():
        cs.log("ptxas", card=card_name, variant=name, **report)
    cs.log("build", seconds=time.time() - t0)
    kernels = {
        "render": {n: Render(built[f"render_{n}"][0]) for n in renders},
        "expand_scan": {n: Expand(built[f"scan_{n}"][0]) for n in scans}}

    sv = cs.probe_serving(card_name)
    feat, meta, bg, rkw = cs.render_kwargs(sv["cap"]["render_forward"])
    bg = bg.float().contiguous()
    (marks, base_in), _ = sv["cap"]["expand_scan"]
    store = []
    with torch.no_grad(), cs.capture(rast, "tile_kernel", store,
                                     attr="render_forward"):
        for cam in sv["cams"]:
            sv["render_fns"]["expand"](cam)
    frames = [cs.render_kwargs(c) for c in store]
    with torch.no_grad():
        for cam, (f, m, _, kw) in enumerate(frames):
            stats = {}
            _, visits = tile_kernel.render_plain_with_visits(
                f, m, bg, **kw, stats=stats)
            cs.log("frame", card=card_name, kernel="render", camera=cam,
                   max_chunks_a_tile=int(visits.max()),
                   tiles_with_chunks=int((visits > 0).sum()),
                   passing_sub_block_share=passing_sub_block_share(
                       f, m, stats["visited"], kw),
                   **cs.render_bounds(f, m, kw, visits, stats))
        want = tile_kernel.render_forward_plain(feat, meta, bg, **rkw)
        calls = {"render": [lambda fn, f=f: fn(f[0], f[1], bg, **f[3])
                            for f in frames],
                 "expand_scan": [lambda fn: fn(marks, base_in)]}
        for name, fn in kernels["render"].items():
            cs.log("check", card=card_name, kernel="render", variant=name,
                   max_abs_err=cs.check_render(fn, feat, meta, bg, rkw,
                                               want))
        want = scan_kernel.expand_scan_plain(marks, base_in)
        for name, fn in kernels["expand_scan"].items():
            cs.log("check", card=card_name, kernel="expand_scan",
                   variant=name, max_abs_err=cs.check_expand(
                       fn, marks, base_in, want))
        for kernel, builds in kernels.items():
            order = list(builds) + list(builds)[::-1]
            # times[name][camera]: one time a turn
            times = {name: [[] for _ in calls[kernel]] for name in builds}
            for name in order:
                for cam, call in enumerate(calls[kernel]):
                    times[name][cam].append(cs.cuda_ms(
                        lambda: call(builds[name]), args.reps))
            for name, per_cam in times.items():
                means = [sum(ms) / len(ms) for ms in per_cam]
                cs.log("time", card=card_name, kernel=kernel, variant=name,
                       ms=per_cam[0], ms_mean=means[0],
                       ms_mean_by_camera=means,
                       ms_mean_all_cameras=sum(means) / len(means),
                       shape=(f"K={marks.shape[0]}" if kernel == "expand_scan"
                              else f"tiles={rkw['num_tiles']} "
                                   f"slots={feat.shape[1]}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
