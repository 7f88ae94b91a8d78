#!/usr/bin/env python3
"""Time versions of the training blend kernels, and of the training step's
two scan kernels, side by side on the main path's inputs (one NVIDIA GPU).

Run from the root of a checkout:

    python3 scripts/torch_blend_variants.py [--source NAME=PATH.cu ...]
                                            [--scan NAME=PATH.cu ...]

It builds ``gsplat_tpu_torch/csrc/blend_kernels.cu`` (as ``current``) and
every ``--source``, a file with the same C entry points (an earlier
version of the source, or an ablation of it), each with nvcc and
``raster/cuda_ext.py``'s flags (``csrc/`` on the include path) into a
shared library called through its plain C interface (ctypes);
``-Xptxas=-v`` reports each build's registers, spills and shared memory.
``scripts/torch_serve_variants.py`` does the same for the serving
kernels. It then records the blend inputs of
the first training step of chip_smoke.py's three training settings
(100k-800x800, 1m-1296x840, swin-200k-1280x720) through chip_smoke.py's
own setup, holds every build against the plain versions with
``chip_smoke.check_blend``, and times the builds with
``chip_smoke.cuda_ms`` in turns, in order and then in reverse order. One
JSON line a measurement.

With ``--scan`` it also builds ``csrc/scan_kernels.cu`` (as ``current``)
and each given scan source (an earlier revision's two-launch multi_cumsum
is called through its own signature), records the serving merge frame's
``merge_expand`` inputs too (chip_smoke.probe_serving, camera 0), and
holds each build's ``merge_expand`` (bit-equal to plain, two launches
bit-equal) and ``multi_cumsum`` (within 2e-3 + 1e-5 |x| of a float64
cumsum, two launches bit-equal) on those inputs and on the training
steps' (merge_expand in all three settings, multi_cumsum at 1M and swin),
then times them in turns the same way, with each kernel's device time
(torch.profiler) beside the CUDA-event time of a call, and builds the
ablations of the checkout's source listed in SCAN_ABLATIONS.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "gsplat_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "blend_kernels.cu")
WORK = os.path.join(ROOT, "build", "blend_variants")
# gsplat_blend_forward / gsplat_blend_backward: feat, k_slots, chunk_meta,
# n_chunks, two output or input pointers, six ints, the stream
ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])


def build_all(sources, defines=None, label=None):
    """{name: (.so path, ptxas report)}; one nvcc a source, in parallel,
    with csrc/ on the include path (tile_common.cuh) and ``defines[name]``
    (extra flags, e.g. -DNAME=VALUE) where given; ``label`` names the
    kernels in the report (see ptxas_report)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from gsplat_tpu_torch.raster import cuda_ext

    os.makedirs(WORK, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        so = os.path.join(WORK, f"lib{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *cuda_ext.CUDA_FLAGS,
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
               "-I", CSRC, *(defines or {}).get(name, ()), "-o", so, path]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {text[-3000:]}")
        built[name] = (so, ptxas_report(text, label or blend_label))
    return built


def blend_label(entry):
    """forward / backward for the blend kernels' entry functions (with
    "_split" for the instantiation that runs pixel groups and chunk
    pieces, template argument true: Lb1E in the mangled name)."""
    return (("forward" if "forward" in entry else "backward")
            + ("_split" if "Lb1E" in entry else ""))


def ptxas_report(text, label):
    """{label(kernel): {registers, spill_stores, spill_loads, smem_bytes}}
    from nvcc's -Xptxas=-v output; kernels whose label is None are left
    out."""
    out, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = label(m.group(1))
            if kernel:
                out[kernel] = {}
        elif kernel:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[kernel]["spill_stores"] = int(m.group(1))
                out[kernel]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[kernel]["registers"] = int(m.group(1))
                s = re.search(r"(\d+) bytes smem", line)
                out[kernel]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


# ablations of the checkout's scan_kernels.cu: merge_expand with 8 items a
# thread (the source: 4); multi_cumsum tiles of 4,096 and 8,192 elements
# (the source: 16,384, 512 threads x 32), and no look-back (a wrong
# result, not checked: the kernel's streaming alone)
SCAN_ABLATIONS = {"merge_items8": ["-DMERGE_ITEMS=8"],
                  "cumsum_tile4096": ["-DCUMSUM_THREADS=256",
                                      "-DCUMSUM_ITEMS=16"],
                  "cumsum_tile8192": ["-DCUMSUM_THREADS=256"],
                  "cumsum_no_lookback": ["-DCUMSUM_LOOKBACK=0"]}
SCAN_UNCHECKED = {("multi_cumsum", "cumsum_no_lookback")}
# kernel entry functions a scan's device time sums (either revision)
SCAN_KERNELS = {"merge_expand": ("merge_expand_kernel",),
                "multi_cumsum": ("multi_cumsum_kernel", "cumsum_reduce_kernel",
                                 "cumsum_scan_kernel")}


def device_ms(fn, reps, names):
    """Mean device milliseconds a call of ``fn`` spends in kernels whose
    name holds one of ``names`` (torch.profiler's CUDA activity): the
    kernels alone, without the host time of the call, which bounds event
    times of a few microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if any(n in e.key for n in names))
    return total / 1e3 / reps


def scan_label(entry):
    """The report's name of a scan kernel entry function, or None."""
    for name in ("merge_expand_kernel", "multi_cumsum_kernel",
                 "cumsum_reduce_kernel", "cumsum_scan_kernel"):
        if name in entry:
            return name
    return None


class Scan:
    """One build's merge_expand and multi_cumsum, with the wrappers'
    signatures, on PyTorch's current stream: multi_cumsum single-pass (a
    look-back state buffer and an epoch a call) or the two launches of
    earlier revisions (a scratch of block totals)."""

    def __init__(self, so):
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib = ctypes.CDLL(so)
        self.merge = lib.gsplat_merge_expand
        self.merge.argtypes = [P, P, I, I, P, P, P, P]
        self.cumsum = lib.gsplat_multi_cumsum
        self.merge.restype = self.cumsum.restype = I
        self.single = hasattr(lib, "gsplat_multi_cumsum_state_words")
        if self.single:
            self.words = lib.gsplat_multi_cumsum_state_words
            self.words.argtypes, self.words.restype = [I, LL], LL
            self.cumsum.argtypes = [P, I, LL, P, ctypes.c_ulonglong, P, P]
            self.state, self.epoch = None, 0
        else:
            self.blocks = lib.gsplat_cumsum_blocks
            self.blocks.argtypes, self.blocks.restype = [LL], I
            self.cumsum.argtypes = [P, I, LL, P, P, P]

    @staticmethod
    def _stream():
        import torch

        return torch.cuda.current_stream().cuda_stream

    def merge_expand(self, starts, pack, k):
        import torch

        outs = [torch.empty(k, dtype=torch.int32, device=starts.device)
                for _ in range(3)]
        err = self.merge(starts.data_ptr(), pack.data_ptr(),
                         starts.shape[0], k,
                         *[o.data_ptr() for o in outs], self._stream())
        if err:
            raise RuntimeError(f"merge_expand launch failed: {err}")
        return tuple(outs)

    def multi_cumsum(self, x):
        import torch

        n, k = x.shape
        out = torch.empty_like(x)
        if self.single:
            words = self.words(n, k)
            if self.state is None or self.state.numel() < words:
                self.state = torch.zeros(words, dtype=torch.int64,
                                         device=x.device)
                self.epoch = 0
            self.epoch += 1
            err = self.cumsum(x.data_ptr(), n, k, self.state.data_ptr(),
                              self.epoch, out.data_ptr(), self._stream())
        else:
            totals = torch.empty(n * self.blocks(k), dtype=torch.float32,
                                 device=x.device)
            err = self.cumsum(x.data_ptr(), n, k, totals.data_ptr(),
                              out.data_ptr(), self._stream())
        if err:
            raise RuntimeError(f"multi_cumsum launch failed: {err}")
        return out


def check_scan(kernel, fn, args, want):
    """One build's scan against the plain or float64 result ``want``:
    merge_expand bit-equal, multi_cumsum within 2e-3 + 1e-5 |x|; two
    launches bit-equal. Returns the max abs error."""
    import torch

    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if kernel == "merge_expand":
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("merge_expand differs from plain")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError("two merge_expand launches differ")
        return 0.0
    err = (got.double() - want).abs()
    if bool((err > 2e-3 + 1e-5 * want.abs()).any()):
        raise AssertionError(f"multi_cumsum vs float64: {float(err.max())}")
    if not torch.equal(got, again):
        raise AssertionError("two multi_cumsum launches differ")
    return float(err.max())


def scan_inputs(card_name, caps):
    """{(kernel, setting): args} of merge_expand and multi_cumsum from the
    training steps' records and the serving merge frame's (camera 0)."""
    import chip_smoke as cs

    out = {}
    for name, cap in caps.items():
        out[("merge_expand", name)] = cap["merge_expand"]
        if "multi_cumsum" in cap:
            out[("multi_cumsum", name)] = (cap["multi_cumsum"][0].detach(),)
    sv = cs.probe_serving(card_name)
    (starts, pack, k), _ = sv["cap"]["merge_expand"]
    out[("merge_expand", "serve-merge")] = (starts, pack, k)
    return out


def time_scans(card_name, scans, inputs, reps):
    """Check and time every scan build on every input, in turns: CUDA
    events around ``reps`` calls, then (after every event time: a profiler
    session slows the host for the rest of the process) each kernel's
    device time."""
    import torch

    import chip_smoke as cs
    from gsplat_tpu_torch.raster import scan_kernel

    order = list(scans) + list(scans)[::-1]
    lines = []
    for (kernel, setting), args in inputs.items():
        if kernel == "merge_expand":
            want = scan_kernel.merge_expand_plain(*args)
            yard = cs.searchsorted_ms(args[0], args[2])
            shape = f"P={args[0].shape[0]} K={args[2]}"
        else:
            want = torch.cumsum(args[0].double(), dim=1)
            yard = cs.cuda_ms(lambda: torch.cumsum(args[0], dim=1), reps)
            shape = f"n={args[0].shape[0]} K={args[0].shape[1]}"
        for name, sc in scans.items():
            if (kernel, name) not in SCAN_UNCHECKED:
                cs.log("check", card=card_name, kernel=kernel,
                       setting=setting, variant=name, max_abs_err=check_scan(
                           kernel, getattr(sc, kernel), args, want))
        times = {name: [] for name in scans}
        for name in order:
            fn = getattr(scans[name], kernel)
            times[name].append(cs.cuda_ms(lambda: fn(*args), reps))
        lines += [dict(kernel=kernel, setting=setting, variant=name, ms=ms,
                       ms_mean=sum(ms) / len(ms), yardstick_ms=yard,
                       shape=shape) for name, ms in times.items()]
    for line in lines:
        args = inputs[(line["kernel"], line["setting"])]
        fn = getattr(scans[line["variant"]], line["kernel"])
        cs.log("time", card=card_name, **line,
               device_ms=device_ms(lambda: fn(*args), reps,
                                   SCAN_KERNELS[line["kernel"]]))


class Blend:
    """One build's two entry points, with the wrappers' signatures, on
    PyTorch's current stream."""

    def __init__(self, so):
        lib = ctypes.CDLL(so)
        self.fwd = lib.gsplat_blend_forward
        self.bwd = lib.gsplat_blend_backward
        self.fwd.argtypes = self.bwd.argtypes = ARGS
        self.fwd.restype = self.bwd.restype = ctypes.c_int

    def _launch(self, fn, feat, meta, a, b, num_tiles, n_pix, tile_x, tile_y,
                grid_x, chunk):
        import torch

        err = fn(feat.data_ptr(), feat.shape[1], meta.data_ptr(),
                 meta.numel(), a.data_ptr(), b.data_ptr(), num_tiles, n_pix,
                 tile_x, tile_y, grid_x, chunk,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"blend launch failed: {err}")

    def forward(self, feat, meta, **kw):
        import torch

        ct = torch.empty(kw["num_tiles"], 4, kw["n_pix"],
                         dtype=torch.float32, device=feat.device)
        used = torch.zeros(feat.shape[1], dtype=torch.int32,
                           device=feat.device)
        self._launch(self.fwd, feat, meta, ct, used, **kw)
        return ct, used

    def backward(self, feat, meta, dpack, **kw):
        import torch

        dfeat = torch.zeros_like(feat)
        self._launch(self.bwd, feat, meta, dpack, dfeat, **kw)
        return dfeat


def capture_inputs(card_name):
    """({setting: (feat, meta, dpack, kw)}, the raw records) of each
    setting's first step, recorded as chip_smoke.py records them."""
    import chip_smoke as cs

    setups, rng = cs.build_training(card_name)
    caps = cs.capture_training(setups, card_name)
    swin = cs.build_swin(rng, setups["100k-800x800"]["settings"].k_dup,
                         card_name)
    caps[cs.SWIN_NAME] = cs.capture_swin(swin)
    out = {}
    for name, cap in caps.items():
        feat, meta, kw = cs.blend_kwargs(cap["blend_forward"])
        out[name] = (feat, meta, cap["blend_backward"][2].detach(), kw)
    return out, caps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another source to build and "
                    "time beside the checkout's")
    ap.add_argument("--scan", action="append", default=[],
                    metavar="NAME=PATH", help="time the scan kernels too: "
                    "another scan source to build beside the checkout's")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gsplat_tpu_torch.raster import tile_kernel

    card_name = cs.card()
    sources = {"current": SOURCE}
    sources.update(spec.split("=", 1) for spec in args.source)
    scan_sources, scan_defines = {}, {}
    if args.scan:
        scan_src = os.path.join(CSRC, "scan_kernels.cu")
        scan_sources = {"current": scan_src,
                        **{n: scan_src for n in SCAN_ABLATIONS}}
        scan_sources.update(spec.split("=", 1) for spec in args.scan)
        scan_defines = {f"scan_{n}": d for n, d in SCAN_ABLATIONS.items()}
    t0 = time.time()
    built = build_all(sources)
    for name, (_, report) in built.items():
        cs.log("ptxas", card=card_name, variant=name, **report)
    built_scans = {}
    if scan_sources:
        built_scans = build_all({f"scan_{n}": p
                                 for n, p in scan_sources.items()},
                                scan_defines, label=scan_label)
        for name, (_, report) in built_scans.items():
            cs.log("ptxas", card=card_name, variant=name, **report)
    cs.log("build", seconds=time.time() - t0)
    blends = {name: Blend(so) for name, (so, _) in built.items()}
    order = list(blends) + list(blends)[::-1]
    # a training step: not in no_grad
    inputs, caps = capture_inputs(card_name)
    scan_in = scan_inputs(card_name, caps) if built_scans else {}
    with torch.no_grad():
        for setting, (feat, meta, dpack, kw) in inputs.items():
            want = (*tile_kernel.tile_blend_forward_plain(feat, meta, **kw),
                    tile_kernel.tile_blend_backward_plain(feat, meta, dpack,
                                                          **kw))
            for name, bl in blends.items():
                errs = cs.check_blend(f"{setting} {name}", bl.forward,
                                      bl.backward, feat, meta, dpack, kw,
                                      want)
                cs.log("check", card=card_name, setting=setting,
                       variant=name, **errs)
            times = {name: ([], []) for name in blends}
            for name in order:
                bl = blends[name]
                times[name][0].append(cs.cuda_ms(
                    lambda: bl.forward(feat, meta, **kw), args.reps))
                times[name][1].append(cs.cuda_ms(
                    lambda: bl.backward(feat, meta, dpack, **kw), args.reps))
            for name, (fwd, bwd) in times.items():
                cs.log("time", card=card_name, setting=setting, variant=name,
                       tiles=kw["num_tiles"], slots=feat.shape[1],
                       forward_ms=fwd, backward_ms=bwd,
                       forward_ms_mean=sum(fwd) / 2,
                       backward_ms_mean=sum(bwd) / 2)
    if built_scans:   # last: it profiles
        scans = {name[len("scan_"):]: Scan(so)
                 for name, (so, _) in built_scans.items()}
        with torch.no_grad():
            time_scans(card_name, scans, scan_in, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
