#!/usr/bin/env python3
"""Time versions of the training blend kernels side by side on the main
path's inputs (one NVIDIA GPU).

Run from the root of a checkout:

    python3 scripts/torch_blend_variants.py [--source NAME=PATH.cu ...]

It builds ``gsplat_tpu_torch/csrc/blend_kernels.cu`` (as ``current``) and
every ``--source``, a file with the same C entry points (an earlier
version of the source, or an ablation of it), each with nvcc and
``raster/cuda_ext.py``'s flags into a shared library called through its
plain C interface (ctypes); ``-Xptxas=-v`` reports each build's
registers, spills and shared memory. It then records the blend inputs of
the first training step of chip_smoke.py's three training settings
(100k-800x800, 1m-1296x840, swin-200k-1280x720) through chip_smoke.py's
own setup, holds every build against the plain versions with
``chip_smoke.check_blend``, and times the builds with
``chip_smoke.cuda_ms`` in turns, in order and then in reverse order. One
JSON line a measurement.
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
SOURCE = os.path.join(ROOT, "gsplat_tpu_torch", "csrc", "blend_kernels.cu")
WORK = os.path.join(ROOT, "build", "blend_variants")
# gsplat_blend_forward / gsplat_blend_backward: feat, k_slots, chunk_meta,
# n_chunks, two output or input pointers, six ints, the stream
ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])


def build_all(sources):
    """{name: (.so path, ptxas report)}; one nvcc a source, in parallel."""
    from torch.utils.cpp_extension import CUDA_HOME

    from gsplat_tpu_torch.raster import cuda_ext

    os.makedirs(WORK, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        so = os.path.join(WORK, f"lib{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *cuda_ext.CUDA_FLAGS,
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
               "-o", so, path]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {text[-3000:]}")
        built[name] = (so, ptxas_report(text))
    return built


def ptxas_report(text):
    """{forward|backward: {registers, spill_stores, spill_loads,
    smem_bytes}} from nvcc's -Xptxas=-v output."""
    out, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = "forward" if "forward" in m.group(1) else "backward"
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
    """{setting: (feat, meta, dpack, kw)} of each setting's first step,
    recorded as chip_smoke.py records them."""
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
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another source to build and "
                    "time beside the checkout's")
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
    t0 = time.time()
    built = build_all(sources)
    for name, (_, report) in built.items():
        cs.log("ptxas", card=card_name, variant=name, **report)
    cs.log("build", seconds=time.time() - t0)
    blends = {name: Blend(so) for name, (so, _) in built.items()}
    order = list(blends) + list(blends)[::-1]
    inputs = capture_inputs(card_name)   # a training step: not in no_grad
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
