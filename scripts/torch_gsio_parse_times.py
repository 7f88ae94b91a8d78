#!/usr/bin/env python3
"""Time gsplat_tpu_torch's COLMAP parsers, numpy against native (gsio), on a
synthetic sparse model of MipNeRF-360 size (host only, no GPU needed).

Run from the root of a checkout:

    python3 scripts/torch_gsio_parse_times.py [--points 300000]
                                              [--images 194] [--reps 3]

It writes a binary ``points3D.bin`` (``--points`` points, each with a
track of 2 + Poisson(4) observations) and ``images.bin`` (``--images``
images sharing those observations as 2D points) under
``build/gsio_parse_times/``, checks that the two parsers give the same
arrays, and prints one JSON line: the best of ``--reps`` wall seconds of
each parse (points3D from its bytes, images.bin from its path, as
``data/colmap.py`` calls them), the file sizes and the host's CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gsplat_tpu_torch.data import colmap  # noqa: E402
from gsplat_tpu_torch.native import gsio  # noqa: E402

HEAD = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                 ("err", "<f8"), ("tlen", "<u8")])   # 51 bytes, packed


def points3d_bytes(rng, n, n_images):
    """A points3D.bin of ``n`` points; returns (bytes, track lengths)."""
    tlen = 2 + rng.poisson(4, n)
    head = np.zeros(n, HEAD)
    head["id"] = np.arange(1, n + 1)
    head["xyz"] = rng.normal(0, 3, (n, 3))
    head["rgb"] = rng.integers(0, 256, (n, 3))
    head["err"] = rng.uniform(0, 2, n)
    head["tlen"] = tlen
    size = HEAD.itemsize + 8 * tlen
    start = 8 + np.concatenate([[0], np.cumsum(size)[:-1]])
    out = np.zeros(8 + int(size.sum()), np.uint8)
    out[:8] = np.array([n], "<u8").view(np.uint8)
    out[(start[:, None] + np.arange(HEAD.itemsize)).ravel()] = (
        head.view(np.uint8))
    track = np.stack([rng.integers(1, n_images + 1, int(tlen.sum())),
                      rng.integers(0, 10_000, int(tlen.sum()))],
                     axis=1).astype("<i4").view(np.uint8).ravel()
    nb = 8 * tlen
    first = np.repeat(start + HEAD.itemsize, nb)
    within = np.arange(nb.sum()) - np.repeat(np.cumsum(nb) - nb, nb)
    out[first + within] = track
    return out.tobytes(), tlen


def images_bytes(rng, n_images, n_obs):
    """An images.bin of ``n_images`` images sharing ``n_obs`` 2D points."""
    per = np.full(n_images, n_obs // n_images)
    per[: n_obs % n_images] += 1
    parts = [np.array([n_images], "<u8").tobytes()]
    for i in range(n_images):
        q = rng.normal(size=4)
        parts += [np.array([i + 1], "<i4").tobytes(),
                  (q / np.linalg.norm(q)).astype("<f8").tobytes(),
                  rng.normal(size=3).astype("<f8").tobytes(),
                  np.array([1], "<i4").tobytes(),
                  f"_DSC{8679 + i:04d}.JPG".encode() + b"\x00",
                  np.array([per[i]], "<u8").tobytes(),
                  rng.uniform(0, 4000, (per[i], 3)).astype("<f8").tobytes()]
    return b"".join(parts)


def best_s(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def cpu_name():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=300_000)
    ap.add_argument("--images", type=int, default=194)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if gsio.get_lib() is None:
        print("gsio did not build (no make or C++ compiler)", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    work = os.path.join(ROOT, "build", "gsio_parse_times")
    os.makedirs(work, exist_ok=True)
    pts, tlen = points3d_bytes(rng, args.points, args.images)
    ims_path = os.path.join(work, "images.bin")
    with open(ims_path, "wb") as f:
        f.write(images_bytes(rng, args.images, int(tlen.sum())))
    with open(os.path.join(work, "points3D.bin"), "wb") as f:
        f.write(pts)

    # the same arrays from both parsers
    for a, b in zip(colmap.parse_points3d_numpy(pts),
                    gsio.parse_points3d(pts)):
        if not np.array_equal(a, b):
            raise AssertionError("points3D: native and numpy parses differ")
    want = colmap.read_images_binary_numpy(ims_path)
    got = colmap.read_images_binary(ims_path)
    for k, im in want.items():
        if not (np.array_equal(im.qvec, got[k].qvec)
                and np.array_equal(im.tvec, got[k].tvec)
                and im.name == got[k].name
                and im.camera_id == got[k].camera_id):
            raise AssertionError("images.bin: native and numpy parses differ")

    print(json.dumps(dict(
        cpu=cpu_name(), cpus=os.cpu_count(), points=args.points,
        observations=int(tlen.sum()), images=args.images,
        points3d_bytes=len(pts), images_bytes=os.path.getsize(ims_path),
        points3d_numpy_s=best_s(lambda: colmap.parse_points3d_numpy(pts),
                                args.reps),
        points3d_native_s=best_s(lambda: gsio.parse_points3d(pts),
                                 args.reps),
        images_numpy_s=best_s(
            lambda: colmap.read_images_binary_numpy(ims_path), args.reps),
        images_native_s=best_s(lambda: colmap.read_images_binary(ims_path),
                               args.reps),
        reps=args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
