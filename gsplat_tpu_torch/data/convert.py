"""COLMAP preprocessing wrapper (port of gsplat_tpu/data/convert.py, the
reference convert.py:1-124).

Runs feature extraction / matching / mapping / undistortion on a directory
of input images, producing the sparse/0 layout the Colmap reader expects,
plus optional 2x/4x/8x downscales. Requires the ``colmap`` (and optionally
ImageMagick ``magick``/``convert``) binaries on PATH — exactly like the
reference; fails with a clear message otherwise.

Usage: python -m gsplat_tpu_torch.data.convert -s <dir with input/ images>
       [--no_gpu] [--skip_matching] [--resize] [--camera OPENCV]
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import subprocess
import sys


def _run(cmd: str) -> None:
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        logging.error("command failed (%d): %s", code, cmd)
        sys.exit(code)


def convert(source_path: str, camera: str = "OPENCV", colmap_cmd="colmap",
            magick_cmd="magick", use_gpu=True, skip_matching=False,
            resize=False):
    if shutil.which(colmap_cmd.split()[0]) is None:
        sys.exit(f"'{colmap_cmd}' not found on PATH — install COLMAP or "
                 "preprocess the dataset elsewhere.")
    gpu = 1 if use_gpu else 0
    if not skip_matching:
        os.makedirs(source_path + "/distorted/sparse", exist_ok=True)
        _run(f"{colmap_cmd} feature_extractor "
             f"--database_path {source_path}/distorted/database.db "
             f"--image_path {source_path}/input "
             f"--ImageReader.single_camera 1 "
             f"--ImageReader.camera_model {camera} "
             f"--SiftExtraction.use_gpu {gpu}")
        _run(f"{colmap_cmd} exhaustive_matcher "
             f"--database_path {source_path}/distorted/database.db "
             f"--SiftMatching.use_gpu {gpu}")
        _run(f"{colmap_cmd} mapper "
             f"--database_path {source_path}/distorted/database.db "
             f"--image_path {source_path}/input "
             f"--output_path {source_path}/distorted/sparse "
             f"--Mapper.ba_global_function_tolerance=0.000001")
    _run(f"{colmap_cmd} image_undistorter "
         f"--image_path {source_path}/input "
         f"--input_path {source_path}/distorted/sparse/0 "
         f"--output_path {source_path} --output_type COLMAP")

    # move sparse/* under sparse/0 (reference convert.py:70-80)
    sparse = os.path.join(source_path, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if resize:
        for scale, name in [(50, "images_2"), (25, "images_4"),
                            (12.5, "images_8")]:
            dst = os.path.join(source_path, name)
            os.makedirs(dst, exist_ok=True)
            for f in os.listdir(os.path.join(source_path, "images")):
                src = os.path.join(source_path, "images", f)
                shutil.copy2(src, os.path.join(dst, f))
                _run(f"{magick_cmd} mogrify -resize {scale}% "
                     f"{os.path.join(dst, f)}")
    print("Done.")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)
    convert(args.source_path, camera=args.camera,
            colmap_cmd=(f'"{args.colmap_executable}"'
                        if args.colmap_executable else "colmap"),
            magick_cmd=(f'"{args.magick_executable}"'
                        if args.magick_executable else "magick"),
            use_gpu=not args.no_gpu, skip_matching=args.skip_matching,
            resize=args.resize)


if __name__ == "__main__":
    main()
