"""Evaluation metrics over rendered image trees (port of
gsplat_tpu/eval/metrics.py).

Parity with the reference metrics.py:36-103: walks
{model}/test/ours_*/[renders|gt], computes per-view SSIM / PSNR / LPIPS
(vgg by default) on the device with the port's ``train/losses.ssim`` /
``psnr`` and ``eval/lpips.py``, and writes results.json + per_view.json
with the same schema. LPIPS is null, with an ``LPIPS_note``, when no
weights are available (see gsplat_tpu_torch.eval.lpips);
``--require_lpips`` exits instead.

Usage: python -m gsplat_tpu_torch.eval.metrics -m <model_path> [...]
       [--data_device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.eval.lpips import LPIPSUnavailable, lpips
from gsplat_tpu_torch.train import losses


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32) / 255.0


@torch.no_grad()
def evaluate_dir(renders_dir: str, gt_dir: str, lpips_net: str = "vgg",
                 require_lpips: bool = False, device="cuda"):
    device = get_device(device)
    names = sorted(os.listdir(renders_dir))
    ssims, psnrs, lpipss = [], [], []
    lpips_ok = True
    for name in names:
        render = torch.as_tensor(read_image(os.path.join(renders_dir, name)),
                                 device=device)
        gt = torch.as_tensor(read_image(os.path.join(gt_dir, name)),
                             device=device)
        ssims.append(float(losses.ssim(render, gt)))
        psnrs.append(float(losses.psnr(render, gt)))
        if lpips_ok:
            try:
                lpipss.append(float(lpips(render, gt, net=lpips_net)))
            except LPIPSUnavailable as e:
                if require_lpips:
                    # fail loudly when the caller demanded LPIPS, instead
                    # of degrading to null
                    raise SystemExit(
                        f"--require_lpips set but LPIPS is unavailable: {e}")
                lpips_ok = False
    return names, ssims, psnrs, (lpipss if lpips_ok else None)


def evaluate(model_paths, lpips_net: str = "vgg",
             require_lpips: bool = False, device="cuda"):
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict, per_view_dict = {}, {}
        test_dir = os.path.join(scene_dir, "test")
        try:
            methods = sorted(os.listdir(test_dir))
        except FileNotFoundError:
            print("  no test renders found — run gsplat_tpu_torch.eval.render "
                  "first")
            continue
        for method in methods:
            print("Method:", method)
            method_dir = os.path.join(test_dir, method)
            names, ssims, psnrs, lpipss = evaluate_dir(
                os.path.join(method_dir, "renders"),
                os.path.join(method_dir, "gt"),
                lpips_net=lpips_net, require_lpips=require_lpips,
                device=device)
            print(f"  SSIM : {np.mean(ssims):>12.7f}")
            print(f"  PSNR : {np.mean(psnrs):>12.7f}")
            if lpipss is not None:
                print(f"  LPIPS: {np.mean(lpipss):>12.7f}")
            else:
                print("  LPIPS: (weights unavailable)")
            full_dict[method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": float(np.mean(lpipss)) if lpipss else None,
            }
            if lpipss is None:
                # null means "metric unavailable here", never "zero"
                full_dict[method]["LPIPS_note"] = (
                    "unavailable: true LPIPS-v0.1 linear-head weights not "
                    "present (zero-egress environment); see "
                    "gsplat_tpu_torch/eval/lpips.py for the export recipe")
            per_view_dict[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)) if lpipss else None,
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict, f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict, f, indent=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--lpips_net", default="vgg",
                        choices=["vgg", "alex", "squeeze"])
    parser.add_argument("--require_lpips", action="store_true",
                        help="fail (exit non-zero) if LPIPS weights are "
                        "unavailable instead of reporting null")
    parser.add_argument("--data_device", default="cuda")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, lpips_net=args.lpips_net,
             require_lpips=args.require_lpips, device=args.data_device)


if __name__ == "__main__":
    main()
