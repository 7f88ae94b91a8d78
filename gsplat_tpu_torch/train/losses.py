"""Image losses: L1, windowed SSIM, PSNR (port of
gsplat_tpu/train/losses.py).

- ``l1_loss`` (reference utils/loss_utils.py:21-25);
- ``ssim``: 11x11 Gaussian window, sigma 1.5, zero 'same' padding,
  C1 = 0.01^2, C2 = 0.03^2 (utils/loss_utils.py:27-67), written as the
  JAX module's separable shifted adds and not as a convolution, so no
  cuDNN TF32 default enters;
- ``psnr`` (utils/image_utils.py:14-19), with the trainer's
  mean-of-per-channel-PSNR quirk behind ``channel_axis``;
- ``build_neighbor`` / ``arap_loss``: the as-rigid-as-possible
  regulariser over a k-NN graph (utils/loss_utils.py:71-117).

Images are [H, W, C] or channel-first [3, H, W].
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def psnr(pred, gt, channel_axis: int | None = None):
    """20 log10(1 / sqrt(mse)). The reference trainer calls it on
    [3, H, W] images and so reports the MEAN OF PER-CHANNEL PSNRs
    (train_static.py:197); pass ``channel_axis`` for that. The default is
    whole-image PSNR (the metrics.py call site)."""
    if channel_axis is None:
        m = torch.mean((pred - gt) ** 2)
        return 20.0 * torch.log10(1.0 / torch.sqrt(m))
    ax = channel_axis % pred.dim()
    dims = tuple(a for a in range(pred.dim()) if a != ax)
    m = torch.mean((pred - gt) ** 2, dim=dims)
    return torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(m)))


@functools.lru_cache()
def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
                  for x in range(window_size)], np.float32)
    return g / g.sum()


def _blur_axis(img, g: np.ndarray, dim: int):
    """1-D filter along ``dim`` with zero 'same' padding, by shifted adds
    in tap order."""
    window = g.shape[0]
    pad = window // 2
    n = img.shape[dim]
    shape = list(img.shape)
    shape[dim] = pad
    zeros = torch.zeros(shape, dtype=img.dtype, device=img.device)
    padded = torch.cat([zeros, img, zeros], dim=dim)
    out = None
    for t in range(window):
        term = float(g[t]) * padded.narrow(dim, t, n)
        out = term if out is None else out + term
    return out


def _filter2d(img, window_size: int, dims=(0, 1)):
    """Separable 2-D Gaussian filter (the window is an outer product of the
    normalised 1-D Gaussian, loss_utils.py:31-34)."""
    g = _gaussian_1d(window_size)
    return _blur_axis(_blur_axis(img, g, dims[0]), g, dims[1])


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM over the image, the reference's windowing."""
    chw = img1.dim() == 3 and img1.shape[0] == 3 and img1.shape[-1] != 3
    dims = (1, 2) if chw else (0, 1)
    f = functools.partial(_filter2d, window_size=window_size, dims=dims)
    mu1 = f(img1)
    mu2 = f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f(img1 * img1) - mu1_sq
    sigma2_sq = f(img2 * img2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def build_neighbor(xyz, num_knn: int = 20, weight_coef: float = 2000.0):
    """The k-NN graph for ARAP (reference build_neighbor,
    loss_utils.py:83-101; the KDTree replaced by an exact blocked k-NN)."""
    from gsplat_tpu_torch.model.knn import knn_indices

    sq_dists, indices = knn_indices(xyz, k=num_knn)
    return {"indices": indices, "dist": sq_dists,
            "weight": torch.exp(-weight_coef * sq_dists)}


def arap_loss(xyz, paras, indices, weight_coef: float = 2000.0):
    """As-rigid-as-possible smoothness over a k-NN graph
    (utils/loss_utils.py:103-117): per parameter field p, the mean over
    points of sum over edges of exp(-coef |dx|^2) |dp|^2. Returns
    [len(paras)] penalties."""
    sq_dist = torch.sum((xyz[indices] - xyz[:, None]) ** 2, dim=-1)
    weight = torch.exp(-weight_coef * sq_dist)
    pens = [torch.mean(torch.sum(
        weight * torch.sum((p[indices] - p[:, None]) ** 2, dim=-1), dim=-1))
        for p in paras]
    return torch.stack(pens)
