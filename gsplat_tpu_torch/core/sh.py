"""Real spherical-harmonics color evaluation (port of gsplat_tpu/core/sh.py).

Term-for-term the same as the JAX module (reference utils/sh_utils.py:57-118
and cuda_rasterizer/forward.cu:20-71), on torch tensors.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor,
            channel_minor: bool = False) -> torch.Tensor:
    """Evaluate SH at unit directions.

    ``sh`` is [..., C, (deg+1)**2], or [..., (deg+1)**2, C] when
    ``channel_minor`` (the reference's [P, M, 3] layout); ``dirs`` is
    [..., 3]. Returns [..., C]."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    if channel_minor:
        def s(i):
            return sh[..., i, :]
    else:
        def s(i):
            return sh[..., i]
    result = C0 * s(0)
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - C1 * y * s(1) + C1 * z * s(2) - C1 * x * s(3)
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * s(4)
                + C2[1] * yz * s(5)
                + C2[2] * (2.0 * zz - xx - yy) * s(6)
                + C2[3] * xz * s(7)
                + C2[4] * (xx - yy) * s(8)
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * s(9)
                    + C3[1] * xy * z * s(10)
                    + C3[2] * y * (4 * zz - xx - yy) * s(11)
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * s(12)
                    + C3[4] * x * (4 * zz - xx - yy) * s(13)
                    + C3[5] * z * (xx - yy) * s(14)
                    + C3[6] * x * (xx - 3 * yy) * s(15)
                )
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * s(16)
                        + C4[1] * yz * (3 * xx - yy) * s(17)
                        + C4[2] * xy * (7 * zz - 1) * s(18)
                        + C4[3] * yz * (7 * zz - 3) * s(19)
                        + C4[4] * (zz * (35 * zz - 30) + 3) * s(20)
                        + C4[5] * xz * (7 * zz - 3) * s(21)
                        + C4[6] * (xx - yy) * (7 * zz - 1) * s(22)
                        + C4[7] * xz * (xx - 3 * yy) * s(23)
                        + C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
                        * s(24)
                    )
    return result


def sh_to_rgb(deg: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """View-dependent color as the kernel computes it: direction from the
    camera to each mean, +0.5 shift, clamp at 0.

    ``sh`` is [..., K, 3] (coefficient, channel), ``means`` [..., 3],
    ``campos`` [3]. Returns rgb [..., 3]."""
    d = means - campos
    n2 = torch.sum(d * d, dim=-1, keepdim=True)
    d = d / torch.sqrt(torch.clamp(n2, min=1e-24))
    rgb = eval_sh(deg, sh, d, channel_minor=True) + 0.5
    return torch.clamp(rgb, min=0.0)


def rgb_to_sh(rgb):
    """Invert the DC band (utils/sh_utils.py:114-115)."""
    return (rgb - 0.5) / C0


def sh_to_rgb_dc(sh):
    """DC band to RGB (utils/sh_utils.py:117-118)."""
    return sh * C0 + 0.5
