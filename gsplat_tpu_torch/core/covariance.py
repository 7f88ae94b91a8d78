"""Gaussian covariance and EWA screen-space projection
(port of gsplat_tpu/core/covariance.py).

- scale + quaternion -> 3D covariance, Sigma = R S S R^T
  (reference cuda_rasterizer/forward.cu:118-152);
- EWA 2D projection with the 1.3*tan_fov frustum clamp and the +0.3
  low-pass on the diagonal (forward.cu:74-113);
- symmetric 3x3 <-> 6-vector packing in (xx, xy, xz, yy, yz, zz) order.

Written elementwise in the same operation order as the JAX module, so the
two agree to float32 rounding.
"""

from __future__ import annotations

import torch

from .quaternion import quat_to_rotmat


def unstrip_symmetric(v: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = (v[..., i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)


def covariance_6(scales: torch.Tensor, quats: torch.Tensor,
                 scale_modifier: float = 1.0) -> torch.Tensor:
    """Packed 6-vector covariance (the ``cov3d_precomp`` contract)."""
    R = quat_to_rotmat(quats)
    s2 = (scale_modifier * scales) ** 2

    def entry(i, l):
        return (R[..., i, 0] * R[..., l, 0] * s2[..., 0]
                + R[..., i, 1] * R[..., l, 1] * s2[..., 1]
                + R[..., i, 2] * R[..., l, 2] * s2[..., 2])

    return torch.stack([entry(0, 0), entry(0, 1), entry(0, 2),
                        entry(1, 1), entry(1, 2), entry(2, 2)], dim=-1)


def covariance_3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = L L^T, [..., 3, 3]."""
    return unstrip_symmetric(covariance_6(scales, quats, scale_modifier))


def project_cov2d(mean3d, cov3d_6, view, focal_x, focal_y, tan_fovx,
                  tan_fovy):
    """EWA projection of a 3D covariance to screen space.

    t = view @ mean with t.xy clamped so |t.x/t.z| <= 1.3 tan_fov; J the
    perspective Jacobian; cov2d = J W Sigma W^T J^T plus 0.3 on the
    diagonal. ``view`` is the [4, 4] world->camera matrix. Returns the
    (xx, xy, yy) entries, each [...]."""
    w = view[:3, :3]
    tx_ = (w[0, 0] * mean3d[..., 0] + w[0, 1] * mean3d[..., 1]
           + w[0, 2] * mean3d[..., 2] + view[0, 3])
    ty_ = (w[1, 0] * mean3d[..., 0] + w[1, 1] * mean3d[..., 1]
           + w[1, 2] * mean3d[..., 2] + view[1, 3])
    tz = (w[2, 0] * mean3d[..., 0] + w[2, 1] * mean3d[..., 1]
          + w[2, 2] * mean3d[..., 2] + view[2, 3])
    # z == 0 only for culled/padding rows; keep their values finite
    tz = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(tx_ / tz, -limx, limx) * tz
    ty = torch.clamp(ty_ / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    m0 = [j00 * w[0, k] + j02 * w[2, k] for k in range(3)]
    m1 = [j11 * w[1, k] + j12 * w[2, k] for k in range(3)]

    xx, xy, xz, yy, yz, zz = (cov3d_6[..., i] for i in range(6))

    def quad(u, v):
        return (u[0] * (xx * v[0] + xy * v[1] + xz * v[2])
                + u[1] * (xy * v[0] + yy * v[1] + yz * v[2])
                + u[2] * (xz * v[0] + yz * v[1] + zz * v[2]))

    a = quad(m0, m0) + 0.3
    b = quad(m0, m1)
    c = quad(m1, m1) + 0.3
    return a, b, c
