"""Quaternion math (port of gsplat_tpu/core/quaternion.py).

Quaternion layout is (w, x, y, z). The rotation-vector helpers and
``rigid_deform`` belong to the SwinGS slice and are not ported yet.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unit-normalize with torch.nn.functional.normalize semantics: the
    squared norm is clamped at 1e-24, so zero vectors (padding rows) map to
    zero instead of NaN."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=1e-24))


def quat_to_rotmat(q: torch.Tensor, normalize_q: bool = True) -> torch.Tensor:
    """(w,x,y,z) quaternion(s) [..., 4] -> rotation matrices [..., 3, 3]."""
    if normalize_q:
        q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)
