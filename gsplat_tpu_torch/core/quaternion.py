"""Quaternion / rotation-vector math and the rigid temporal deformation
model (port of gsplat_tpu/core/quaternion.py).

Quaternion layout is (w, x, y, z). The rotation-vector helpers and
``rigid_deform`` (utils/tempo_utils.py:4-84 of the reference) take the
batch dims implicitly ([..., 3] / [..., 4]) and are differentiable.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


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


def rotvec_to_quat(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector [..., 3] -> (w,x,y,z) quaternion [..., 4]; the
    identity quaternion with finite gradients at ||v|| -> 0."""
    # Double-where guard: torch.where, like jnp.where, multiplies the
    # unselected branch's gradient by zero, and 0 * inf is NaN, so the
    # small-angle branch must never see sqrt(0) or 1 / 0.
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = sq < _EPS
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = angle / 2.0
    w = torch.where(small, torch.ones_like(half), torch.cos(half))
    xyz = torch.where(small, 0.5 * v, v * (torch.sin(half) / angle))
    return torch.cat([w, xyz], dim=-1)


def _skew(u: torch.Tensor) -> torch.Tensor:
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    zeros = torch.zeros_like(ux)
    return torch.stack([
        torch.stack([zeros, -uz, uy], dim=-1),
        torch.stack([uz, zeros, -ux], dim=-1),
        torch.stack([-uy, ux, zeros], dim=-1),
    ], dim=-2)


def rotvec_to_rotmat(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle [..., 3] -> [..., 3, 3], first order
    (I + [v]x) below the small-angle threshold."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = sq < _EPS
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = v / angle  # unit axis for the regular branch, raw v for the small one
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(
        v.shape[:-1] + (3, 3))
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    # for unit k, K^2 = k k^T - I, so R = cos I + sin K + (1 - cos) k k^T
    kkT = k[..., :, None] * k[..., None, :]
    R = c * eye + s * _skew(k) + (1.0 - c) * kkT
    return torch.where(small[..., None], eye + _skew(v), R)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w,x,y,z) quaternions."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def rigid_deform(xyz, rot, rigid_v, rigid_rotvec, rigid_rotcen, time_span,
                 mode: str = "screw"):
    """Screw-like rigid motion over ``time_span`` [...]: rotate about
    ``rigid_rotcen`` by the axis-angle ``rigid_rotvec * t``, translate by
    ``rigid_v * t``, and pre-multiply the orientation ``rot`` by the same
    rotation. ``mode`` "linear" translates only, "skip" is the identity.
    Returns (xyz', rot')."""
    if mode == "skip":
        return xyz, rot
    t = time_span[..., None]
    if mode == "linear":
        return xyz + rigid_v * t, rot
    if mode != "screw":
        raise ValueError(f"mode must be screw, linear or skip, got {mode!r}")
    shift = rigid_v * t
    rvec = rigid_rotvec * t
    dq = rotvec_to_quat(rvec)
    R = rotvec_to_rotmat(rvec)
    d = xyz - rigid_rotcen
    # the elementwise matvec of the JAX package (a batched matmul would
    # sum in another order)
    xyz_new = torch.stack(
        [R[..., i, 0] * d[..., 0] + R[..., i, 1] * d[..., 1]
         + R[..., i, 2] * d[..., 2] for i in range(3)], dim=-1)
    return xyz_new + rigid_rotcen + shift, quat_mul(dq, rot)
