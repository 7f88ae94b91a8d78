"""Plain PyTorch reference of a served SwinGS window frame: the bytes a
viewer receives for one camera at one video frame (fractional frames
allowed), from the window's whole union of rows (the immature pool and
the matured ring) with their raw leaves, rigid-motion parameters and
lifespans.

Written from the description of the fork's rigid motion
(NeutrinoLiu/3dgs-mcmc ``utils/tempo_utils.py::rigid_deform``, drawn by
``scene/gaussian_model.py::get_basic_para_at`` through
``deformable_render``), not from the program under test:

- a row is live at frame f when it is valid and start <= f < end;
- its age is t = f - start;
- with ``deform`` its position turns about ``rigid_rotcen`` by the
  rotation whose axis-angle vector is ``rigid_rotvec`` * t (Rodrigues:
  R = cos(a) I + sin(a) [k]x + (1 - cos(a)) k k^T, a the angle, k the
  unit axis), then moves by ``rigid_v`` * t; its orientation quaternion
  is pre-multiplied (Hamilton product) by the quaternion of the same
  rotation, (cos(a / 2), k sin(a / 2));
- the live rows render as a served frame does (``view.frame_bytes``).

Departures from the fork:

- the union is taken whole, with a valid mask, and the live rows
  selected from it; the fork concatenates its two pools' live rows;
- below a squared angle of 1e-12 the rotation is taken to first order
  (R = I + [a k]x, quaternion (1, a k / 2)): the axis is undefined at a
  zero angle (the trainer's initial ``rigid_rotvec`` is (1e-10, 0, 0));
  the fork's own guard at a zero angle is not reproduced;
- every step computes in the dtype asked for (float32; a lower type for
  the control), the product R d as an explicit sum.
"""

from __future__ import annotations

import torch

from . import view

LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
RIGID = ("rigid_v", "rigid_rotvec", "rigid_rotcen")
SMALL_ANGLE_SQ = 1e-12


def _skew(u):
    """[u]x [N, 3, 3] of vectors [N, 3]."""
    x, y, z = u.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        u.shape[:-1] + (3, 3))


def screw(xyz, rot, v, rotvec, rotcen, t):
    """(position [N, 3], quaternion [N, 4]) after the rigid motion of age
    ``t`` [N]: the rotation of ``rotvec * t`` about ``rotcen``, then the
    translation ``v * t``; the quaternion pre-multiplied by the same
    rotation (not normalised)."""
    t = t[:, None]
    a_vec = rotvec * t
    sq = (a_vec * a_vec).sum(-1, keepdim=True)
    small = sq < SMALL_ANGLE_SQ
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = a_vec / angle
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(
        xyz.shape[0], 3, 3)
    r = c * eye + s * _skew(k) + (1 - c) * (k[:, :, None] * k[:, None, :])
    r = torch.where(small[..., None], eye + _skew(a_vec), r)
    d = xyz - rotcen
    moved = (r * d[:, None, :]).sum(-1) + rotcen + v * t
    half = angle / 2
    dq = torch.where(small, torch.cat([torch.ones_like(sq), a_vec / 2], 1),
                     torch.cat([torch.cos(half), k * torch.sin(half)], 1))
    w1, x1, y1, z1 = dq.unbind(-1)
    w2, x2, y2, z2 = rot.unbind(-1)
    q = torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)
    return moved, q


def live_mask(union: dict, frame: float):
    """valid & start <= frame < end over the union."""
    return (union["valid"] & (union["start"] <= frame)
            & (union["end"] > frame))


def live_rows(union: dict, frame: float, deform: bool,
              dtype=torch.float32) -> dict:
    """The raw leaves of the rows live at ``frame``, moved to it by their
    rigid motion when ``deform``, computed in ``dtype``."""
    idx = torch.nonzero(live_mask(union, frame))[:, 0]
    rows = {k: union[k].index_select(0, idx) for k in LEAVES}
    if deform:
        rig = [union[k].index_select(0, idx).to(dtype) for k in RIGID]
        age = frame - union["start"].index_select(0, idx).to(dtype)
        rows["xyz"], rows["rotation"] = screw(
            rows["xyz"].to(dtype), rows["rotation"].to(dtype), *rig, age)
    return rows


def frame_bytes(union: dict, frame: float, cam, sh_degree: int, tile,
                deform: bool, dtype=torch.float32, work=None):
    """uint8 [H, W, 3] of camera ``cam`` at video frame ``frame``."""
    with torch.no_grad():
        return view.frame_bytes(live_rows(union, frame, deform, dtype), cam,
                                sh_degree, tile, dtype=dtype, work=work)
