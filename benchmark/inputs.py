"""The benchmark's inputs, made from the seed or from the configuration:
cameras, ground-truth scenes and the Gaussian state. Plain NumPy and
PyTorch; both the program and the reference receive these.

Random tensors are drawn on the device by a ``torch.Generator`` there, a
few large calls each, so that set-up stays short at a million rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import raster

SH_C0 = 0.28209479177387814
ZNEAR, ZFAR = 0.01, 100.0


def generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


# ------------------------------------------------------------- cameras ----

def orbit_matrices(angle: float, width: int, height: int, radius: float,
                   center, fov: float) -> dict:
    """A camera on a horizontal circle of ``radius`` around ``center``
    at ``angle`` (radians), looking at the center, with ``fov`` radians on
    both axes: world->camera ``view``, ``full_proj`` (OpenGL-style
    projection @ view, near 0.01, far 100), ``cam_pos``, the half-angle
    tangents and the size."""
    c = np.asarray(center, np.float64)
    pos = c + radius * np.array([math.sin(angle), 0.0, -math.cos(angle)])
    fwd = (c - pos) / radius
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, up, fwd], 1)          # camera -> world
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = -rot.T @ pos
    tan = math.tan(fov / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = proj[1, 1] = 1.0 / tan
    proj[3, 2] = 1.0
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    view32 = view.astype(np.float32)
    full = (proj.astype(np.float32) @ view32).astype(np.float32)
    return dict(view=view32, full_proj=full,
                cam_pos=np.linalg.inv(view32)[:3, 3].astype(np.float32),
                tan_fovx=tan, tan_fovy=tan, width=int(width),
                height=int(height))


def ref_camera(m: dict, device) -> raster.Camera:
    def t(a):
        return torch.as_tensor(a, device=device)

    return raster.Camera(view=t(m["view"]), full_proj=t(m["full_proj"]),
                         cam_pos=t(m["cam_pos"]), tan_fovx=m["tan_fovx"],
                         tan_fovy=m["tan_fovy"], width=m["width"],
                         height=m["height"])


def ring(n: int):
    """Angles of ``n`` cameras evenly around the circle."""
    return [2 * math.pi * i / n for i in range(n)]


def param_floats(sh_degree: int) -> int:
    """Parameter floats a Gaussian: position, SH, opacity, scale, rotation."""
    return 3 + 3 * (sh_degree + 1) ** 2 + 1 + 3 + 4


# -------------------------------------------------------------- scenes ----

def gt_scene(p: int, device, seed: int):
    """The ground-truth scene of bench.py's training stages (means in
    [-0.9, 0.9]^3, log-scales in [-3.2, -2], random rotations, opacity
    logits in [0, 3], SH DC colours in [-0.5, 1.5] with the higher bands
    zero), drawn on ``device``: raw leaves keyed like the state's."""
    g = generator(device, seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    return {"xyz": u(-0.9, 0.9, p, 3), "scaling": u(-3.2, -2.0, p, 3),
            "rotation": torch.randn(p, 4, generator=g, device=device),
            "opacity": u(0.0, 3.0, p, 1),
            "f_dc": u(-0.5, 1.5, p, 1, 3),
            "f_rest": torch.zeros(p, 15, 3, device=device)}


def interp(u, table):
    """np.interp(u, linspace(0, 1, len(table)), table) on the device, for
    u in [0, 1]."""
    n = table.shape[0]
    x = u * (n - 1)
    i = torch.clamp(torch.floor(x).long(), 0, n - 2)
    f = x - i.to(x.dtype)
    return table[i] + f * (table[i + 1] - table[i])


def stats_leaves(u_opa, u_tri, perm, stats: dict, p: int):
    """Opacity logits [P, 1] and log-scales [P, 3] of a trained scene's
    statistics, from uniform draws ``u_opa`` [P] and ``u_tri`` [P] and a
    per-row permutation of the three axes ``perm`` [P, 3]: the opacity by
    inverse CDF of ``opacity_quantiles``, clipped to [1e-4, 1 - 1e-4]; one
    sorted log-scale triple by inverse CDF of each column of
    ``logscale_sorted_quantiles``, its axes permuted, shifted by
    -0.5 ln(P / n_alive) for the density (bench.py's
    trained_stats_state)."""
    dev = u_opa.device
    oq = torch.as_tensor(stats["opacity_quantiles"], dtype=torch.float32,
                         device=dev)
    sq = torch.as_tensor(stats["logscale_sorted_quantiles"],
                         dtype=torch.float32, device=dev)
    opa = torch.clamp(interp(u_opa, oq), 1e-4, 1 - 1e-4)
    triple = torch.stack([interp(u_tri, sq[:, i]) for i in range(3)], 1)
    logscale = torch.gather(triple, 1, perm)
    shift = np.float32(-0.5 * np.log(max(p / max(int(stats["n_alive"]), 1),
                                         1.0)))
    return torch.log(opa / (1 - opa))[:, None], logscale + float(shift)


def state_leaves(cfg: dict, device, seed: int) -> dict:
    """The model of a ``trained_stats`` configuration, drawn on ``device``
    from ``seed``: ``cfg["gaussians"]`` rows with positions uniform in
    [-1, 1]^3, uniform DC colours, the higher SH bands zero, identity
    rotations, and opacities and scales from the configuration's trained
    scene statistics (``stats_leaves``). No nearest-neighbour search: the
    statistics set every scale."""
    p, sh = cfg["gaussians"], cfg["sh_degree"]
    g = generator(device, seed)
    xyz = torch.rand(p, 3, generator=g, device=device) * 2.0 - 1.0
    rgb = torch.rand(p, 1, 3, generator=g, device=device)
    u = torch.rand(2, p, generator=g, device=device)
    perm = torch.argsort(torch.rand(p, 3, generator=g, device=device), 1)
    opacity, scaling = stats_leaves(u[0], u[1], perm, cfg["trained_stats"],
                                    p)
    rotation = torch.zeros(p, 4, device=device)
    rotation[:, 0] = 1.0
    return {"xyz": xyz, "f_dc": (rgb - 0.5) / SH_C0,
            "f_rest": torch.zeros(p, (sh + 1) ** 2 - 1, 3, device=device),
            "opacity": opacity, "scaling": scaling, "rotation": rotation}
