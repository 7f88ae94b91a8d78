"""Camera math and the device-side camera (port of gsplat_tpu/core/camera.py).

Host-side constructors are numpy, as in the JAX package (reference
utils/graphics_utils.py:38-111, scene/cameras.py:57-72); ``CameraParams``
holds the matrices as float32 tensors on one device. Matrices use the
column-vector convention (x' = M @ [x, 1]).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gsplat_tpu_torch import get_device

ZNEAR = 0.01
ZFAR = 100.0


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]),
                  scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4. ``R`` is the COLMAP-convention camera rotation
    (cam-to-world), ``t`` the world->cam translation; ``translate`` and
    ``scale`` recenter and rescale the scene."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      cx_offset: float = 0.0, cy_offset: float = 0.0,
                      focal_x: float | None = None,
                      focal_y: float | None = None,
                      width: float | None = None,
                      height: float | None = None) -> np.ndarray:
    """OpenGL-style (z_sign=+1) perspective projection, column-vector 4x4,
    with the principal-point shift of getProjectionMatrixShift when a
    focal length is given."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, bottom = tan_y * znear, -tan_y * znear
    right, left = tan_x * znear, -tan_x * znear
    if focal_x is not None:
        off_x = (cx_offset - width / 2) / focal_x * znear
        off_y = (cy_offset - height / 2) / focal_y * znear
        top += off_y
        bottom += off_y
        left += off_x
        right += off_x
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2 * znear / (right - left)
    P[1, 1] = 2 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Everything the rasterizer needs from a camera, on one device."""

    view: torch.Tensor       # (4, 4) float32 world->camera
    full_proj: torch.Tensor  # (4, 4) float32 proj @ view
    cam_pos: torch.Tensor    # (3,) float32
    tan_fovx: torch.Tensor   # () float32
    tan_fovy: torch.Tensor   # () float32
    width: int
    height: int

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)


def camera_from_matrices(view: np.ndarray, full_proj: np.ndarray,
                         cam_pos: np.ndarray, tan_fovx: float,
                         tan_fovy: float, width: int, height: int,
                         device: str | torch.device = "cuda") -> CameraParams:
    """CameraParams from host matrices, placed on ``device``."""
    device = get_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraParams(view=f32(view), full_proj=f32(full_proj),
                        cam_pos=f32(cam_pos), tan_fovx=f32(tan_fovx),
                        tan_fovy=f32(tan_fovy), width=int(width),
                        height=int(height))


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                znear: float = ZNEAR, zfar: float = ZFAR,
                translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0,
                principal_point: tuple[float, float] | None = None,
                focal_px: tuple[float, float] | None = None,
                device: str | torch.device = "cuda") -> CameraParams:
    """Build a CameraParams from dataset extrinsics/intrinsics."""
    view = world_to_view(R, t, translate, scale)
    if principal_point is not None:
        fx, fy = focal_px if focal_px is not None else (
            fov2focal(fovx, width), fov2focal(fovy, height))
        proj = projection_matrix(znear, zfar, fovx, fovy,
                                 cx_offset=principal_point[0],
                                 cy_offset=principal_point[1],
                                 focal_x=fx, focal_y=fy,
                                 width=width, height=height)
    else:
        proj = projection_matrix(znear, zfar, fovx, fovy)
    full_proj = proj @ view
    cam_pos = np.linalg.inv(view)[:3, 3]
    return camera_from_matrices(view, full_proj, cam_pos,
                                math.tan(fovx / 2), math.tan(fovy / 2),
                                width, height, device)


def ndc_to_pix(v, size):
    """NDC [-1,1] -> pixel coords (auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5
