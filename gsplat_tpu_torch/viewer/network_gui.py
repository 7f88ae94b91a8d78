"""SIBR live-viewer socket protocol (port of gsplat_tpu/viewer/network_gui.py).

Byte-compatible with the JAX module and the reference network_gui
(gaussian_renderer/network_gui.py:26-85): each request is a little-endian
u32 length + JSON body (resolution, FoV, near/far, flags, scaling
modifier, row-major view and view-projection matrices with the SIBR Y/Z
sign flips); each reply is the raw RGB byte image followed by a
length-prefixed verify string. The listener and connection belong to a
``NetworkGUI`` object instead of module globals.
"""

from __future__ import annotations

import json
import math
import socket

import numpy as np
import torch

from gsplat_tpu_torch.core.camera import CameraParams, camera_from_matrices


class NetworkGUI:
    """Non-blocking listener plus at most one viewer connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen()
        self._listener.settimeout(0)
        self._conn: socket.socket | None = None

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def try_connect(self) -> bool:
        """Accept a pending viewer if there is one; True when connected."""
        if self._conn is not None:
            return True
        try:
            self._conn, addr = self._listener.accept()
        except (BlockingIOError, socket.timeout):
            return False
        print(f"\nConnected by {addr}")
        self._conn.settimeout(None)
        return True

    def disconnect(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self) -> None:
        self.disconnect()
        self._listener.close()

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def send(self, image_bytes: bytes | None, verify: str) -> None:
        if image_bytes is not None:
            self._conn.sendall(image_bytes)
        self._conn.sendall(len(verify).to_bytes(4, "little"))
        self._conn.sendall(verify.encode("ascii"))

    def receive(self, device: str | torch.device = "cuda"
                ) -> tuple[CameraParams | None, dict | None]:
        """Read one request. Returns (camera on ``device``, flags), or
        (None, None) for a zero-resolution keep-alive."""
        n = int.from_bytes(self._recv_exact(4), "little")
        msg = json.loads(self._recv_exact(n).decode("utf-8"))
        return request_to_camera(msg, device)


def request_to_camera(msg: dict, device: str | torch.device = "cuda"
                      ) -> tuple[CameraParams | None, dict | None]:
    """Decode one request body (see the module docstring)."""
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None, None
    view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] *= -1
    view[:, 2] *= -1
    full = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    full[:, 1] *= -1
    # the reference sends transposed (row-vector) matrices
    view_t = view.T
    full_t = full.T
    cam_pos = np.linalg.inv(view_t)[:3, 3]
    camera = camera_from_matrices(
        view_t, full_t, cam_pos, math.tan(msg["fov_x"] / 2),
        math.tan(msg["fov_y"] / 2), int(width), int(height), device)
    flags = {
        "train": bool(msg["train"]),
        "shs_python": bool(msg["shs_python"]),
        "rot_scale_python": bool(msg["rot_scale_python"]),
        "keep_alive": bool(msg["keep_alive"]),
        "scaling_modifier": msg["scaling_modifier"],
        "z_near": msg["z_near"], "z_far": msg["z_far"],
    }
    return camera, flags


def image_to_bytes(img01) -> bytes:
    """[H, W, 3] float in [0, 1] (numpy or tensor) -> the byte layout the
    SIBR viewer expects (uint8 RGB, C-order)."""
    if isinstance(img01, torch.Tensor):
        img01 = img01.detach().cpu().numpy()
    arr = np.asarray(img01)
    return (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8).tobytes()
