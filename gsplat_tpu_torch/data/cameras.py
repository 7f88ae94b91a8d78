"""Dataset cameras with lazy image loading (port of
gsplat_tpu/data/cameras.py).

- the resolution rules of loadCam / LazyCamera.load (scene/cameras.py:
  136-205): -r in {1, 2, 4, 8} divides; -r -1 caps the width at 1600 px
  with a one-time notice; other values set the target width; the
  dataset-level resolution_scale multiplies;
- alpha-masked RGB (cameras.py:52-55); znear 0.01, zfar 100; the
  principal-point shift of Google Immersive (extra_para).

``LazyCamera.load()`` returns (CameraParams on the camera's device, image
[H, W, 3] float32 numpy); ``unload()`` frees the cached image. PIL is
imported only where an image is decoded or resized.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from gsplat_tpu_torch.core.camera import CameraParams, make_camera

_WARNED = False


@dataclasses.dataclass
class CameraInfo:
    """Host-side camera record (scene/dataset_readers.py:27-39)."""

    uid: object
    R: np.ndarray      # cam-to-world rotation (reader convention)
    T: np.ndarray      # world-to-cam translation
    fovx: float
    fovy: float
    image_path: Optional[str]
    image_name: str
    width: int
    height: int
    extra_para: Optional[dict] = None  # cx/cy/focal_x/focal_y (pixels)
    frame: int = -1
    image: Optional[np.ndarray] = None  # pre-decoded [H,W,3|4] in [0,1]


def _resolve_resolution(orig_w: int, orig_h: int, resolution_scale: float,
                        args_resolution: int):
    """Resolution policy of scene/cameras.py:149-169 -> (w, h, downscale).
    The reference rounds in the first branch and truncates in the other
    (camera_utils.py:23 vs :39); both quirks are kept."""
    global _WARNED
    if args_resolution in (1, 2, 4, 8):
        downscale = resolution_scale * args_resolution
        return (round(orig_w / downscale), round(orig_h / downscale),
                downscale)
    if args_resolution == -1:
        if orig_w > 1600:
            if not _WARNED:
                print("[ INFO ] Large input images (>1.6K width); "
                      "rescaling to 1.6K. Use --resolution 1 to disable.")
                _WARNED = True
            width_scale = orig_w / 1600
        else:
            width_scale = 1
    else:
        width_scale = orig_w / args_resolution
    downscale = float(width_scale) * float(resolution_scale)
    return int(orig_w / downscale), int(orig_h / downscale), downscale


def _load_image(path: str, resolution):
    from PIL import Image

    with Image.open(path) as im:
        im = im.resize(resolution)
        arr = np.asarray(im).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    return arr


class LazyCamera:
    """Path-only until ``load()``; mirrors scene/cameras.py:87-222."""

    def __init__(self, info: CameraInfo, resolution_scale: float = 1.0,
                 args_resolution: int = -1, device="cuda"):
        self.info = info
        self.resolution_scale = resolution_scale
        self.args_resolution = args_resolution
        self.device = device
        self.frame = info.frame
        self.image_name = info.image_name
        self.uid = info.uid
        self._image: Optional[np.ndarray] = None
        self._camera: Optional[CameraParams] = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._image is not None

    def load(self):
        with self._lock:
            return self._load_locked()

    def _load_locked(self):
        if self._image is not None:
            return self._camera, self._image
        info = self.info
        if info.image is not None:
            rgba = info.image
            ow, oh = rgba.shape[1], rgba.shape[0]
            w, h, downscale = _resolve_resolution(
                ow, oh, self.resolution_scale, self.args_resolution)
            if (w, h) != (ow, oh):
                from PIL import Image

                u8 = (np.clip(rgba, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
                mode = "RGBA" if u8.shape[2] == 4 else "RGB"
                rgba = np.asarray(Image.fromarray(u8, mode).resize((w, h))
                                  ).astype(np.float32) / 255.0
        else:
            from PIL import Image

            with Image.open(info.image_path) as im:
                ow, oh = im.size
            w, h, downscale = _resolve_resolution(
                ow, oh, self.resolution_scale, self.args_resolution)
            rgba = _load_image(info.image_path, (w, h))
        rgb = np.clip(rgba[:, :, :3], 0.0, 1.0)
        if rgba.shape[2] == 4:
            rgb = rgb * rgba[:, :, 3:4]  # alpha mask (cameras.py:184-187)

        extra = info.extra_para
        kw = {}
        if extra is not None:
            kw = dict(principal_point=(extra["cx"] / downscale,
                                       extra["cy"] / downscale),
                      focal_px=(extra["focal_x"] / downscale,
                                extra["focal_y"] / downscale))
        self._camera = make_camera(info.R, info.T, info.fovx, info.fovy, w,
                                   h, device=self.device, **kw)
        self._image = np.ascontiguousarray(rgb, np.float32)
        return self._camera, self._image

    def unload(self):
        with self._lock:
            self._image = None
            self._camera = None
