"""Static scene container (port of gsplat_tpu/data/scene.py: ``Scene``).

scene/__init__.py:22-97: dataset auto-detect, the cameras.json dump, the
train-camera shuffle, one LazyCamera list per resolution scale, and the
point_cloud/iteration_{i}/point_cloud.ply layout. ``DynamicScene`` (SwinGS)
comes with a later slice of the port.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from gsplat_tpu_torch.core.camera import fov2focal, world_to_view
from gsplat_tpu_torch.data.cameras import CameraInfo, LazyCamera
from gsplat_tpu_torch.data.readers import (SCENE_LOAD_CALLBACKS, SceneInfo,
                                           detect_scene_type)


def _camera_json_entry(idx: int, c: CameraInfo) -> dict:
    """cameras.json entries (utils/camera_utils.py camera_to_JSON)."""
    c2w = np.linalg.inv(world_to_view(c.R, c.T))
    return {"id": idx, "img_name": c.image_name,
            "width": c.width, "height": c.height,
            "position": c2w[:3, 3].tolist(),
            "rotation": c2w[:3, :3].tolist(),
            "fy": fov2focal(c.fovy, c.height),
            "fx": fov2focal(c.fovx, c.width)}


class Scene:
    """Static scene: full camera lists, shuffled (scene/__init__.py:22-97).
    Cameras load onto ``device``."""

    def __init__(self, source_path: str, model_path: str,
                 images: str = "images", eval_split: bool = True,
                 resolution: int = -1, white_background: bool = False,
                 init_type: str = "sfm", num_pts: int = 100_000,
                 shuffle: bool = True, scene_type: Optional[str] = None,
                 resolution_scales: Optional[List[float]] = None,
                 device="cuda"):
        self.model_path = model_path
        scene_type = scene_type or detect_scene_type(source_path)
        reader = SCENE_LOAD_CALLBACKS[scene_type]
        if scene_type == "Colmap":
            info: SceneInfo = reader(source_path, images=images,
                                     eval_split=eval_split,
                                     init_type=init_type, num_pts=num_pts)
        elif scene_type == "Blender":
            info = reader(source_path, white_background=white_background,
                          eval_split=eval_split, num_pts=num_pts)
        else:
            info = reader(source_path, eval_split=eval_split,
                          init_type=init_type, num_pts=num_pts)
        self.info = info
        self.cameras_extent = info.radius

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([_camera_json_entry(i, c)
                           for i, c in enumerate(info.train_cameras
                                                 + info.test_cameras)], f)
        if shuffle:
            random.shuffle(info.train_cameras)

        self.resolution_scales = list(resolution_scales or [1.0])
        self._train_cameras: Dict[float, List[LazyCamera]] = {}
        self._test_cameras: Dict[float, List[LazyCamera]] = {}
        for scale in self.resolution_scales:
            self._train_cameras[scale] = [
                LazyCamera(c, scale, resolution, device)
                for c in info.train_cameras]
            self._test_cameras[scale] = [
                LazyCamera(c, scale, resolution, device)
                for c in info.test_cameras]

    def get_train_cameras(self, scale: float = 1.0) -> List[LazyCamera]:
        return self._train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[LazyCamera]:
        return self._test_cameras[scale]

    @property
    def train_cameras(self) -> List[LazyCamera]:
        return self._train_cameras[self.resolution_scales[0]]

    @property
    def test_cameras(self) -> List[LazyCamera]:
        return self._test_cameras[self.resolution_scales[0]]

    def point_cloud_path(self, iteration: int) -> str:
        return os.path.join(self.model_path,
                            f"point_cloud/iteration_{iteration}/"
                            "point_cloud.ply")
