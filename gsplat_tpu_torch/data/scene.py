"""Scene containers (port of gsplat_tpu/data/scene.py).

- ``Scene`` (scene/__init__.py:22-97): dataset auto-detect, the
  cameras.json dump, the train-camera shuffle, one LazyCamera list per
  resolution scale, and the point_cloud/iteration_{i}/point_cloud.ply
  layout;
- ``DynamicScene`` (SwinGS, :100-273): per-frame camera lists with a
  bounded LRU of decoded frames (MAX_FRAME_IN_MEMORY train /
  MAX_TEST_FRAME_IN_MEMORY test frames, host memory) and background
  prefetch of the frames the trainer samples next.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from gsplat_tpu_torch.core.camera import fov2focal, world_to_view
from gsplat_tpu_torch.data.cameras import CameraInfo, LazyCamera
from gsplat_tpu_torch.data.prefetch import CameraPrefetcher
from gsplat_tpu_torch.data.readers import (SCENE_LOAD_CALLBACKS,
                                           DynamicSceneInfo, SceneInfo,
                                           detect_scene_type)

MAX_FRAME_IN_MEMORY = 10
MAX_TEST_FRAME_IN_MEMORY = 40


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


class DynamicScene:
    """Per-frame camera lists with a bounded decoded-image cache
    (scene/__init__.py:100-273). Frames are rebased to 0..num_frames-1 by
    the reader; every consumer (SliWinManager, lifespans, the stream dump)
    works in rebased frames. Cameras load onto ``device``."""

    def __init__(self, source_path: str, model_path: str,
                 eval_split: bool = True, resolution: int = -1,
                 init_type: str = "random", num_pts: int = 100_000,
                 max_frame: int = 100, min_frame: int = 0,
                 shuffle: bool = True,
                 max_in_memory: int = MAX_FRAME_IN_MEMORY,
                 max_test_in_memory: int = MAX_TEST_FRAME_IN_MEMORY,
                 prefetch_workers: int = 2, device="cuda"):
        self.model_path = model_path
        info: DynamicSceneInfo = SCENE_LOAD_CALLBACKS["SwinGS"](
            source_path, eval_split=eval_split, init_type=init_type,
            num_pts=num_pts, max_frame=max_frame, min_frame=min_frame)
        self.info = info
        self.cameras_extent = info.radius
        self.min_frame = min_frame
        self.num_frames = max_frame - min_frame
        self.max_frame = self.num_frames
        self.max_in_memory = max_in_memory
        self.max_test_in_memory = max_test_in_memory

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([_camera_json_entry(i, c)
                           for i, c in enumerate(info.train_cam_at[0])], f)

        def wrap(cams):
            if shuffle:
                cams = list(cams)
                random.shuffle(cams)
            return [LazyCamera(c, args_resolution=resolution, device=device)
                    for c in cams]

        self.train_cam_at = [wrap(cs) for cs in info.train_cam_at]
        self.test_cam_at = [wrap(cs) for cs in info.test_cam_at]
        self._active_train: List[int] = []
        self._active_test: List[int] = []
        self._prefetcher = (CameraPrefetcher(prefetch_workers)
                            if prefetch_workers > 0 else None)

    # ---- bounded activate / deactivate (scene/__init__.py:196-273) ----

    def _pf_key(self, cam_lists, t):
        return ("train" if cam_lists is self.train_cam_at else "test", t)

    def prefetch_train_frames(self, frames) -> None:
        """Start background loads of frames the trainer samples next; frames
        past the video or already resident cost nothing."""
        if self._prefetcher is None:
            return
        for t in frames:
            if 0 <= t < len(self.train_cam_at):
                self._prefetcher.schedule(("train", t), self.train_cam_at[t])

    def _activate(self, frames, cam_lists, active, limit):
        pf = self._prefetcher
        for t in frames:
            if t in active:
                active.remove(t)
            active.append(t)  # move-to-back LRU
            if pf is not None:
                pf.wait(self._pf_key(cam_lists, t))
            for cam in cam_lists[t]:
                cam.load()
        while len(active) > limit:
            evict = active.pop(0)
            if evict in frames:
                active.append(evict)
                continue
            # an unload racing a half-done background load would leak the
            # freshly decoded image: drain the frame's loads first
            if pf is not None:
                pf.wait(self._pf_key(cam_lists, evict))
            for cam in cam_lists[evict]:
                cam.unload()

    def get_train_cams_at(self, frames) -> List[LazyCamera]:
        frames = list(frames)
        self._activate(frames, self.train_cam_at, self._active_train,
                       self.max_in_memory)
        return [c for t in frames for c in self.train_cam_at[t]]

    def get_test_cams_at(self, frames) -> List[LazyCamera]:
        frames = list(frames)
        self._activate(frames, self.test_cam_at, self._active_test,
                       self.max_test_in_memory)
        return [c for t in frames for c in self.test_cam_at[t]]

    def unload_all(self):
        if self._prefetcher is not None:
            self._prefetcher.drain()
        for cams in self.train_cam_at:  # prefetched-but-unactivated too
            for c in cams:
                if c.loaded:
                    c.unload()
        self._active_train.clear()

    def unload_all_test(self):
        if self._prefetcher is not None:
            self._prefetcher.drain()
        for t in self._active_test:
            for c in self.test_cam_at[t]:
                c.unload()
        self._active_test.clear()

    def close(self) -> None:
        """Wait for outstanding loads and stop the prefetch threads."""
        if self._prefetcher is not None:
            self._prefetcher.shutdown()
            self._prefetcher = None

    def point_cloud_path(self, iteration: int) -> str:
        return os.path.join(self.model_path,
                            f"point_cloud/iteration_{iteration}/"
                            "point_cloud.ply")
