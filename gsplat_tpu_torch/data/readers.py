"""Scene readers (port of gsplat_tpu/data/readers.py).

- ``read_colmap_scene`` (readColmapSceneInfo, dataset_readers.py:142-203):
  sparse/0 in binary or text form, SIMPLE_PINHOLE and PINHOLE cameras,
  every llffhold-th image held out, sfm init (points3D.bin/.txt cached as
  points3D.ply) or random init;
- ``read_blender_scene`` (readNerfSyntheticInfo, dataset_readers.py:
  247-281): transforms_{train,test}.json, OpenGL -> COLMAP axis flip,
  alpha over the background baked in, 100k random points in [-1.3, 1.3]^3
  when no points3d.ply exists;
- ``read_google_immersive_scene`` (readGoogleImmersiveInfo, :325-373):
  cam.json + undistorted/, principal-point offsets;
- ``read_dynamic_scene`` (readDynamicSceneInfo, :427-525): the SwinGS
  layout images_per_frame/<t>/ + cam.json, per-frame train/test lists,
  frames rebased to 0..span-1, sfm (sfm.bin) or random init;
- ``nerfpp_norm`` (getNerfppNorm, :55-76), ``_random_init`` (:178-188) and
  ``detect_scene_type`` (scene/__init__.py:44-54).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.camera import focal2fov, fov2focal, world_to_view
from gsplat_tpu_torch.data import colmap, ply
from gsplat_tpu_torch.data.cameras import CameraInfo


@dataclasses.dataclass
class SceneInfo:
    points: Optional[np.ndarray]
    colors: Optional[np.ndarray]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    translate: np.ndarray
    radius: float
    ply_path: str


@dataclasses.dataclass
class DynamicSceneInfo:
    points: Optional[np.ndarray]
    colors: Optional[np.ndarray]
    train_cam_at: List[List[CameraInfo]]  # per frame
    test_cam_at: List[List[CameraInfo]]
    translate: np.ndarray
    radius: float
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]):
    """Scene center/radius from camera centers (dataset_readers.py:55-76)."""
    centers = np.stack([np.linalg.inv(world_to_view(c.R, c.T))[:3, 3]
                        for c in cam_infos], axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return -avg, float(diagonal * 1.1)


def _random_init(num_pts: int, radius: float, ply_path: str, seed=None):
    """Random cube init, side 6 * radius (dataset_readers.py:178-188)."""
    rng = np.random.default_rng(seed) if seed is not None else np.random
    xyz = rng.random((num_pts, 3)) * radius * 3 * 2 - radius * 3
    shs = rng.random((num_pts, 3)) / 255.0
    colors = sh_lib.sh_to_rgb_dc(shs)
    ply.store_point_cloud(ply_path, xyz.astype(np.float32), colors * 255)
    return xyz.astype(np.float32), colors.astype(np.float32)


def read_colmap_scene(path: str, images: str = "images", eval_split=True,
                      llffhold: int = 8, init_type: str = "sfm",
                      num_pts: int = 100_000) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    infos = []
    for im in imgs.values():
        intr = cams[im.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model {intr.model} not supported: undistort "
                "the dataset first (PINHOLE / SIMPLE_PINHOLE only)")
        infos.append(CameraInfo(
            uid=intr.id,
            R=colmap.qvec2rotmat(im.qvec).T,
            T=np.asarray(im.tvec),
            fovx=focal2fov(focal_x, intr.width),
            fovy=focal2fov(focal_y, intr.height),
            image_path=os.path.join(path, images, os.path.basename(im.name)),
            image_name=os.path.splitext(os.path.basename(im.name))[0],
            width=intr.width, height=intr.height))
    infos.sort(key=lambda c: c.image_name)
    train, test = _llff_split(infos, eval_split, llffhold)
    translate, radius = nerfpp_norm(train)

    if init_type == "sfm":
        ply_path = os.path.join(sparse, "points3D.ply")
        if not os.path.exists(ply_path):
            try:
                xyz, rgb, _ = colmap.read_points3d_binary(
                    os.path.join(sparse, "points3D.bin"))
            except FileNotFoundError:
                xyz, rgb, _ = colmap.read_points3d_text(
                    os.path.join(sparse, "points3D.txt"))
            ply.store_point_cloud(ply_path, xyz.astype(np.float32),
                                  rgb.astype(np.float32))
        points, colors, _ = ply.fetch_point_cloud(ply_path)
    elif init_type == "random":
        ply_path = os.path.join(path, "random.ply")
        points, colors = _random_init(num_pts, radius, ply_path)
    else:
        raise ValueError("init_type must be 'sfm' or 'random'")
    return SceneInfo(points, colors, train, test, translate, radius, ply_path)


def _llff_split(infos: List[CameraInfo], eval_split: bool, llffhold: int):
    """(train, test): every llffhold-th camera held out, or all train."""
    if not eval_split:
        return infos, []
    return ([c for i, c in enumerate(infos) if i % llffhold != 0],
            [c for i, c in enumerate(infos) if i % llffhold == 0])


def _read_transforms(path: str, transforms_file: str, white_background: bool,
                     extension: str = ".png") -> List[CameraInfo]:
    from PIL import Image

    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(contents["frames"]):
        image_path = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        with Image.open(image_path) as im:
            data = np.asarray(im.convert("RGBA")).astype(np.float32) / 255.0
            w, h = im.size
        bg = np.ones(3) if white_background else np.zeros(3)
        rgb = data[:, :, :3] * data[:, :, 3:4] + bg * (1 - data[:, :, 3:4])
        infos.append(CameraInfo(
            uid=idx, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3], fovx=fovx,
            fovy=focal2fov(fov2focal(fovx, w), h), image_path=image_path,
            image_name=os.path.splitext(os.path.basename(image_path))[0],
            width=w, height=h, image=rgb.astype(np.float32)))
    return infos


def read_blender_scene(path: str, white_background=False, eval_split=True,
                       extension: str = ".png", num_pts: int = 100_000
                       ) -> SceneInfo:
    train = _read_transforms(path, "transforms_train.json", white_background,
                             extension)
    test = _read_transforms(path, "transforms_test.json", white_background,
                            extension)
    if not eval_split:
        train, test = train + test, []
    translate, radius = nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # random in [-1.3, 1.3]^3 (dataset_readers.py:262-270)
        xyz = (np.random.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
        shs = np.random.random((num_pts, 3)) / 255.0
        ply.store_point_cloud(ply_path, xyz, sh_lib.sh_to_rgb_dc(shs) * 255)
    points, colors, _ = ply.fetch_point_cloud(ply_path)
    return SceneInfo(points, colors, train, test, translate, radius, ply_path)


def _parse_cam_json(cams_para: dict) -> List[CameraInfo]:
    """cam.json parsing shared by the Google and SwinGS layouts
    (dataset_readers.py:284-323, 376-425)."""
    infos = []
    for cam_name, paras in cams_para.items():
        extr, intr = paras["extrinsic"], paras["intrinsic"]
        stem = cam_name.split(".")[0]
        digits = "".join(ch for ch in stem if ch.isdigit())
        uid = int(digits) if digits else 0
        focal_x = intr["matrix"][0][0]
        focal_y = intr["matrix"][1][1]
        infos.append(CameraInfo(
            uid=uid,
            R=np.array(extr["SO3"]).T,
            T=np.array(extr["T"]),
            fovx=focal2fov(focal_x, intr["width"]),
            fovy=focal2fov(focal_y, intr["height"]),
            image_path=None, image_name=cam_name,
            width=intr["width"], height=intr["height"],
            extra_para={"cx": intr["matrix"][0][-1],
                        "cy": intr["matrix"][1][-1],
                        "focal_x": focal_x, "focal_y": focal_y}))
    infos.sort(key=lambda c: c.image_name)
    return infos


def _sfm_init(path: str):
    """sfm.bin of a cam.json layout, written as sfm.ply and read back."""
    ply_path = os.path.join(path, "sfm.ply")
    xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(path, "sfm.bin"))
    ply.store_point_cloud(ply_path, xyz.astype(np.float32),
                          rgb.astype(np.float32))
    points, colors, _ = ply.fetch_point_cloud(ply_path)
    return points, colors, ply_path


def read_google_immersive_scene(path: str, eval_split=True, llffhold: int = 8,
                                init_type: str = "random",
                                num_pts: int = 100_000) -> SceneInfo:
    with open(os.path.join(path, "cam.json")) as f:
        cams_para = json.load(f)
    infos = _parse_cam_json(cams_para)
    for c in infos:
        c.image_path = os.path.join(path, "undistorted", c.image_name)
    train, test = _llff_split(infos, eval_split, llffhold)
    translate, radius = nerfpp_norm(train)
    if init_type == "sfm":
        points, colors, ply_path = _sfm_init(path)
    else:
        ply_path = os.path.join(path, "random.ply")
        points, colors = _random_init(num_pts, radius, ply_path)
    return SceneInfo(points, colors, train, test, translate, radius, ply_path)


def read_dynamic_scene(path: str, eval_split=True, llffhold: int = 8,
                       init_type: str = "random", num_pts: int = 100_000,
                       max_frame: int = 100, min_frame: int = 0,
                       tempo_shuffle: bool = False) -> DynamicSceneInfo:
    """SwinGS layout: images_per_frame/<t>/ + cam.json.

    Frames ``min_frame..max_frame-1`` are loaded and rebased to
    ``0..span-1`` (the reference's camera_utils.py:92), so sliding-window
    lifespans always start at 0; image paths keep the frame number on
    disk."""
    if not 0 <= min_frame < max_frame:
        raise ValueError(f"need 0 <= min_frame < max_frame, got "
                         f"{min_frame}, {max_frame}")
    with open(os.path.join(path, "cam.json")) as f:
        cams_para = json.load(f)
    reading_dir = "images_per_frame"
    for t in range(min_frame, max_frame):
        d = os.path.join(path, reading_dir, str(t))
        if not os.path.exists(d):
            raise FileNotFoundError(f"missing frame dir: {d}")

    fixed = _parse_cam_json(cams_para)

    def at_frame(c: CameraInfo, t: int) -> CameraInfo:
        return dataclasses.replace(
            c, uid=f"{t}.{c.uid}", frame=t - min_frame,
            image_name=os.path.join(str(t), c.image_name),
            image_path=os.path.join(path, reading_dir, str(t), c.image_name))

    train_at, test_at = [], []
    split = list(fixed)
    if eval_split:
        if tempo_shuffle:
            random.seed(42)
        for t in range(min_frame, max_frame):
            if tempo_shuffle:
                random.shuffle(split)
            train_at.append([at_frame(c, t) for i, c in enumerate(split)
                             if i % llffhold != 0])
            test_at.append([at_frame(c, t) for i, c in enumerate(split)
                            if i % llffhold == 0])
    else:
        for t in range(min_frame, max_frame):
            train_at.append([at_frame(c, t) for c in split])
            test_at.append([])

    translate, radius = nerfpp_norm(train_at[0])
    if init_type == "sfm":
        points, colors, ply_path = _sfm_init(path)
    elif init_type == "random":
        ply_path = os.path.join(path, "random.ply")
        points, colors = _random_init(num_pts, radius, ply_path)
    else:
        raise ValueError("init_type must be 'sfm' or 'random'")
    return DynamicSceneInfo(points, colors, train_at, test_at, translate,
                            radius, ply_path)


SCENE_LOAD_CALLBACKS: Dict[str, Callable] = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
    "Google": read_google_immersive_scene,
    "SwinGS": read_dynamic_scene,
}


def detect_scene_type(path: str) -> str:
    """Auto-detect the dataset flavour (scene/__init__.py:44-54 logic)."""
    if os.path.exists(os.path.join(path, "images_per_frame")):
        return "SwinGS"
    if os.path.exists(os.path.join(path, "cam.json")):
        return "Google"
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    raise ValueError(f"could not infer scene type from {path}")
