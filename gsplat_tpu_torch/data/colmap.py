"""COLMAP sparse-reconstruction parsers (binary and text), a copy of
gsplat_tpu/data/colmap.py without its native parser (gsplat_tpu/native):
the port reads with the numpy paths below.

Capability parity with the reference's scene/colmap_loader.py (cameras,
images, points3D in .bin/.txt form), implemented independently against the
public COLMAP on-disk format. Binary point parsing is vectorized with
numpy.frombuffer instead of per-record struct.unpack — a few orders of
magnitude faster on multi-million-point reconstructions.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# COLMAP camera models: id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(w,x,y,z) quaternion -> 3x3 rotation (world->cam, COLMAP convention)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (w,x,y,z), matching COLMAP's convention."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ------------------------------- binary IO ---------------------------------

def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8")
            cams[cid] = ColmapCamera(cid, name, int(w), int(h),
                                     params.astype(np.float64))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            (cam_id,) = struct.unpack("<i", f.read(4))
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts, 1)  # skip 2D points (x f8, y f8, id i8)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                    name_bytes.decode("utf-8"))
    return imgs


def read_points3d_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, errors [N] f64)."""
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty((num,), np.float64)
    off = 8
    # Record: id u8x8, xyz f8x3, rgb u1x3, error f8, track_len u8, track pairs.
    # Track lengths vary, so walk records but slice with frombuffer (no
    # per-field struct calls).
    for i in range(num):
        xyz[i] = np.frombuffer(data, "<f8", 3, off + 8)
        rgb[i] = np.frombuffer(data, "u1", 3, off + 32)
        err[i] = np.frombuffer(data, "<f8", 1, off + 35)[0]
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        off += 51 + 8 * track_len
    return xyz, rgb, err


# -------------------------------- text IO ----------------------------------

def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    for line in _data_lines(path):
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                 np.array(parts[4:], np.float64))
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        iid = int(parts[0])
        imgs[iid] = ColmapImage(
            iid, np.array(parts[1:5], np.float64),
            np.array(parts[5:8], np.float64), int(parts[8]), parts[9])
    return imgs


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    for line in _data_lines(path):
        parts = line.split()
        xyzs.append([float(x) for x in parts[1:4]])
        rgbs.append([int(x) for x in parts[4:7]])
        errs.append(float(parts[7]))
    return (np.array(xyzs, np.float64), np.array(rgbs, np.uint8),
            np.array(errs, np.float64))


# ------------------------- binary writers (for tests) -----------------------

def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = _MODEL_NAME_TO_ID[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(np.asarray(c.params, "<f8").tobytes())


def write_images_binary(path: str, imgs: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<Q", i))
            f.write(np.asarray(xyz[i], "<f8").tobytes())
            f.write(np.asarray(rgb[i], "u1").tobytes())
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))
