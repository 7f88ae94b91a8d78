"""Self-contained PLY IO (no plyfile dependency); numpy only, a copy of
gsplat_tpu/data/ply.py.

Byte-compatible with the reference's two PLY layouts so models/point clouds
interop with existing viewers and pipelines:
- point clouds: x,y,z,nx,ny,nz float32 + red,green,blue uint8
  (reference storePly/fetchPly, scene/dataset_readers.py:117-140)
- gaussian models: all-float32 attributes in construct_list_of_attributes
  order (scene/gaussian_model_static.py:214-249): x,y,z,nx,ny,nz,
  f_dc_{0..2}, f_rest_{0..3(K-1)-1}, opacity, scale_{0..2}, rot_{0..3};
  SH coefficients flattened channel-major (the reference transposes
  [N,K,3] -> [N,3,K] before flattening).

Reader supports binary_little_endian and ascii formats.
"""

from __future__ import annotations

import os

import numpy as np

_PLY_TO_NP = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
    "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {prop_name: array}."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    props: list[tuple[str, str]] = []
    count = 0
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((parts[2], _PLY_TO_NP[parts[1]]))

    if fmt == "binary_little_endian":
        dtype = np.dtype([(n, "<" + t) for n, t in props])
        arr = np.frombuffer(body, dtype=dtype, count=count)
    elif fmt == "ascii":
        rows = np.loadtxt(
            [ln for ln in body.decode("ascii").splitlines() if ln.strip()],
            dtype=np.float64, max_rows=count, ndmin=2)
        arr = np.zeros(count, dtype=np.dtype([(n, t) for n, t in props]))
        for i, (n, _) in enumerate(props):
            arr[n] = rows[:, i]
    else:
        raise ValueError(f"unsupported PLY format: {fmt}")
    return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def write_ply(path: str, names: list[str], columns: list[np.ndarray]) -> None:
    """Write a binary_little_endian PLY with one 'vertex' element."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = columns[0].shape[0]
    dtype = np.dtype([(name, "<" + col.dtype.str[1:])
                      for name, col in zip(names, columns)])
    arr = np.zeros(n, dtype=dtype)
    for name, col in zip(names, columns):
        arr[name] = col
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n}"]
    for name, col in zip(names, columns):
        lines.append(f"property {_NP_TO_PLY[col.dtype.str[1:]]} {name}")
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(arr.tobytes())


# ---------------- point clouds (dataset_readers.py:117-140) ----------------

def store_point_cloud(path: str, xyz: np.ndarray, rgb255: np.ndarray) -> None:
    normals = np.zeros_like(xyz, dtype=np.float32)
    write_ply(path,
              ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"],
              [xyz[:, 0].astype(np.float32), xyz[:, 1].astype(np.float32),
               xyz[:, 2].astype(np.float32),
               normals[:, 0], normals[:, 1], normals[:, 2],
               rgb255[:, 0].astype(np.uint8), rgb255[:, 1].astype(np.uint8),
               rgb255[:, 2].astype(np.uint8)])


def fetch_point_cloud(path: str):
    """(xyz [N, 3] f32, rgb [N, 3] f32 in [0, 1], normals [N, 3])."""
    v = read_ply(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(
        np.float32) / 255.0
    normals = (np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(
        np.float32) if "nx" in v else np.zeros_like(xyz))
    return xyz, rgb, normals


# ------------- gaussian models (gaussian_model_static.py:228-296) -----------

def save_gaussian_ply(path: str, xyz, f_dc, f_rest, opacity, scaling,
                      rotation) -> None:
    """xyz [N,3]; f_dc [N,1,3]; f_rest [N,K-1,3]; opacity [N,1];
    scaling [N,3]; rotation [N,4] — raw (pre-activation) values, like the
    reference save_ply."""
    n = xyz.shape[0]
    f_dc_flat = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)     # [N, 3]
    f_rest_flat = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)  # [N, 3(K-1)]
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc_flat.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest_flat.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scaling.shape[1])]
             + [f"rot_{i}" for i in range(rotation.shape[1])])
    normals = np.zeros_like(xyz)
    cols = np.concatenate(
        [xyz, normals, f_dc_flat, f_rest_flat, opacity, scaling, rotation],
        axis=1).astype(np.float32)
    write_ply(path, names, [cols[:, i] for i in range(cols.shape[1])])


def load_gaussian_ply(path: str, max_sh_degree: int):
    """Returns raw arrays (xyz, f_dc [N,1,3], f_rest [N,K-1,3], opacity [N,1],
    scaling [N,3], rotation [N,4]) — mirror of load_ply
    (gaussian_model_static.py:251-296)."""
    v = read_ply(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = v["opacity"].astype(np.float32)[:, None]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]],
                    axis=1).astype(np.float32)[:, :, None]  # [N,3,1]
    k = (max_sh_degree + 1) ** 2
    rest_names = sorted([m for m in v if m.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    if len(rest_names) != 3 * (k - 1):
        raise ValueError(f"PLY has {len(rest_names)} f_rest coeffs, "
                         f"expected {3 * (k - 1)}")
    f_rest = np.stack([v[m] for m in rest_names], axis=1).astype(np.float32)
    f_rest = f_rest.reshape(n, 3, k - 1)
    scale_names = sorted([m for m in v if m.startswith("scale_")],
                         key=lambda s: int(s.split("_")[-1]))
    scaling = np.stack([v[m] for m in scale_names], axis=1).astype(np.float32)
    rot_names = sorted([m for m in v if m.startswith("rot_")],
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([v[m] for m in rot_names], axis=1).astype(np.float32)
    # back to [N, K, 3] layouts
    f_dc = np.transpose(f_dc, (0, 2, 1))      # [N, 1, 3]
    f_rest = np.transpose(f_rest, (0, 2, 1))  # [N, K-1, 3]
    return xyz, f_dc, f_rest, opacity, scaling, rotation
