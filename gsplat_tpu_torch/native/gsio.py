"""ctypes bindings for the native IO library (libgsio.so), a copy of
gsplat_tpu/native/gsio.py's COLMAP parsers.

Auto-builds with the system C++ toolchain (``make``) on first use, into
``build/gsio/`` at the root of the checkout (listed in .gitignore), never
into the package; all callers fall back to the numpy parsers when the
toolchain is unavailable, so the native layer is a host accelerator,
never a hard dependency. It parses files on the host and hides no device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "gsio")
_LIB_PATH = os.path.join(BUILD_DIR, "libgsio.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _DIR, "-s", f"OUT={BUILD_DIR}"],
                       check=True, capture_output=True)
        return os.path.exists(_LIB_PATH)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _stale() -> bool:
    """True if the built .so is missing or older than its sources."""
    if not os.path.exists(_LIB_PATH):
        return True
    so_mtime = os.path.getmtime(_LIB_PATH)
    for src in ("gsio.cpp", "Makefile"):
        path = os.path.join(_DIR, src)
        if os.path.exists(path) and os.path.getmtime(path) > so_mtime:
            return True
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale() and not _build() and not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f8p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64

    lib.gsio_count_points3d.restype = i64
    lib.gsio_count_points3d.argtypes = [u8p, i64]
    lib.gsio_parse_points3d.restype = i64
    lib.gsio_parse_points3d.argtypes = [u8p, i64, f8p, u8p, f8p]
    lib.gsio_count_images.restype = i64
    lib.gsio_count_images.argtypes = [u8p, i64]
    lib.gsio_parse_images.restype = i64
    lib.gsio_parse_images.argtypes = [u8p, i64, i32p, f8p, f8p, i32p,
                                      ctypes.c_char_p, i64]
    _lib = lib
    return _lib


def _u8(buf: bytes):
    arr = np.frombuffer(buf, np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr


def parse_points3d(buf: bytes):
    """Native points3D.bin parse. Returns (xyz, rgb, err) or None."""
    lib = get_lib()
    if lib is None:
        return None
    p, keep = _u8(buf)
    n = lib.gsio_count_points3d(p, len(buf))
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    got = lib.gsio_parse_points3d(
        p, len(buf),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if got != n:
        return None
    return xyz, rgb, err


def parse_images(buf: bytes):
    """Native images.bin parse. Returns (ids, qvec, tvec, cam_ids, names)
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    p, keep = _u8(buf)
    n = lib.gsio_count_images(p, len(buf))
    if n < 0:
        return None
    ids = np.empty((n,), np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty((n,), np.int32)
    name_cap = len(buf)
    names_buf = ctypes.create_string_buffer(name_cap)
    got = lib.gsio_parse_images(
        p, len(buf),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qvec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tvec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cam_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        names_buf, name_cap)
    if got != n:
        return None
    # maxsplit n: the buffer is as long as the file, and its unused NULs
    # would otherwise each make an empty bytes object
    names = names_buf.raw.split(b"\x00", n)[:n]
    return ids, qvec, tvec, cam_ids, [s.decode("utf-8") for s in names]
