"""Append-only binary stream of matured Gaussians + SliWinManager (a copy
of gsplat_tpu/utils/stream.py, which imports no JAX; the port keeps its
own).

Byte-identical to the reference streaming format (utils/stream_utils.py:11-82):
network-endian records of
  (start_frame u32, end_frame u32, xyz 3f, f_dc 3f, f_rest 3f*(K-1),
   scaling 3f, rotation 4f, opacity f)
with a format.json sidecar. The reference packs records one-by-one with
struct.pack; here a big-endian numpy structured array writes the whole batch
in one shot (orders of magnitude faster at 100k+ records).

SliWinManager ports utils/tempo_utils.py:86-129: a [start, end) frame window
sliding over the video, with bounded frame sampling.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np


def _record_dtype(sh_degree: int) -> np.dtype:
    k_rest = (sh_degree + 1) ** 2 - 1
    return np.dtype([
        ("start_frame", ">u4"), ("end_frame", ">u4"),
        ("xyz", ">f4", (3,)), ("f_dc", ">f4", (3,)),
        ("f_rest", ">f4", (3 * k_rest,)) if k_rest else ("f_rest", ">f4", (0,)),
        ("scaling", ">f4", (3,)), ("rotation", ">f4", (4,)),
        ("opacity", ">f4"),
    ])


def _format_json(sh_degree: int) -> dict:
    return {
        "start_frame": "I", "end_frame": "I", "xyz": "fff", "f_dc": "fff",
        "f_rest": "fff" * ((sh_degree + 1) ** 2 - 1), "scaling": "fff",
        "rotation": "ffff", "opacity": "f", "ENDIAN": "!",
    }


def stream_dump(params: dict, filename: str, sh_degree: int = 1) -> None:
    """Append records. params keys: start_frame, end_frame, xyz, f_dc
    [N,1,3] or [N,3], f_rest [N,K-1,3], scaling, rotation, opacity [N,1] or
    [N] — numpy arrays (host)."""
    n = np.asarray(params["start_frame"]).shape[0]
    rec = np.zeros(n, dtype=_record_dtype(sh_degree))
    rec["start_frame"] = np.asarray(params["start_frame"]).astype(np.uint32)
    rec["end_frame"] = np.asarray(params["end_frame"]).astype(np.uint32)
    rec["xyz"] = np.asarray(params["xyz"], np.float32)
    rec["f_dc"] = np.asarray(params["f_dc"], np.float32).reshape(n, 3)
    k_rest = (sh_degree + 1) ** 2 - 1
    if k_rest:
        # reference flattens [N, K-1, 3] with torch flatten(1): row-major,
        # i.e. coefficient-major (stream_utils.py:55)
        rec["f_rest"] = np.asarray(params["f_rest"], np.float32).reshape(n, -1)
    rec["scaling"] = np.asarray(params["scaling"], np.float32)
    rec["rotation"] = np.asarray(params["rotation"], np.float32)
    rec["opacity"] = np.asarray(params["opacity"], np.float32).reshape(n)

    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "format.json"), "w") as f:
        json.dump(_format_json(sh_degree), f, indent=4)
    with open(filename, "ab") as f:
        f.write(rec.tobytes())


def stream_load(fmtjson: str, filename: str) -> dict:
    """Load the whole stream into arrays (column dict). Infers SH degree
    from the sidecar."""
    with open(fmtjson) as f:
        fmt = json.load(f)
    k_rest = len(fmt["f_rest"]) // 3  # "fff" (3 chars) per coefficient
    sh_degree = int(np.sqrt(k_rest + 1)) - 1
    with open(filename, "rb") as f:
        data = f.read()
    rec = np.frombuffer(data, dtype=_record_dtype(sh_degree))
    n = rec.shape[0]
    return {
        "start_frame": rec["start_frame"].astype(np.int32),
        "end_frame": rec["end_frame"].astype(np.int32),
        "xyz": rec["xyz"].astype(np.float32),
        "f_dc": rec["f_dc"].astype(np.float32).reshape(n, 1, 3),
        "f_rest": (rec["f_rest"].astype(np.float32).reshape(n, k_rest, 3)
                   if k_rest else np.zeros((n, 0, 3), np.float32)),
        "scaling": rec["scaling"].astype(np.float32),
        "rotation": rec["rotation"].astype(np.float32),
        "opacity": rec["opacity"].astype(np.float32)[:, None],
        "sh_degree": sh_degree,
    }


class SliWinManager:
    """Sliding window [frame_start, frame_end) (utils/tempo_utils.py:86-129)."""

    def __init__(self, win_size: int, max_frame: int, max_sample: int = 1):
        self.frame_start = 0
        self.frame_end = win_size
        self.max_frame = max_frame
        self.max_sample = max_sample
        self._sampled_frames = None

    def state_dump(self):
        return {"frame_start": self.frame_start, "frame_end": self.frame_end,
                "max_frame": self.max_frame,
                "_sampled_frames": (list(self._sampled_frames)
                                    if self._sampled_frames is not None
                                    else None)}

    def state_load(self, state):
        self.frame_start = state["frame_start"]
        self.frame_end = state["frame_end"]
        self.max_frame = state["max_frame"]
        self._sampled_frames = state["_sampled_frames"]

    def __str__(self):
        return f"window[{self.frame_start}:{self.frame_end}]"

    def tick(self):
        self.frame_start += 1
        self.frame_end += 1

    def all_frames(self):
        return range(self.frame_start, min(self.frame_end, self.max_frame))

    def sampled_frames(self, resample=True):
        if resample or (self._sampled_frames is None):
            self._sampled_frames = list(self.all_frames())
            if len(self._sampled_frames) > self.max_sample:
                self._sampled_frames = sorted(
                    random.sample(self._sampled_frames, self.max_sample))
        return self._sampled_frames

    def sampled_frames_biased(self):
        """Exponential bias toward the newest frame (tempo_utils.py:121-126)."""
        frames = list(self.all_frames())
        pool = [frames[0]]
        for i in range(1, len(frames)):
            pool = pool * 2 + [frames[i]]
        return sorted(random.sample(pool, self.max_sample))

    def fetch_cams(self, fetcher):
        return list(fetcher(self.sampled_frames()))
