"""Plain PyTorch reference of a played SwinGS frame: the bytes a viewer
receives for one camera at one video frame, from the whole stream's raw
columns.

The rows drawn at frame f are those with start_frame <= f < end_frame,
selected over the whole stream (no ordering, no slicing); they render as
a served frame does (``view.frame_bytes``). The stream format carries no
rigid motion, so none is applied.
"""

from __future__ import annotations

import torch

from . import view

LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def live_rows(stream: dict, frame: int) -> dict:
    """The raw leaves of the rows live at ``frame``."""
    live = (stream["start_frame"] <= frame) & (stream["end_frame"] > frame)
    idx = torch.nonzero(live)[:, 0]
    return {k: stream[k].index_select(0, idx) for k in LEAVES}


def frame_bytes(stream: dict, frame: int, cam, sh_degree: int, tile,
                dtype=torch.float32, work=None):
    """uint8 [H, W, 3] of camera ``cam`` at video frame ``frame``."""
    return view.frame_bytes(live_rows(stream, frame), cam, sh_degree, tile,
                            dtype=dtype, work=work)

