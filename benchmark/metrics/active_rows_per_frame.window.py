"""Rows live at a window frame's video time (valid, start <= f < end):
the program's ``swin.active_rows`` counter over its ``swin.render`` spans
in the traced stretch. None where the program records no such
counter."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    frames = sum(s[0] == "swin.render" for s in spans)
    n = getattr(profiling, "counters", dict)().get("swin.active_rows")
    return n / frames if frames and n else None
