"""Stream rows handed to ``rasterize`` a played frame: the program's
``stream.slice_rows`` counter over its ``stream.render`` spans in the
traced stretch. None where the program records no such counter."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    frames = sum(s[0] == "stream.render" for s in spans)
    n = getattr(profiling, "counters", dict)().get("stream.slice_rows")
    return n / frames if frames and n else None
