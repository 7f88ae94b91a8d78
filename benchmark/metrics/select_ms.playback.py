"""Mean host time of the player's ``stream.select`` span (the frame's
slice of the stream and its ``start <= f`` mask), over the traced
stretch, in ms. None where the program records no such span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    d = [s[2] - s[1] for s in spans if s[0] == "stream.select"]
    return 1e-6 * sum(d) / len(d) if d else None
