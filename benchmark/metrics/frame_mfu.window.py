"""A window frame's share of the chip's peak: the least time of a served
frame (counts/view_frame.py) plus the screw motion of its live rows
(counts/rigid_deform.py), bytes and operations added before the larger
bound is taken, over the wall time a frame of the traced run's untraced
stretch, in percent. P is the live rows a sampled frame draws."""

from benchmark.counts import peaks, render, rigid_deform, view_frame


def read(ctx):
    work = ctx["work"]
    if not work or "pairs" not in work or not ctx["units"] or ctx["trace"] is None:
        return None
    least = peaks.least_s(view_frame.nbytes(work) + rigid_deform.nbytes(work),
                          render.ops(work) + rigid_deform.ops(work))
    return peaks.share(least, ctx["wall_s"] / ctx["units"])
