"""The whole frame's share of the chip's peak: the frame's least time by
the frozen counts (counts/view_frame.py) over the wall time a frame of
the traced run's untraced stretch, in percent."""

from benchmark.counts import peaks, view_frame


def read(ctx):
    work = ctx["work"]
    if not work or "pairs" not in work or not ctx["units"] or ctx["trace"] is None:
        return None
    return peaks.share(view_frame.least_s(work),
                       ctx["wall_s"] / ctx["units"])
