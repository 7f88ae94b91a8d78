"""The inference render's share of its roofline: the least time of the
window's renders by counts/render.py (work per frame from the reference's
sampled frames) over the device time of render_kernel, in percent."""

from benchmark.counts import peaks, render


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or not work or "pairs" not in work:
        return None
    n = tr.hand_n("render_kernel")
    return peaks.share(n * render.least_s(work), tr.hand_s("render_kernel"))
