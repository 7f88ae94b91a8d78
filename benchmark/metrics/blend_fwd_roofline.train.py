"""The training blend forward's share of its roofline: the least time of
the window's forwards by counts/blend_forward.py (work per step from the
reference) over the device time of blend_forward_kernel in the trace, in
percent."""

from benchmark.counts import blend_forward, peaks


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or not work or "pairs" not in work:
        return None
    n = tr.hand_n("blend_forward_kernel")
    return peaks.share(n * blend_forward.least_s(work),
                       tr.hand_s("blend_forward_kernel"))
