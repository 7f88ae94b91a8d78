"""merge_expand's share of its roofline: the least time of the window's
owner expansions by counts/merge_expand.py (the reference's pairs per
frame) over the device time of merge_expand_kernel, in percent."""

from benchmark.counts import merge_expand, peaks


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or not work or "pairs" not in work:
        return None
    n = tr.hand_n("merge_expand_kernel")
    return peaks.share(n * merge_expand.least_s(work),
                       tr.hand_s("merge_expand_kernel"))
