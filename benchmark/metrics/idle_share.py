"""Share of the traced stretch in which no operation ran on the device:
1 - (union of the device operations' intervals) / (stretch), both from
the same trace, in percent. The profiler slows the host's dispatch, so
on a host-bound path this reads above the untraced share (PERF.md)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.window_s or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
