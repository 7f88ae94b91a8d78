"""The whole step's share of the chip's peak: the step's least time by
the frozen counts (counts/train_step.py: the larger of its float32
operations at 67 TFLOP/s and its bytes at 3.35 TB/s) over the wall time
a step of the traced run's untraced stretch (the profiler's own cost
left out), in percent."""

from benchmark.counts import peaks, train_step


def read(ctx):
    work = ctx["work"]
    if not work or "pairs" not in work or not ctx["units"] or ctx["trace"] is None:
        return None
    return peaks.share(train_step.least_s(work),
                       ctx["wall_s"] / ctx["units"])
