"""Device milliseconds per step of every kernel that is not one of the
program's seven hand kernels (preprocess and its autograd, the loss,
Adam, the noise, binning's sorts and gathers, the scatter-add
reduction), from the traced stretch."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["trace_units"]:
        return None
    s = tr.other_kernels_s()
    return 1e3 * s / ctx["trace_units"] if s > 0 else None
