"""Device kernels launched per served frame in the traced stretch (all
kernels, the program's hand kernels and PyTorch's)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["trace_units"] or not tr.launches:
        return None
    return tr.launches / ctx["trace_units"]
