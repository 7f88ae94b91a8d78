"""The whole window's wall time over the steps it completed, with every
densification inside it (host clock, the window ending on a
synchronise)."""


def read(ctx):
    if not ctx["units"]:
        return None
    return ctx["wall_s"] * 1e3 / ctx["units"]
