"""Frames completed over the whole window (host clock), each frame's
bytes on the host."""


def read(ctx):
    if not ctx["units"]:
        return None
    return ctx["units"] / ctx["wall_s"]
