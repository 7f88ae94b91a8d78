"""95th percentile of the frames' times, from the camera handed in to
its bytes on the host, over every frame of the untraced stretch (host
clock; a frame lasts tens of milliseconds, so each reading carries the
clock's half millisecond)."""

import statistics


def read(ctx):
    t = (ctx["loop"].spans.get("frame") or [])[:ctx["units"]]
    if len(t) < 20:
        return None
    return 1e3 * statistics.quantiles(t, n=20)[-1]
