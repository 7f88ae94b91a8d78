"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics read: device operations by name, the union of their
intervals (busy time), kernel launches, and the idle gaps between them,
named by the benchmark span the host was in.

The profiler records device activity only (recording every host
operation too doubled a training step's wall time); the benchmark's own
host spans are taken with ``time.time_ns()`` and aligned to the device
clock by a marker operation at the window's start.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

HAND_KERNELS = ("blend_forward_kernel", "blend_backward_kernel",
                "render_kernel", "expand_scan_kernel", "merge_expand_kernel",
                "multi_cumsum_kernel", "multi_cummax_kernel")
_HAND = re.compile(r"\b(" + "|".join(HAND_KERNELS) + r")\b")


def short_name(name: str) -> str:
    """A kernel's name without return type, template arguments and
    parameters."""
    hand = _HAND.search(name)
    if hand:
        return hand.group(1)
    base = name.split("(")[0]
    base = re.sub(r"<.*>", "", base).strip()
    return base.split(" ")[-1] or name


def _is_annotation(ev) -> bool:
    return bool(getattr(ev, "is_user_annotation", lambda: False)())


class Summary:
    """The device side of one traced window, with the host's spans.

    ``events``: the profiler's events (device activity only is read);
    ``spans``: (name, start, end) of the benchmark's host spans in
    ``time.time_ns()``; ``marker_ns``: the host time just before the
    window's first device operation, which aligns the two clocks."""

    def __init__(self, events, spans, marker_ns, window_s):
        dev = []
        for e in events:
            if str(e.device_type()).endswith("CUDA") and not _is_annotation(e):
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), e.name()))
        dev.sort()
        offset = dev[0][0] - marker_ns if dev else 0
        self.window_s = window_s
        self.kernels = defaultdict(lambda: [0, 0.0])   # name -> [n, s]
        self.launches = 0
        for s, e, name in dev:
            if name.startswith("Memcpy") or name.startswith("Memset"):
                continue
            k = self.kernels[short_name(name)]
            k[0] += 1
            k[1] += (e - s) * 1e-9
            self.launches += 1
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for s, e, _ in dev:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy * 1e-9
        self.gaps = _name_gaps(gaps, [(n, a + offset, b + offset)
                                      for n, a, b in spans])

    def hand_s(self, name):
        return self.kernels.get(name, [0, 0.0])[1]

    def hand_n(self, name):
        return self.kernels.get(name, [0, 0.0])[0]

    def other_kernels_s(self):
        return sum(v[1] for k, v in self.kernels.items()
                   if k not in HAND_KERNELS)

    def breakdown(self, n=10):
        ops = sorted(((k, v[1]) for k, v in self.kernels.items()),
                     key=lambda x: -x[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:n]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _name_gaps(gaps, spans):
    """Seconds of device idle time by the innermost benchmark span the
    host was in at each gap's middle ("-" outside every span)."""
    sp = sorted((a, b, n) for n, a, b in spans)
    starts = [a for a, _, _ in sp]
    out = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = "-"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 4, -1), -1):   # spans nest shallowly
            if sp[k][1] >= mid:
                name = sp[k][2]                  # the innermost
                break
        out[name] += (g1 - g0) * 1e-9
    return dict(out)
