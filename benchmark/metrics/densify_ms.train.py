"""Mean wall time of a densification call in the untraced stretch of a
traced run, each span ending on a synchronise (the benchmark's span
around the call)."""


def read(ctx):
    t = ctx["loop"].spans.get("densify") or []
    return 1e3 * sum(t) / len(t) if t else None
