"""Set-up: process start to the first timed step (imports, the build from
its cache, inputs, warm-up and the check's first steps), host clock."""


def read(ctx):
    return ctx["setup_s"]
