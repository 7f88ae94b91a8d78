"""Peak device memory allocated by PyTorch during the window
(torch.cuda.max_memory_allocated after a reset at the window's start),
in GB."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
