"""Peak device memory of the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start, less the sampled outputs the
benchmark keeps for judging), GiB; the pool of inputs is in it."""


def read(ctx):
    if ctx["peak_bytes"] is None:
        return None
    return ctx["peak_bytes"] / 2**30
