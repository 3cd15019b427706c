"""Seconds from the process's start to the first timed chunk: imports,
the card's context, loading (at a checkout's first run, building) the
kernels, the pool made on the card and one warm roundtrip of each pool
chunk."""


def read(ctx):
    return ctx["setup_s"]
