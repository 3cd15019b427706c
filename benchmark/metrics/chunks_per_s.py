"""Chunks roundtripped (encoded and decoded) per second over the whole
window: every chunk of the window over its whole host-clock length."""


def read(ctx):
    if ctx["trace"]:
        return None
    return ctx["chunks"] / ctx["elapsed_s"]
