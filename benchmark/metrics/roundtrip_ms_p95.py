"""95th percentile, over every chunk of the window, of the host-clock time
from the encode call that takes the chunk to the synchronized return of
its decoded frames (in a batch loop a chunk's time is its batch's)."""

from harness import percentile


def read(ctx):
    if ctx["trace"]:
        return None
    return percentile(ctx["latencies_s"], 95) * 1e3
