"""Median host-clock time of an encode call that ends in a synchronize
(traced run's window), per chunk (a batch call's time over its chunks)."""

from statistics import median


def read(ctx):
    if not ctx["encode_s"]:
        return None
    return median(ctx["encode_s"]) * 1e3 / ctx["batch"]
