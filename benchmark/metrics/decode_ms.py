"""Median host-clock time of a decode call that ends in a synchronize
(traced run's window), per chunk (a batch call's time over its chunks)."""

from statistics import median


def read(ctx):
    if not ctx["decode_s"]:
        return None
    return median(ctx["decode_s"]) * 1e3 / ctx["batch"]
