"""The port's kernels' share of their memory roofline: the sum of each
launch's least time (the bytes its work needs over 3.35 TB/s,
``roofline.py``) over the sum of its measured device time."""

from roofline import least_seconds


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.complete or prof.csrc_s <= 0:
        return None
    least = least_seconds(prof.launches, prof.chunk_work)
    if least is None or least <= 0:
        return None
    return least / prof.csrc_s * 100.0
