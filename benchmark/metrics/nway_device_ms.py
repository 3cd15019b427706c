"""Device time of the ALC2 entropy kernels per chunk: the median K8
(``encode_pack_nway``: encode_slabs + compact_lanes) and K9
(``decode_nway``) call by the CUDA event pairs the port records around
their launches, summed, over the chunks of a batch (one call of each
serves the whole batch).  Read in a traced run on the card; none where
the port records no events."""

from alc2_work import nway_event_ms


def read(ctx):
    if ctx.get("profile") is None:
        return None
    ms = nway_event_ms()
    if ms is None:
        return None
    return sum(ms) / ctx["batch"]
