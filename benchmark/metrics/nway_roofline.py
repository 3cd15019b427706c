"""K8 and K9's share of their memory roofline: the least time of one
chunk's share of both (its bytes by ``alc2_work.Alc2Work`` over 3.35
TB/s, ``roofline.least_seconds`` over the profiled chunks) over their
measured time a chunk (``nway_device_ms``: median event time of each).
Read in a traced run on the card; none where the port records no events
or the profiled chunks' work does not count K8 and K9."""

from alc2_work import nway_event_ms
from roofline import least_seconds


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or not prof.chunk_work:
        return None
    ms = nway_event_ms()
    least = least_seconds({"encode_pack_nway": 1, "decode_nway": 1}, prof.chunk_work)
    if ms is None or least is None:
        return None
    per_chunk_s = sum(ms) / 1e3 / ctx["batch"]
    return least / len(prof.chunk_work) / per_chunk_s * 100.0
