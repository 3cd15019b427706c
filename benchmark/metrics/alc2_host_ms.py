"""Host time of the ALC2 container's host stages per chunk: the sum of
the medians of the port's four spans (``parallel.batch.STAGES``:
``alc2.encode.tables``, ``alc2.encode.to_host``, ``alc2.decode.parse``,
``alc2.decode.upload``) over the run's calls, over the chunks of a batch.
Read in a traced run on the card; none where the port keeps no such
spans."""

import sys
from statistics import median

SPANS = ("alc2.encode.tables", "alc2.encode.to_host", "alc2.decode.parse",
         "alc2.decode.upload")


def read(ctx):
    if ctx.get("profile") is None:
        return None
    stages = getattr(sys.modules.get("alice_codec_tpu_torch.parallel.batch"), "STAGES", None)
    samples = getattr(stages, "samples", None)
    if samples is None:
        return None
    kept = [samples.get(name) for name in SPANS]
    if not all(kept):
        return None
    return sum(median(k) for k in kept) * 1e3 / ctx["batch"]
