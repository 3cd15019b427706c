"""Device time per chunk of the port's own kernels (``csrc/*.cu``,
K1-K9), torch.profiler over the profiled roundtrips; none where the
profile missed a launch."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.complete or not prof.chunks or prof.csrc_s <= 0:
        return None
    return prof.csrc_s / prof.chunks * 1e3
