"""Device time per chunk of everything on the card that is not one of
the port's own kernels (``csrc/*.cu``): PyTorch's kernels, copies and
memsets (torch.profiler, the profiled roundtrips); none where the
profile missed a launch."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.complete or not prof.chunks:
        return None
    return prof.glue_s / prof.chunks * 1e3
