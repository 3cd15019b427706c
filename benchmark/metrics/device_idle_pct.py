"""Share of the profiled window (first to last benchmark host span) in
which no kernel, copy or memset ran on the card; none where the profile
missed a launch."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.complete or prof.window_s <= 0:
        return None
    return (1.0 - prof.busy_s / prof.window_s) * 100.0
