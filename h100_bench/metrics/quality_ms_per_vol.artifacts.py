"""CUDA-event milliseconds of blur_cortex, struct_noise and boundaries per
volume, in the untraced window."""

from h100_bench.readers import per_untraced, untraced_calls


def read(ctx):
    calls = untraced_calls(ctx, "quality")
    if calls is None or any("ms" not in c for c in calls):
        return None
    return per_untraced(ctx, sum(c["ms"] for c in calls))
