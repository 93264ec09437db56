"""Host milliseconds in ``motion_t`` per volume, in the untraced window."""

from h100_bench.readers import host_ms, per_untraced, untraced_calls


def read(ctx):
    calls = untraced_calls(ctx, "motion_t")
    return None if calls is None else per_untraced(ctx, host_ms(calls))
