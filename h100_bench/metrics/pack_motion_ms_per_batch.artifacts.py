"""Host milliseconds per ``pack_motion`` call (one a batch), in the untraced window."""

from h100_bench.readers import host_ms, untraced_calls


def read(ctx):
    calls = untraced_calls(ctx, "pack_motion")
    return host_ms(calls) / len(calls) if calls else None
