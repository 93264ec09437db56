"""Host milliseconds per call into ``batch_program`` (the producer's
enqueue of one batch) in the untraced window."""

from h100_bench.readers import host_ms, untraced_calls


def read(ctx):
    calls = untraced_calls(ctx, "batch_program")
    return host_ms(calls) / len(calls) if calls else None
