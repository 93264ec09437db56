"""Host milliseconds the consumer waits on the producer's thread
(``stream.join``) per batch, in the untraced window."""

from h100_bench.program_spans import host_ms, untraced


def read(ctx):
    recs = untraced(ctx, "stream.join")
    return host_ms(recs) / len(recs) if recs else None
