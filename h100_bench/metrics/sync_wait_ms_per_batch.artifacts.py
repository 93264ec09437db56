"""Host milliseconds of the artifact chain's one device-to-host read
(``chain.sync``, in batches with a motion-on sample) per batch
(``stream.produce``), in the untraced window."""

from h100_bench.program_spans import host_ms, untraced


def read(ctx):
    batches = untraced(ctx, "stream.produce")
    if not batches:
        return None
    return host_ms(untraced(ctx, "chain.sync") or []) / len(batches)
