"""Host milliseconds per accepted stack of the motion engine
(``motion.stack``: its acquisition and recon), in the untraced window."""

from h100_bench.program_spans import host_ms, untraced


def read(ctx):
    recs = untraced(ctx, "motion.stack")
    return host_ms(recs) / len(recs) if recs else None
