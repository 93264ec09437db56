"""The 95th percentile over the window's batches of the host time from
asking the stream for a batch to holding it finished on the card."""

from h100_bench.stats import percentile


def read(ctx):
    v, beyond = percentile(ctx["waits_s"], 95)
    return {"value": v * 1e3, "samples": len(ctx["waits_s"]), "beyond": beyond}
