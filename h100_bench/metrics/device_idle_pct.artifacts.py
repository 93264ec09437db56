"""The traced window less the union of the device's operations, in %."""

from h100_bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
