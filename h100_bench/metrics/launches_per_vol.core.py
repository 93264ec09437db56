"""Device kernels in the traced window per volume completed there."""

from h100_bench.readers import traced


def read(ctx):
    return traced(ctx, "kernels", per_volume=True)
