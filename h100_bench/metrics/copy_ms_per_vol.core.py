"""Device time of copy kernels (by name) in the traced window, per volume."""

from h100_bench.readers import traced


def read(ctx):
    return traced(ctx, "copy_us", per_volume=True, scale=1e-3)
