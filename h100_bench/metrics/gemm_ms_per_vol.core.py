"""Device time of GEMM kernels (by name) in the traced window, per volume."""

from h100_bench.readers import traced


def read(ctx):
    return traced(ctx, "gemm_us", per_volume=True, scale=1e-3)
