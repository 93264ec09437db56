"""Volumes completed in the window over the window's seconds."""

from h100_bench.stats import rate


def read(ctx):
    return rate(ctx["volumes"], ctx["window_s"])
