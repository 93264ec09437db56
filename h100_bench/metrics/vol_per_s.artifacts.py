"""The stream's rate over the untraced part of a traced run's window."""

from h100_bench.stats import rate


def read(ctx):
    u = ctx["untraced"]
    if u["t0"] is None or not u["volumes"]:
        return None
    return rate(u["volumes"], u["t1"] - u["t0"])
