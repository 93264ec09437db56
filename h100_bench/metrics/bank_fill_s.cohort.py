"""Host seconds of the first ``bank.fill`` span: set-up's build of the
cohort's absent banks, decoded and uploaded on the fill's host threads."""

from h100_bench.program_spans import records


def read(ctx):
    fills = [r for r in records(ctx) or () if r["name"] == "bank.fill"]
    if not fills:
        return None
    first = min(fills, key=lambda r: r["t0"])
    return first["t1"] - first["t0"]
