"""Banks built per batch in the untraced window: the mean of
``stream.compose``'s ``filled`` (0 where the cohort stays resident)."""

from h100_bench.program_spans import untraced


def read(ctx):
    recs = untraced(ctx, "stream.compose")
    if not recs or any("filled" not in r["attrs"] for r in recs):
        return None
    return sum(r["attrs"]["filled"] for r in recs) / len(recs)
