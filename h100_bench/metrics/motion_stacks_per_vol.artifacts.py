"""Stacks the motion engine accepted per volume: ``chain.motion``'s
``stacks_accepted`` (one span a sample; none on a motion-off sample) over
its spans, in the untraced window."""

from h100_bench.program_spans import untraced


def read(ctx):
    recs = untraced(ctx, "chain.motion")
    return sum(r["attrs"].get("stacks_accepted", 0) for r in recs) / len(recs) if recs else None
