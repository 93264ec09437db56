"""The bank slab's GiB, ``slab_bytes`` of the last ``stream.compose`` span in
the untraced window: every resident subject's bank, one slot each."""

from h100_bench.program_spans import untraced


def read(ctx):
    recs = untraced(ctx, "stream.compose")
    if not recs:
        return None
    last = max(recs, key=lambda r: r["t0"])
    if "slab_bytes" not in last["attrs"]:
        return None
    return last["attrs"]["slab_bytes"] / 2**30
