"""The hat passes' share of their memory roofline: the bytes they must move
(counted from the shapes at ``hat_pass`` and ``hat_pass_pair``) over the
card's bandwidth, over their CUDA-event time, in the untraced window."""

from h100_bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "hat_pass", "hat_pass_pair")
