"""CUDA-event milliseconds of ``synth_core``'s resample and noise
(``core.resample_noise``) per volume, in the untraced window."""

from h100_bench.program_spans import card_ms_per_vol


def read(ctx):
    return card_ms_per_vol(ctx, "core.resample_noise")
