"""Host milliseconds of the program's ``stream.produce`` span per batch in
the untraced window: the producer's whole host work a batch (host draws,
generators, parameters, fields, banks, ``batch_program``). Beside it, the
same spans' CUDA-event milliseconds a batch (``card_ms``) and each stage's
card milliseconds a volume (``card_ms_per_vol``: ``stream.compose`` and
``synth_core``'s five)."""

from h100_bench.program_spans import card_ms, card_ms_per_vol, host_ms, untraced

STAGES = ("stream.compose", "core.intensity", "core.deform", "core.gamma", "core.bias", "core.resample_noise")


def read(ctx):
    recs = untraced(ctx, "stream.produce")
    if not recs:
        return None
    out = {"value": host_ms(recs) / len(recs), "batches": len(recs)}
    card = card_ms(recs)
    if card is not None:
        out["card_ms"] = card / len(recs)
        out["card_ms_per_vol"] = {s: card_ms_per_vol(ctx, s) for s in STAGES}
    return out
