"""Host seconds of the first ``SeedBankCache.bank`` call: decode, orient,
pin and enqueue the upload of the first subject's bank."""


def read(ctx):
    rec = ctx["recorder"]
    if not rec.active("seed_bank") or not rec.calls["seed_bank"]:
        return None
    first = rec.calls["seed_bank"][0]
    return first["t1"] - first["t0"]
