"""The artifact stream's rate on the card, for comparing two checkouts.

``configs/dataset/synth_train.yaml`` (``data/sub-sta21``, the generator's
four SR artifacts at the YAML's probabilities) through ``SyntheticStream``
at B=4 256^3 with prefetch on: 2 warm-up batches, then ``--batches`` read
with the host clock around a read of each, ``--repeats`` times on one
stream. ``--affine`` drops the four artifacts and the nonlinear field: the
spatial deformation is the affine warp alone, whose ten K2 passes a batch
(five linear, five nearest) are the stream's only hat passes. The mode is
the stream's own (``FSG_STREAM_BF16``; a checkout without the production
mode is f32 throughout). Prints one JSON line per repeat. It uses only
entry points that every checkout with the stream's artifact chain has, so
the same file runs in an older checkout copied in:

    FSG_STREAM_BF16=0 python -m fetalsyngen_torch.probes.stream_rate --tag change

Run it from the checkout's root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..config import instantiate, load_yaml, resolve_interpolations
from ..generator.model import ARTIFACTS
from ..parallel.input_pipeline import SyntheticStream


def dataset(affine: bool = False):
    """``synth_train.yaml`` on the card, as its YAML gives it, or
    (``affine``) without its SR artifacts and its nonlinear field."""
    cfg = resolve_interpolations(load_yaml("configs/dataset/synth_train.yaml"))
    gen = cfg.pop("generator")
    gen["device"] = "cuda"
    if affine:
        for name in ARTIFACTS:
            gen.pop(name)
        gen["spatial_deform"]["nonlinear_transform"] = False
    return instantiate(cfg, generator=instantiate(gen))


def drive(it, batches: int) -> float:
    """vol/s over ``batches`` batches of ``it``, each read back to the host."""
    n = 0
    t0 = time.perf_counter()
    for _ in range(batches):
        b = next(it)
        float(b["image"][..., ::64, ::64, ::64].sum())
        n += b["image"].shape[0]
    return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--tag", default="")
    ap.add_argument("--affine", action="store_true", help="without the SR artifacts and the nonlinear field")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    stream = SyntheticStream(dataset(args.affine), batch_size=args.batch_size, seed=0, prefetch=True)
    it = iter(stream)
    drive(it, 2)
    for r in range(args.repeats):
        rate = drive(it, args.batches)
        print(json.dumps({"tag": args.tag, "affine": args.affine, "repeat": r, "vol_per_s": rate,
                          "batches": args.batches, "batch_size": args.batch_size,
                          "FSG_STREAM_BF16": os.environ.get("FSG_STREAM_BF16"), "card": card}), flush=True)
    it.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
