"""Which construct makes the hat kernel slow: K7's five variants, timed.

Port of ``scripts/profile_kernel_variants.py`` (variants 1-4 give wrong
results on purpose; ``csrc/hat_single.cu`` writes out the function each
computes):

    v0  the windowed hat sample with a lane-affine table, span budget 48
    v1  v0 without the sub-128 window realignment (the TPU's roll ladder)
    v2  a fixed window: no dynamic window, no min reduction
    v3  a fixed span of 8: no max reduction
    v4  a fixed window and 4 taps

at the script's shapes: S = H = 384 lanes and rows per slice, D slices (384
by default: 147,456 rows, 226 MB), coefficients (0, 0, 1, 0.3), a (3, 384)
table drawn N(0, 0.02) after the volume from ``numpy.random.default_rng(0)``.
Beside them, K2's lane-affine form (``kernels.hat.hat_pass`` with the same
table), the kernel V0 is a windowed form of. Prints ms per launch.

    python -m fetalsyngen_torch.probes.profile_kernel_variants [--depth 384] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import hat, probes
from . import timing

S = H = 384
COEFS = (0.0, 0.0, 1.0, 0.3)
ITERS = 8  # chained launches per timing, as in the script


def inputs(D: int, dev: torch.device):
    """The script's volume (D, H, S), coefficients (4,) and table (3, S)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((D * H, S), np.float32)).reshape(D, H, S).to(dev)
    table = torch.from_numpy(rng.normal(0, 0.02, (3, S)).astype(np.float32)).to(dev)
    return x, torch.tensor(COEFS, dtype=torch.float32, device=dev), table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = timing.start(args.device)
    x, coefs, table = inputs(args.depth, dev)
    runs = {f"v{v}": (lambda _c, v=v: probes.hat_variant(x, coefs, table, v)) for v in probes.VARIANTS}
    x4, c4, t4 = x[None], coefs[None], table[None]
    runs["hat_pass_lane"] = lambda _c: hat.hat_pass(x4, c4, t4)
    times = {}
    for name, run in runs.items():
        ms, _ = timing.chain_ms(run, None, ITERS, dev)
        if ms is None:
            print(f"{name:24s} ran once on {dev.type}, no time", flush=True)
        else:
            times[name] = ms
            print(f"{name:24s} {ms:8.3f} ms/launch", flush=True)
    return times


if __name__ == "__main__":
    main()
