"""Probe: the cost of a pair block transpose inside a kernel (K6) against a
plain pair copy (K5) and torch's own transpose, per volume.

Port of ``scripts/probe_blocktp.py``: does folding the
``permute().contiguous()`` copies between hat passes into the kernels pay?
Checks K6 against ``permute(0, 2, 1)`` first, then times, on (B, S, S, S)
pairs (B = 4, S = 256 by default):

    pair copy        K5, ``kernels.probes.pair_copy``
    pair tp_out      K6, ``kernels.probes.pair_transpose`` ((i, j, k) -> (i, k, j))
    torch transpose  ``transpose(-1, -2).contiguous()`` of both volumes

    python -m fetalsyngen_torch.probes.probe_blocktp [--batch 4] [--size 256] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import probes
from . import timing

ITERS = 6  # chained calls per timing, as in the script


def check(S: int, dev: torch.device) -> None:
    """K6 on one (S, S, S) pair equals ``permute(0, 2, 1)``; raises if not."""
    rng = np.random.default_rng(1)
    xa, xb = (torch.from_numpy(rng.normal(size=(S, S, S)).astype(np.float32)).to(dev) for _ in range(2))
    oa, ob = probes.pair_transpose(xa, xb)
    if not (torch.equal(oa, xa.permute(0, 2, 1)) and torch.equal(ob, xb.permute(0, 2, 1))):
        raise RuntimeError("pair_transpose differs from permute(0, 2, 1)")
    print("pair_transpose correct", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = timing.start(args.device)
    B, S = args.batch, args.size
    check(S, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    va, vb = (torch.randn((B, S, S, S), generator=g, device=dev) for _ in range(2))
    times = {}
    for name, fn in (("pair copy", probes.pair_copy), ("pair tp_out", probes.pair_transpose),
                     ("torch transpose", probes.pair_transpose_ref)):
        ms, _ = timing.chain_ms(lambda _c, fn=fn: fn(va, vb), None, ITERS, dev)
        if ms is None:
            print(f"{name:16s} ran once on {dev.type}, no time", flush=True)
        else:
            times[name] = ms / B
            print(f"{name:16s} {ms / B:8.3f} ms/vol", flush=True)
    return times


if __name__ == "__main__":
    main()
