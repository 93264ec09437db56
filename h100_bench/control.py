"""The controls of ``correct``: the plain reference put in the program's
place and computed in the nearest precision below each the configuration
states, against the f32 reference, on the batch a run with the same seed
compares: float8 e4m3 storage where the production mode stores bf16
(``fp8``), and TF32 matmuls where it keeps f32 with TF32 off, the
positions (``tf32``). Each control must fail a limit of
``checks/<workload>.json``. Run on the chip, from the repository's root:

    python3 -m h100_bench.control --workload core.stream.b16 --seeds 11 12 13

Prints one JSON line per seed and mode. ``--modes bf16`` reads the
reference's own emulation of the production mode instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .check import distances, reference_batch
from .runner import apply_flags, compared
from .manifest import HERE, load, read_json
from .reference import stream as ref


def compared_index(config: dict, traffic: dict, seed: int) -> int:
    """The stream position of the batch a run with ``seed`` compares, found
    by the run's own rule (:func:`.runner.compared`) from the reference's
    host draws."""
    from pathlib import Path

    compare = traffic.get("compare", {})
    spec = ref.stream_spec(config["dataset"]["generator"])
    n_subjects = len([p for p in Path(config["dataset"]["bids_path"]).glob("sub-*") if p.is_dir()])
    for index, meta in ref.host_draws(spec, seed, int(traffic["batch_size"]), n_subjects,
                                      min(int(traffic.get("mix_subjects", 1)), n_subjects)):
        if compared(index, meta.get("motion_on"), seed, compare):
            return index
    raise AssertionError("unreachable")


def control_numbers(config: dict, traffic: dict, seed: int, device, mode: str = "fp8") -> dict:
    """The compared numbers of the reference in ``mode`` against the f32 reference."""
    index = compared_index(config, traffic, seed)
    low = reference_batch(config, traffic, seed, index, device, mode)
    high = reference_batch(config, traffic, seed, index, device, None)

    def pairs():
        for (_, image, label), (_, r_image, r_label) in zip(low, high):
            yield image, label, r_image, r_label

    return {"index": index, **distances(pairs())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The control's compared numbers, one line per seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["fp8", "tf32"], choices=("fp8", "tf32", "bf16"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load(HERE.parent / "BENCHMARK.json").workload(args.workload)
    config = read_json("configs", cell["config"])
    traffic = read_json("traffic", cell["traffic"])
    limits = read_json("checks", cell["name"])["limits"]
    os.environ.update(config.get("env", {}))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    apply_flags(torch, config.get("torch_flags", {}))
    for seed in args.seeds:
        for mode in args.modes:
            t0 = time.perf_counter()
            nums = control_numbers(config, traffic, seed, args.device, mode)
            fails = sorted(k for k, lim in limits.items() if not nums[k] <= lim)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode, **nums, "fails": fails,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
