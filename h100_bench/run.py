"""Run one cell of ``BENCHMARK.json``.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. The last line of standard output is the run's
result (JSON); the last lines of standard error are the numbers that
decided ``correct``, each beside its limit. The run fails, printing no
result, without as many CUDA devices as the cell asks for, and if JAX or
the JAX package was loaded into the process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_T0 = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "fetalsyngen_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def _since_start():
    from .runner import process_clock

    t = process_clock()
    return t if t is not None else time.perf_counter() - _T0


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .check import print_checks
    from .manifest import HERE, load, read_json

    bench = load(HERE.parent / "BENCHMARK.json")
    cell = bench.workload(args.workload)
    config = read_json("configs", cell["config"])
    traffic = read_json("traffic", cell["traffic"])
    limits = read_json("checks", cell["name"])["limits"]
    os.environ.update(config.get("env", {}))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    from .runner import run

    result = run(cell, config, traffic, limits, bench.metrics(cell["name"], trace=bool(args.trace)), args.seed,
                 args.seconds, bool(args.trace), _since_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures fetalsyngen_torch alone", file=sys.stderr)
        return 3
    card = _card()  # after the window: set-up times the program, not the benchmark's tools
    print(f"card: {card}", file=sys.stderr)
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    print_checks(checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
