"""A cell's configuration and traffic cut to a CPU test's size: the port's
phantom BIDS tree at 32^3, the motion engine at one 64 tier. The tests that
run a cell at this size warm up one batch (``runner.WARMUP_BATCHES``)."""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np

from h100_bench.manifest import read_json

SHAPE = [32, 32, 32]


def tree(root: Path) -> Path:
    """The phantom tree (two subjects, subcluster counts 1 and 2) under ``root``."""
    from fetalsyngen_torch.testing import build_bids_tree

    if not (root / "derivatives").exists():
        root.mkdir(parents=True, exist_ok=True)
        build_bids_tree(root, np.random.default_rng(0), shape=tuple(SHAPE))
    return root


def config(name: str, root: Path, device: str = "cpu") -> dict:
    c = copy.deepcopy(read_json("configs", name))
    ds = c["dataset"]
    ds["bids_path"] = str(root)
    ds["seed_path"] = str(root / "derivatives" / "seeds")
    gen = ds["generator"]
    gen["device"] = device
    gen["shape"] = list(SHAPE)
    gen["spatial_deform"]["size"] = list(SHAPE)
    gen["spatial_deform"]["device"] = device
    gen["intensity_generator"]["max_subclusters"] = 2
    if "simulate_motion" in gen:
        gen["simulate_motion"]["tiers"] = [64]
        gen["simulate_motion"]["ns_grid"] = 32
    return c


def traffic(name: str, batch_size: int = 2) -> dict:
    t = copy.deepcopy(read_json("traffic", name))
    t["batch_size"] = batch_size
    t["compare"]["pick_from"] = 2
    return t
