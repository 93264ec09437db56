"""Train a 3D UNet on a stream of synthetic volumes (port of
``examples/train_segmentation.py``).

The generator is fused into the training step: each step synthesises its
batch on the device and trains on it, with no host data loader in the loop.
A procedural phantom stands in for data files. Data-parallel over
``torchrun``'s processes, one per device; each rank generates its rows of
the global batch.

    python -m fetalsyngen_torch.train.segmentation --steps 10 --shape 64
    python -m fetalsyngen_torch.train.segmentation --steps 3 --shape 32 --device cpu
    torchrun --nproc_per_node 2 -m fetalsyngen_torch.train.segmentation \\
        --steps 3 --shape 32 --device cpu        # gloo on the CPU; NCCL on cards

Per-step losses are noisy (every step sees a new random sample), so the run
checks that the mean of the last third is below the mean of the first.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..generator.config import GeneratorCfg, IntensityCfg
from ..parallel.sharding import data_group
from ..testing import phantom_seeds_and_seg
from .step import create_train_state, make_sharded_train_step
from .unet import UNet3D

LABELS = tuple([0] + list(range(10, 50)))
GEN_CLASSES = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))


def example_cfg(shape) -> GeneratorCfg:
    """The example's generator config: 0.5 mm, one to six subclusters."""
    return GeneratorCfg(
        shape=tuple(shape), resolution=(0.5, 0.5, 0.5), intensity=IntensityCfg(1, 6, LABELS, GEN_CLASSES)
    )


def smoothed_ends(losses) -> tuple[float, float]:
    """The means of the first and the last third of ``losses``."""
    k = max(1, len(losses) // 3)
    return float(np.mean(losses[:k])), float(np.mean(losses[-k:]))


def train(steps: int, shape, lr: float = 1e-3, batch: int = 1, device=None, channels=(8, 16, 32)) -> list[float]:
    """``steps`` fused steps of ``UNet3D(channels)`` on the phantom, ``batch``
    volumes per rank, weights and phantom from seed 0; returns the losses
    (global-batch means)."""
    g = data_group(device)
    shape = tuple(shape)
    cfg = example_cfg(shape)
    model = UNet3D(channels=channels, n_classes=8)
    state = create_train_state(0, model, shape, lr, g.device)
    step = make_sharded_train_step(state, cfg, g)
    seeds_np, seg_np = phantom_seeds_and_seg(shape, seed=0)
    B = batch * g.world
    seeds = torch.from_numpy(seeds_np.astype(np.int32)).to(g.device).expand(B, *shape)
    segs = torch.from_numpy(seg_np.astype(np.int32)).to(g.device).expand(B, *shape)
    if g.rank == 0:
        print(f"ranks: {g.world} ({g.device.type}), batch {B}, shape {shape}")
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step([1 + B * i + b for b in range(B)], seeds, segs)
        losses.append(float(loss))
        if g.rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f}  ({time.perf_counter() - t0:.1f}s)")
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--shape", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=1, help="volumes per rank")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    distributed = int(os.environ.get("WORLD_SIZE", 1)) > 1
    rank = 0
    if distributed:
        cuda = args.device is None or args.device.startswith("cuda")
        if cuda:
            # bind the process to its card before NCCL creates the group: a
            # group made first sets up its communicator on cuda:0 in every rank
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo")
        rank = dist.get_rank()
    try:
        losses = train(args.steps, (args.shape,) * 3, args.lr, args.batch, args.device)
    finally:
        if distributed:
            dist.destroy_process_group()
    head, tail = smoothed_ends(losses)
    if not tail < head:
        raise SystemExit(f"loss should trend down on the synthetic stream ({head:.4f} -> {tail:.4f})")
    if rank == 0:
        print(f"OK: loss trended down {head:.4f} -> {tail:.4f}")


if __name__ == "__main__":
    main()
