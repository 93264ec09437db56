"""Throughput smoke script (reference ``fetalsyngen/test_dl.py``): time a full
pass over the dataset. The reference forks DataLoader workers around one GPU;
forked workers cannot use the parent's CUDA context, so this script draws the
samples in a sequential loop in one process.

    python -m fetalsyngen_torch.test_dl --config configs/dataset/synth_train.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from fetalsyngen_torch.test import add_arguments, load_dataset


def main():
    ap = argparse.ArgumentParser()
    add_arguments(ap)
    ap.add_argument("--epochs", type=int, default=1)
    args = ap.parse_args()

    dataset = load_dataset(args)

    _ = dataset[0]  # warm-up: kernel build and first allocations

    start = time.time()
    n = 0
    for _ in range(args.epochs):
        for i in range(len(dataset)):
            _ = dataset[i]
            n += 1
    dt = time.time() - start
    print(f"Time taken for dataloader: {dt:.2f} seconds ({n / dt:.2f} samples/s)")


if __name__ == "__main__":
    main()
