"""Cast all seed NIfTIs under a directory to int8 (port of
``fetalsyngen_tpu.scripts.resize_seeds``; host only).

    python -m fetalsyngen_torch.scripts.resize_seeds <seed dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..io import nifti


def main(argv=None):
    ap = argparse.ArgumentParser(description="Cast the seeds to int8")
    ap.add_argument("path", type=str, help="Directory containing seed files")
    args = ap.parse_args(argv)

    files = sorted(Path(args.path).glob("**/*.nii.gz"))
    CH = 16  # batched through the native threaded gzip writer
    for i0 in range(0, len(files), CH):
        chunk = files[i0 : i0 + CH]
        imgs = [nifti.load(p) for p in chunk]
        nifti.save_batch(
            chunk,
            [np.asarray(im.data).astype(np.int8) for im in imgs],
            [im.affine for im in imgs],
        )
        print(f"[{min(i0 + CH, len(files))}/{len(files)}] {chunk[-1]}")


if __name__ == "__main__":
    main()
