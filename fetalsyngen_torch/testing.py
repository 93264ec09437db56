"""Procedural test data (copies of ``fetalsyngen_tpu.testing``'s builders).

Numpy only; the same seed or rng gives the same arrays and files as the JAX
package's functions, so both packages can be driven on identical inputs.
:func:`build_bids_tree` writes a mini-BIDS tree with the layout of the
in-repo ``data/`` fixture (``sub-*/anat/*_T2w.nii.gz``, ``*_dseg.nii.gz``,
``derivatives/seeds/subclasses_N/sub-*/anat/*_mlabel_M.nii.gz``), so the
dataset API runs without external data.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE_SHAPE = (64, 64, 64)
FIXTURE_SUBJECTS = ("sub-aaa", "sub-bbb")
FIXTURE_N_SUBCLASSES = (1, 2)


def make_phantom(rng: np.random.Generator, shape=FIXTURE_SHAPE):
    """Sphere-in-sphere phantom: seg labels 0..7, plausible T2w-ish image."""
    zz = np.stack(
        np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    )
    r = np.sqrt((zz**2).sum(0))
    seg = np.zeros(shape, dtype=np.int16)
    seg[r < 0.9] = 1  # CSF
    seg[r < 0.7] = 2  # GM
    seg[r < 0.5] = 3  # WM
    seg[r < 0.2] = 4  # deep
    img = (seg.astype(np.float32) * 60 + rng.normal(0, 5, shape)).clip(0, 255)
    return img.astype(np.float32), seg


def build_bids_tree(
    root: Path, rng: np.random.Generator | None = None, shape=FIXTURE_SHAPE
) -> Path:
    """Write a complete mini-BIDS tree (images, dseg, seed derivative tree)."""
    from .io import nifti

    rng = rng or np.random.default_rng(7)
    affine = np.diag([0.5, 0.5, 0.5, 1.0])
    for sub in FIXTURE_SUBJECTS:
        anat = root / sub / "anat"
        anat.mkdir(parents=True, exist_ok=True)
        img, seg = make_phantom(rng, shape)
        nifti.save(anat / f"{sub}_T2w.nii.gz", img, affine)
        nifti.save(anat / f"{sub}_dseg.nii.gz", seg, affine)
        for n_sub in FIXTURE_N_SUBCLASSES:
            for mlabel in range(1, 5):
                sdir = root / "derivatives" / "seeds" / f"subclasses_{n_sub}" / sub / "anat"
                sdir.mkdir(parents=True, exist_ok=True)
                # seeds for meta-label m live in [10*m, 10*m + n_sub)
                seed = np.zeros(shape, dtype=np.int8)
                region = seg == mlabel
                labels = 10 * mlabel + rng.integers(0, n_sub, size=int(region.sum()))
                seed[region] = labels.astype(np.int8)
                nifti.save(sdir / f"{sub}_dseg_mlabel_{mlabel}.nii.gz", seed, affine)
    return root


def phantom_seeds_and_seg(shape=(256, 256, 256), seed: int = 0):
    """Procedural (seeds, segmentation) pair shaped like real preprocessed data.

    Concentric-ellipsoid anatomy with per-meta-label subcluster seeds in the
    reference's label layout (meta-label m -> labels ``10*m .. 10*m+2``,
    ``rand_gmm.py:77``) and a FeTA-like 0..7 segmentation.
    """
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    scales = 0.8 + 0.2 * rng.random(3)  # random ellipsoid radii per call
    r = np.sqrt(sum((g / s) ** 2 for g, s in zip(grids, scales)))

    seg = np.zeros(shape, dtype=np.int16)
    radii = [0.95, 0.8, 0.62, 0.45, 0.3, 0.18, 0.08]
    for lab, rad in enumerate(radii, start=1):
        seg[r < rad] = lab

    # meta-label partition: skull/extra (4), CSF (1), GM (2), WM (3)
    meta = np.zeros(shape, dtype=np.int16)
    meta[(seg == 1) | (seg == 4)] = 1
    meta[(seg == 2) | (seg == 6)] = 2
    meta[(seg == 3) | (seg == 5) | (seg == 7)] = 3
    meta[(r >= 0.95) & (r < 1.05)] = 4

    seeds = np.zeros(shape, dtype=np.int16)
    mask = meta > 0
    sub = rng.integers(0, 3, size=int(mask.sum()))  # three subclusters per meta-label
    seeds[mask] = (10 * meta[mask] + sub).astype(np.int16)
    return seeds, seg
