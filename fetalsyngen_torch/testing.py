"""Procedural seed/label volumes (port of ``fetalsyngen_tpu.testing.phantom_seeds_and_seg``).

Numpy only; the same seed gives the same arrays as the JAX package's
function, so both packages can be driven on identical inputs.
"""

from __future__ import annotations

import numpy as np


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
