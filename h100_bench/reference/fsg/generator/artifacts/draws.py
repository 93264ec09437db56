"""Seeds and generators of the artifacts' device draws.

The JAX package derives each device stream from a key with
``jax.random.fold_in(key, tag)``. The port derives an integer seed from a
parent seed and the same tags (:func:`derive_seed`) and draws from a
``torch.Generator`` on the artifact's device (:func:`make_generator`). Torch
cannot reproduce threefry, and its CUDA and CPU generators differ, so every
device draw sits in a ``draw_*`` function whose tensors the compute functions
take as arguments: a test hands in the JAX package's draws instead.
"""

from __future__ import annotations

import numpy as np
import torch


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed determined by ``seed`` and ``tags``."""
    state = np.random.SeedSequence([int(seed), *(int(t) for t in tags)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def make_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
