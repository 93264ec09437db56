"""Recorded fetal-motion trajectory sampling (host-side; copy of
``fetalsyngen_tpu.generator.artifacts.motion`` with its own byte-identical
``motion_traj.npz``, both held equal to the originals by the CPU tests).

The reference ships 154 rotation + 154 translation trajectories recorded from
real fetal scans as pickled scipy ``interp1d`` objects
(``svort/data/fetal_motion.py:14-48``, ``traj.npy``). Here the same recorded
data lives as plain knot arrays in ``motion_traj.npz`` (converted once from
the reference data asset) and interpolation is ``np.interp`` per component —
no pickle, no scipy object dependency.
"""

from __future__ import annotations

import functools
import os

import numpy as np
from scipy.spatial.transform import Rotation

from .transforms import RigidTransform

_TRAJ_PATH = os.path.join(os.path.dirname(__file__), "motion_traj.npz")


@functools.lru_cache(maxsize=1)
def get_trajectory():
    data = np.load(_TRAJ_PATH)
    return {k: data[k] for k in data.files}


def _interp_traj(values, offsets, idx, t):
    knots = values[offsets[idx] : offsets[idx + 1]]
    x = np.arange(knots.shape[0], dtype=np.float64)
    return np.stack([np.interp(t, x, knots[:, c]) for c in range(3)], -1)


def sample_motion(ts: np.ndarray, rng: np.random.Generator, rand: bool = True) -> RigidTransform:
    """Sample a motion trajectory at time points ``ts`` (seconds).

    Mirrors ``sample_motion`` (``fetal_motion.py:22-48``): pick a recorded
    trajectory, random time offset, random axis permutation and sign flips,
    then re-reference to the first time point.
    """
    d = get_trajectory()
    dT = float(d["dT"])

    # rotation (Euler xyz angles along the trajectory)
    idx = int(rng.integers(len(d["rot_T"])))
    T = float(d["rot_T"][idx])
    t0 = rng.uniform(0, T - ts[-1] / dT) if rand else 0.0
    R = _interp_traj(d["rot_values"], d["rot_offsets"], idx, t0 + ts / dT)
    if rand:
        R = R[:, rng.permutation(3)]
        R = R * (2 * (rng.random((1, 3)) < 0.5) - 1)
    Rm = Rotation.from_euler("xyz", R).as_matrix()

    # translation
    idx = int(rng.integers(len(d["trans_T"])))
    T = float(d["trans_T"][idx])
    t0 = rng.uniform(0, T - ts[-1] / dT) if rand else 0.0
    trans = _interp_traj(d["trans_values"], d["trans_offsets"], idx, t0 + ts / dT)
    if rand:
        trans = trans[:, rng.permutation(3)]
        trans = trans * (2 * (rng.random((1, 3)) < 0.5) - 1)

    # re-reference to the first slice (fetal_motion.py:43-44)
    Rm = np.matmul(Rm, np.swapaxes(Rm[0], -2, -1))
    trans = trans - trans[0]

    mats = np.concatenate([Rm, trans[:, :, None]], axis=-1).astype(np.float32)
    return RigidTransform(mats, trans_first=False)
