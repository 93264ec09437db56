"""Rigid-transform algebra (host-side NumPy; copy of
``fetalsyngen_tpu.generator.artifacts.transforms``, held equal to it by the
CPU tests).

Reference parity for the SVoRT transform stack
(``fetalsyngen/generator/artifacts/svort/transform/transform.py:14-489`` and
``transform_convert.py:24-161``). These are tiny per-slice 3x4 matrices used
to orchestrate the scanner simulation; they live on the host (NumPy + scipy
Rotation) while the voxel-scale work they parameterize runs on TPU. The
reference's CUDA extension ``transform_convert_cuda`` (axis-angle <-> matrix
with analytic gradients) is unnecessary here: conversions are vectorized
NumPy/scipy and nothing differentiates through them in the generator.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

TRANSFORM_EPS = 1e-6


def axisangle2mat(axisangle: np.ndarray) -> np.ndarray:
    """(N, 6) [rotvec | translation] -> (N, 3, 4) [R | t] (Rodrigues)."""
    axisangle = np.asarray(axisangle, dtype=np.float64)
    rot = Rotation.from_rotvec(axisangle[:, :3]).as_matrix()
    mat = np.concatenate([rot, axisangle[:, 3:, None]], axis=-1)
    return mat.astype(np.float32)


def mat2axisangle(mat: np.ndarray) -> np.ndarray:
    """(N, 3, 4) -> (N, 6); inverse of :func:`axisangle2mat`."""
    mat = np.asarray(mat, dtype=np.float64)
    rv = Rotation.from_matrix(mat[:, :, :3]).as_rotvec()
    return np.concatenate([rv, mat[:, :, 3]], axis=-1).astype(np.float32)


class RigidTransform:
    """Batch of rigid transforms with the reference's trans-first convention.

    ``trans_first=True`` means the transform maps ``x -> R (x + t)``.
    """

    def __init__(self, data: np.ndarray, trans_first: bool = True):
        data = np.asarray(data, dtype=np.float32)
        self.trans_first = trans_first
        if data.ndim == 2 and data.shape[1] == 6:
            self._axisangle = data
            self._matrix = None
        elif data.ndim == 3 and data.shape[1] == 3:
            self._axisangle = None
            self._matrix = data
        else:
            raise ValueError("Unknown format for rigid transform!")

    def matrix(self, trans_first: bool = True) -> np.ndarray:
        mat = self._matrix if self._matrix is not None else axisangle2mat(self._axisangle)
        if self.trans_first and not trans_first:
            mat = mat_first2last(mat)
        elif not self.trans_first and trans_first:
            mat = mat_last2first(mat)
        return mat

    def axisangle(self, trans_first: bool = True) -> np.ndarray:
        if self._axisangle is not None and trans_first == self.trans_first:
            return self._axisangle.copy()
        return mat2axisangle(self.matrix(trans_first))

    def inv(self) -> "RigidTransform":
        mat = self.matrix(trans_first=True)
        R = mat[:, :, :3]
        t = mat[:, :, 3:]
        # reference transform.py:53-58
        inv = np.concatenate([np.swapaxes(R, -2, -1), -np.matmul(R, t)], axis=-1)
        return RigidTransform(inv, trans_first=True)

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """self o other in the reference's trans-first composition
        (``transform.py:60-70``): R = R1 R2, t = t2 + R2^T t1."""
        mat1 = self.matrix(True)
        mat2 = other.matrix(True)
        R1, t1 = mat1[:, :, :3], mat1[:, :, 3:]
        R2, t2 = mat2[:, :, :3], mat2[:, :, 3:]
        R = np.matmul(R1, R2)
        t = t2 + np.matmul(np.swapaxes(R2, -2, -1), t1)
        return RigidTransform(np.concatenate([R, t], axis=-1), trans_first=True)

    def __getitem__(self, idx) -> "RigidTransform":
        if self._axisangle is not None:
            data = self._axisangle[idx]
            if data.ndim < 2:
                data = data[None]
        else:
            data = self._matrix[idx]
            if data.ndim < 3:
                data = data[None]
        return RigidTransform(data, self.trans_first)

    def __len__(self) -> int:
        data = self._axisangle if self._axisangle is not None else self._matrix
        return data.shape[0]

    @staticmethod
    def cat(transforms) -> "RigidTransform":
        mats = [t.matrix(True) for t in transforms]
        return RigidTransform(np.concatenate(mats, 0), trans_first=True)

    def mean(self, trans_first: bool = True, simple_mean: bool = True) -> "RigidTransform":
        ax = self.axisangle(trans_first)
        if simple_mean:
            ax_mean = ax.mean(0, keepdims=True)
        else:
            meanT = ax[:, 3:].mean(0, keepdims=True)
            meanR = average_rotation(ax[:, :3])
            ax_mean = np.concatenate([meanR, meanT], axis=-1)
        return RigidTransform(ax_mean.astype(np.float32), trans_first=trans_first)


def mat_first2last(mat: np.ndarray) -> np.ndarray:
    R, t = mat[:, :, :3], mat[:, :, 3:]
    return np.concatenate([R, np.matmul(R, t)], axis=-1)


def mat_last2first(mat: np.ndarray) -> np.ndarray:
    R, t = mat[:, :, :3], mat[:, :, 3:]
    return np.concatenate([R, np.matmul(np.swapaxes(R, -2, -1), t)], axis=-1)


def mat_update_resolution(mat: np.ndarray, res_from: float, res_to: float) -> np.ndarray:
    """Rescale the translation column (reference ``transform.py:162-167``)."""
    out = np.array(mat, copy=True)
    out[..., 3] *= res_from / res_to
    return out


def mat_transform_points(mat: np.ndarray, x: np.ndarray, trans_first: bool) -> np.ndarray:
    R = mat[..., :-1]
    T = mat[..., -1:]
    x = x[..., None]
    if trans_first:
        x = np.matmul(R, x + T)
    else:
        x = np.matmul(R, x) + T
    return x[..., 0]


def random_angle(n: int, restricted: bool, rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotations as rotvecs (reference ``transform.py:178-188``)."""
    a = 2 * np.pi * rng.random(n)
    b = np.arccos(2 * rng.random(n) - 1)
    c = np.pi * rng.random(n) if restricted else np.pi * (2 * rng.random(n) - 1)
    R = Rotation.from_euler("ZXZ", np.stack([a, b, c], -1))
    return R.as_rotvec().astype(np.float32)


def random_init_stack_transforms(
    n_slice: int, gap: float, restricted: bool, txy: float, rng: np.random.Generator
) -> RigidTransform:
    """Random stack orientation + per-slice z offsets (``transform.py:359-369``)."""
    angle = np.broadcast_to(random_angle(1, restricted, rng), (n_slice, 3))
    tz = (np.arange(n_slice, dtype=np.float32) - (n_slice - 1) / 2.0) * gap
    if txy:
        tx = np.full_like(tz, rng.uniform(-txy, txy))
        ty = np.full_like(tz, rng.uniform(-txy, txy))
    else:
        tx = ty = np.zeros_like(tz)
    t = np.stack([tx, ty, tz], -1)
    return RigidTransform(np.concatenate([angle, t], -1), trans_first=True)


def reset_transform(transform: RigidTransform) -> RigidTransform:
    """Zero rotations/xy, center z (reference ``transform.py:386-390``)."""
    ax = transform.axisangle()
    ax[:, :-1] = 0
    ax[:, -1] -= ax[:, -1].mean()
    return RigidTransform(ax)


def average_rotation(rotvecs: np.ndarray) -> np.ndarray:
    """Quaternion-mean rotation average (simplified reference
    ``transform.py:301-336``; the iterative refinement is skipped — the
    generator only uses simple means)."""
    q = Rotation.from_rotvec(rotvecs).as_quat()
    for i in range(q.shape[0]):
        if np.linalg.norm(q[i] + q[0]) < np.linalg.norm(q[i] - q[0]):
            q[i] *= -1
    bar = q.mean(0)
    bar /= np.linalg.norm(bar)
    return Rotation.from_quat(bar).as_rotvec()[None].astype(np.float32)


def interleave_index(N: int, n_i: int) -> list[int]:
    """Interleaved acquisition order (reference ``svort/data/utils.py:18-27``)."""
    idx = [0] * N
    t = 0
    for i in range(n_i):
        j = i
        while j < N:
            idx[j] = t
            t += 1
            j += n_i
    return idx
