"""Binary morphology on (D, H, W) voxel grids (port of ``fetalsyngen_tpu.ops.morphology``).

Reference parity with ``fetalsyngen/generator/artifacts/utils.py:163-210``:
``box_sum`` (the cube box-sum convolution), ``erode`` and ``dilate`` factor
into three 1-D box sums, applied as banded matmuls; ``ball_dilate`` (the
``skimage.ball`` halo of ``artifacts.py:484-499``) thresholds a squared
distance transform built from three 1-D min-plus passes. Counts and squared
distances are small integers, exact in f32, so every result is exact.
"""

from __future__ import annotations

import torch

from .linops import axis_mm, f32_scope

_BIG = 1e9  # "no foreground within reach" in the squared distance


def _box_matrix(size: int, k: int, device) -> torch.Tensor:
    """(size, size) 'same' box-sum operator of width k (zero padding)."""
    r = torch.arange(size, device=device)
    return ((r[None, :] - r[:, None]).abs() <= k // 2).to(torch.float32)


def box_sum(vol: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """== ``apply_kernel`` (``utils.py:163-171``): cube box-sum convolution,
    f32 whatever the caller's scopes (``linops.f32_scope``, as the JAX
    package pins it)."""
    vol = vol.to(torch.float32)
    with f32_scope():
        for axis in range(3):
            vol = axis_mm(vol, _box_matrix(vol.shape[axis], kernel_size, vol.device), axis)
    return vol


def erode(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """== ``erode`` (``utils.py:174-191``): cube erosion via box-sum == k^3 (int32)."""
    s = box_sum(mask, kernel_size)
    return (torch.round(s).to(torch.int32) == kernel_size**3).to(torch.int32)


def dilate(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """== ``dilate`` (``utils.py:194-210``): cube dilation via box-sum > 0 (int32)."""
    return (box_sum(mask, kernel_size) > 0.5).to(torch.int32)


def ball_dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilation with an exact Euclidean ball (== conv with ``skimage.ball``
    then ``> 0``): the squared distance to the nearest foreground voxel,
    restricted to the radius, from one min-plus pass per axis with offsets
    ``off`` in ``[-radius, radius]`` (cost ``off^2``), then a threshold."""
    d2 = torch.where(mask > 0, 0.0, _BIG).to(torch.float32)
    for axis in range(3):
        n = d2.shape[axis]
        acc = d2.clone()
        for off in range(1, min(radius, n - 1) + 1):
            cost = float(off * off)
            # acc[i] <- min(acc[i], d2[i - off] + off^2) and min(acc[i], d2[i + off] + off^2)
            hi, lo = acc.narrow(axis, off, n - off), acc.narrow(axis, 0, n - off)
            torch.minimum(hi, d2.narrow(axis, 0, n - off) + cost, out=hi)
            torch.minimum(lo, d2.narrow(axis, off, n - off) + cost, out=lo)
        d2 = acc
    return (d2 <= radius * radius + 1e-3).to(torch.int32)
