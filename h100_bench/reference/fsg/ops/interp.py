"""Batched 3-D interpolation (port of ``fetalsyngen_tpu.ops.interp``).

``trilinear_interp`` / ``nearest_interp`` are the reference's
``fast_3D_interp_torch`` (``generation.py:204-288``) for ``warp_impl='exact'``:
plain gathers, with the reference's linear-mode OOB rule (a voxel is valid iff
``0 < x <= D-1`` on every axis). All volumes and coordinates are (B, D, H, W).

``zoom`` is the reference's ``myzoom_torch`` (``generation.py:310-397``) as
three clamped linear interpolations along one axis each
(:func:`interp_axis_linear`), the gather twin of ``linops.zoom_mm``.
"""

from __future__ import annotations

import torch

from .numerics import device_const


def _corner_indices(coord: torch.Tensor, size: int):
    """Floor index (clamped to size-2) and fractional weight."""
    f = torch.clamp(torch.floor(coord), 0, size - 2)
    return f.to(torch.int64), coord - f


def gather_trilinear(vol: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Trilinear sample of ``vol`` (B, D, H, W) at in-range float coords."""
    B, D, H, W = vol.shape
    xf, wx = _corner_indices(x.reshape(B, -1), D)
    yf, wy = _corner_indices(y.reshape(B, -1), H)
    zf, wz = _corner_indices(z.reshape(B, -1), W)
    flat = vol.reshape(B, -1)
    base = (xf * H + yf) * W + zf
    n = flat.shape[1]

    def g(off):
        return torch.gather(flat, 1, torch.clamp(base + off, 0, n - 1))

    c000, c001 = g(0), g(1)
    c010, c011 = g(W), g(W + 1)
    c100, c101 = g(H * W), g(H * W + 1)
    c110, c111 = g(H * W + W), g(H * W + W + 1)

    c00 = c000 * (1.0 - wz) + c001 * wz
    c01 = c010 * (1.0 - wz) + c011 * wz
    c10 = c100 * (1.0 - wz) + c101 * wz
    c11 = c110 * (1.0 - wz) + c111 * wz
    c0 = c00 * (1.0 - wy) + c01 * wy
    c1 = c10 * (1.0 - wy) + c11 * wy
    return (c0 * (1.0 - wx) + c1 * wx).reshape(x.shape)


def trilinear_interp(vol, x, y, z, default_value=0.0) -> torch.Tensor:
    """``fast_3D_interp_torch(..., mode="linear")`` over a batch;
    ``default_value`` outside (a float, or a tensor broadcast against the
    (B, D, H, W) output, e.g. (B, 1, 1, 1) per sample)."""
    _, D, H, W = vol.shape
    ok = (x > 0) & (y > 0) & (z > 0) & (x <= D - 1) & (y <= H - 1) & (z <= W - 1)
    vals = gather_trilinear(
        vol, torch.clamp(x, 0, D - 1), torch.clamp(y, 0, H - 1), torch.clamp(z, 0, W - 1)
    )
    return torch.where(ok, vals, default_value).to(vol.dtype)


def nearest_interp(vol, x, y, z) -> torch.Tensor:
    """``fast_3D_interp_torch(..., mode="nearest")``: round (half to even),
    clamp to the volume, gather."""
    B, D, H, W = vol.shape
    xi = torch.clamp(torch.round(x), 0, D - 1).to(torch.int64)
    yi = torch.clamp(torch.round(y), 0, H - 1).to(torch.int64)
    zi = torch.clamp(torch.round(z), 0, W - 1).to(torch.int64)
    flat_idx = ((xi * H + yi) * W + zi).reshape(B, -1)
    return torch.gather(vol.reshape(B, -1), 1, flat_idx).reshape(x.shape)


def zoom_coords(out_size: int, factor: torch.Tensor) -> torch.Tensor:
    """(B, out_size) ``myzoom_torch`` sample positions ``delta + i / factor``
    with ``delta = (1 - factor) / (2 factor)``, for (B,) factors."""
    factor = factor[:, None]
    delta = (1.0 - factor) / (2.0 * factor)
    i = torch.arange(out_size, dtype=torch.float32, device=factor.device)[None, :]
    return delta + i / factor


def interp_axis_linear(x: torch.Tensor, coords: torch.Tensor, axis: int, in_size=None) -> torch.Tensor:
    """Linear interpolation of (B, D, H, W[, C...]) ``x`` along spatial
    ``axis`` (0-2) at float ``coords``, (B, out) per sample or (out,) for
    every sample.

    ``in_size`` (an int, or (B,) per sample) restricts the valid extent of
    the input axis (a logically smaller volume in the corner of a
    fixed-shape buffer). Coordinates are clamped to ``[0, in_size-1]`` with
    edge duplication and the lower tap to ``in_size-2``, as ``myzoom_torch``
    clamps (``generation.py:340-363``).
    """
    B, dim = x.shape[0], 1 + axis
    n = x.shape[dim]
    coords = coords.to(torch.float32)
    coords = coords.expand(B, -1) if coords.dim() == 1 else coords
    if in_size is None:
        in_size = n
    if isinstance(in_size, torch.Tensor):
        size = in_size.to(torch.float32).reshape(-1, 1)  # (B, 1) or (1, 1)
        c = torch.minimum(torch.clamp_min(coords, 0.0), size - 1.0)
        f = torch.minimum(torch.clamp_min(torch.floor(c), 0.0), size - 2.0)
    else:
        c = torch.clamp(coords, 0.0, float(in_size - 1))
        f = torch.clamp(torch.floor(c), 0.0, float(in_size - 2))
    w = (c - f).to(x.dtype)
    fi = f.to(torch.int64)
    bshape = [B, coords.shape[1]] + [1] * (x.dim() - 2)

    def take(idx):
        idx = torch.clamp(idx, 0, n - 1).reshape(bshape).movedim(1, dim)
        full = list(x.shape)
        full[dim] = coords.shape[1]
        return torch.gather(x, dim, idx.expand(full))

    w = w.reshape(bshape).movedim(1, dim)
    return take(fi) * (1.0 - w) + take(fi + 1) * w


def zoom(x: torch.Tensor, out_shape, factor=None, in_shape=None) -> torch.Tensor:
    """Separable trilinear zoom of the three spatial axes of (B, D, H, W[,
    C...]) ``x`` to ``out_shape``: ``myzoom_torch(X, factor)``
    (``generation.py:310-397``) with ``out_shape = round(X.shape * factor)``,
    its three loops as three axis interpolations (:func:`interp_axis_linear`).

    ``factor``: per-axis zoom factors, (B, 3) or (3,); default
    ``out_shape / x.shape[1:4]``. ``in_shape``: the logical input extent,
    (B, 3) or (3,), within ``x``'s (default all of it).
    """
    B = x.shape[0]
    if factor is None:
        factor = device_const([out_shape[d] / x.shape[1 + d] for d in range(3)], torch.float32, x.device)
    factor = torch.as_tensor(factor, dtype=torch.float32, device=x.device)
    factor = factor.expand(B, 3) if factor.dim() == 1 else factor
    if in_shape is not None:
        in_shape = torch.as_tensor(in_shape, device=x.device)
        in_shape = in_shape.expand(B, 3) if in_shape.dim() == 1 else in_shape
    for axis in range(3):
        coords = zoom_coords(out_shape[axis], factor[:, axis])
        x = interp_axis_linear(x, coords, axis, None if in_shape is None else in_shape[:, axis])
    return x
