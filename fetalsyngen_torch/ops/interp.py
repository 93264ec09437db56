"""Batched 3-D interpolation (port of ``fetalsyngen_tpu.ops.interp``).

``trilinear_interp`` / ``nearest_interp`` are the reference's
``fast_3D_interp_torch`` (``generation.py:204-288``) for ``warp_impl='exact'``:
plain gathers, with the reference's linear-mode OOB rule (a voxel is valid iff
``0 < x <= D-1`` on every axis). All volumes and coordinates are (B, D, H, W).
"""

from __future__ import annotations

import torch


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


def trilinear_interp(vol, x, y, z) -> torch.Tensor:
    """``fast_3D_interp_torch(..., mode="linear")`` over a batch; 0 outside."""
    _, D, H, W = vol.shape
    ok = (x > 0) & (y > 0) & (z > 0) & (x <= D - 1) & (y <= H - 1) & (z <= W - 1)
    vals = gather_trilinear(
        vol, torch.clamp(x, 0, D - 1), torch.clamp(y, 0, H - 1), torch.clamp(z, 0, W - 1)
    )
    return torch.where(ok, vals, 0.0).to(vol.dtype)


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
