"""Separable voxel operators as batched matmuls (port of ``fetalsyngen_tpu.ops.linops``).

Every separable 1-D operation of the pipeline (Gaussian blur, zoom,
anisotropic resample) is a banded ``(out, in)`` operator along one axis,
built per sample from tensor parameters and contracted with ``torch.einsum``.
Operators are (B, out, in); volumes are (B, D, H, W). The contract is f32
throughout: callers on the GPU keep TF32 off.

Semantics match the reference kernels:
- ``toeplitz_blur_matrix`` == truncated ``make_gaussian_kernel`` + 'same' conv
  (``generation.py:74-110``);
- ``interp_matrix(oob_zero=True)`` == ``fast_3D_interp_torch`` linear-mode
  per-axis factor on a product grid (``generation.py:227-288``);
- ``interp_matrix(oob_zero=False)`` == ``myzoom_torch`` clamped interpolation
  (``generation.py:310-397``).
"""

from __future__ import annotations

import torch

from .interp import zoom_coords


def toeplitz_blur_matrix(sigma: torch.Tensor, size: int, half_len: int) -> torch.Tensor:
    """(B, size, size) 'same'-conv Gaussian operators for (B,) sigmas.

    Row i holds the truncated normalized kernel centred at i; ``sigma == 0``
    yields the identity.
    """
    dev = sigma.device
    sigma = sigma[:, None]
    t = torch.arange(-half_len, half_len + 1, dtype=torch.float32, device=dev)[None, :]
    sl = torch.ceil(3.0 * sigma)
    safe = torch.where(sigma > 0, sigma, 1.0)
    g = torch.exp(-((t / safe) ** 2) / 2.0)
    g = torch.where(torch.abs(t) <= sl, g, 0.0)
    g = g / torch.sum(g, dim=1, keepdim=True)
    kernel = torch.where(sigma > 0, g, (t == 0).to(torch.float32))

    rows = torch.arange(size, device=dev)[:, None]
    cols = torch.arange(size, device=dev)[None, :]
    idx = cols - rows + half_len
    valid = (idx >= 0) & (idx <= 2 * half_len)
    taps = kernel[:, torch.clamp(idx, 0, 2 * half_len)]
    return torch.where(valid, taps, 0.0)


def interp_matrix(
    coords: torch.Tensor,
    in_size: int,
    in_valid: torch.Tensor | None = None,
    out_valid: torch.Tensor | None = None,
    oob_zero: bool = False,
) -> torch.Tensor:
    """(B, out, in_size) linear-interpolation operators at (B, out) ``coords``.

    ``in_valid`` / ``out_valid`` are (B,) logical extents (clamping uses the
    input one; output rows past the output one are zeroed). ``oob_zero``
    zeroes rows whose coordinate is not inside ``(0, valid-1]`` (the
    reference's linear-mode OOB rule) instead of clamping them.
    """
    B, out = coords.shape
    dev = coords.device
    if in_valid is None:
        hi = torch.full((B, 1), in_size - 1, dtype=torch.float32, device=dev)
    else:
        hi = (in_valid - 1).to(torch.float32)[:, None]
    ok = (coords > 0) & (coords <= hi)
    c = torch.clamp(coords, min=torch.zeros_like(hi), max=hi)
    f = torch.clamp(torch.floor(c), min=torch.zeros_like(hi), max=hi - 1.0)
    w = c - f
    fi = f.to(torch.int64)[:, :, None]

    cols = torch.arange(in_size, device=dev)[None, None, :]
    W = (cols == fi).to(torch.float32) * (1.0 - w)[:, :, None] + (cols == fi + 1).to(
        torch.float32
    ) * w[:, :, None]
    if oob_zero:
        W = W * ok[:, :, None]
    if out_valid is not None:
        rows = torch.arange(out, device=dev)[None, :, None]
        W = W * (rows < out_valid[:, None, None])
    return W


_AXIS_SPEC = {0: "boi,bijk->bojk", 1: "boi,bjik->bjok", 2: "boi,bjki->bjko"}


def apply_axis_matrix(vol: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract spatial ``axis`` of ``vol`` (B, D, H, W) with ``M`` (B, out, in)."""
    return torch.einsum(_AXIS_SPEC[axis], M, vol)


def interp_matrix_1d(coords: torch.Tensor, in_size: int, out_valid: int | None = None) -> torch.Tensor:
    """Unbatched :func:`interp_matrix` (the SR artifacts' form): (out,
    in_size) at (out,) ``coords``, clamped; rows at or past ``out_valid``
    are zero."""
    valid = None if out_valid is None else torch.full((1,), out_valid, device=coords.device)
    return interp_matrix(coords[None], in_size, out_valid=valid)[0]


def axis_mm(vol: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """Unbatched :func:`apply_axis_matrix`: (D, H, W) ``vol``, (out, in) ``M``."""
    return apply_axis_matrix(vol[None], M[None], axis)[0]


def apply_separable(vol: torch.Tensor, Ms) -> torch.Tensor:
    """Apply one operator per spatial axis (order 0, 1, 2)."""
    for axis, M in enumerate(Ms):
        vol = apply_axis_matrix(vol, M, axis)
    return vol


def gaussian_blur_mm(vol: torch.Tensor, stds: torch.Tensor, half_len: int) -> torch.Tensor:
    """Separable Gaussian blur with (B, 3) per-axis stds."""
    Ms = tuple(toeplitz_blur_matrix(stds[:, a], vol.shape[1 + a], half_len) for a in range(3))
    return apply_separable(vol, Ms)


def zoom_mm(
    vol: torch.Tensor, out_shape: tuple[int, int, int], factor: torch.Tensor, in_shape: torch.Tensor
) -> torch.Tensor:
    """``myzoom_torch``-style zoom of (B, d, h, w) to ``out_shape`` with
    (B, 3) factors; ``in_shape`` (B, 3) is the logical input extent."""
    Ms = tuple(
        interp_matrix(zoom_coords(out_shape[a], factor[:, a]), vol.shape[1 + a], in_valid=in_shape[:, a])
        for a in range(3)
    )
    return apply_separable(vol, Ms)
