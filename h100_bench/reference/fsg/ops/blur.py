"""Separable Gaussian blur with fixed-shape (mask-truncated) kernels (port of
``fetalsyngen_tpu.ops.blur``).

The reference (``make_gaussian_kernel`` / ``gaussian_blur_3d``,
``fetalsyngen/utils/generation.py:74-110``) builds a kernel of length
``2*ceil(3*sigma)+1`` per call. Here the kernel has a fixed length
``2*half_len+1`` with the taps beyond ``ceil(3*sigma)`` zeroed and the rest
normalised over the truncated support: the same taps, zero-padded. ``sigma
== 0`` gives the identity (the reference skips the convolution).

Batch-first, as :func:`fetalsyngen_torch.ops.linops.gaussian_blur_mm` (the
production form, banded matmuls): volumes are (B, D, H, W), stds (B, 3). The
convolution is a 'same' convolution with zero padding, a sum of shifted
slices in f32.
"""

from __future__ import annotations

import math

import torch


def gaussian_kernel_fixed(sigma, half_len: int) -> torch.Tensor:
    """Truncated, normalised Gaussian taps over a static window.

    ``sigma``: std(s) >= 0, a tensor of any shape (or a float);
    ``half_len >= ceil(3 * max sigma)``. Returns ``sigma.shape + (2*half_len
    + 1,)`` f32 taps: ``make_gaussian_kernel`` zero-padded to the window,
    the one-hot centre where ``sigma == 0``.
    """
    sigma = torch.as_tensor(sigma, dtype=torch.float32)[..., None]
    t = torch.arange(-half_len, half_len + 1, dtype=torch.float32, device=sigma.device)
    sl = torch.ceil(3.0 * sigma)
    safe = torch.where(sigma > 0, sigma, 1.0)
    g = torch.exp(-((t / safe) ** 2) / 2.0)
    g = torch.where(torch.abs(t) <= sl, g, 0.0)
    g = g / torch.sum(g, dim=-1, keepdim=True)
    return torch.where(sigma > 0, g, (t == 0).to(torch.float32))


def _conv_axis(vol: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D 'same' convolution (zero padding) of (B, D, H, W) ``vol`` along
    spatial ``axis`` with per-sample (B, K) taps (or (K,) shared), as
    ``lax.conv_general_dilated``: ``out[i] = sum_k kernel[k] * vol[i + k -
    half]``."""
    K = kernel.shape[-1]
    half = (K - 1) // 2
    kernel = kernel.to(vol.dtype).expand(vol.shape[0], K)
    x = vol.movedim(1 + axis, -1)
    n = x.shape[-1]
    padded = torch.nn.functional.pad(x, (half, half))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + kernel[:, k, None, None, None] * padded[..., k : k + n]
    return out.movedim(-1, 1 + axis)


def gaussian_blur_3d(vol: torch.Tensor, stds: torch.Tensor, half_len: int) -> torch.Tensor:
    """Separable 3-D Gaussian blur of (B, D, H, W) ``vol`` with per-axis
    stds, (B, 3) (or (3,) for every sample): three 1-D 'same' convolutions
    with zero padding, axis 0 first; an axis with ``std == 0`` is the
    identity. ``half_len >= ceil(3 * max std)`` (:func:`blur_half_len`)."""
    stds = torch.as_tensor(stds, dtype=torch.float32, device=vol.device)
    for axis in range(3):
        vol = _conv_axis(vol, gaussian_kernel_fixed(stds[..., axis], half_len), axis)
    return vol


def blur_half_len(max_sigma: float) -> int:
    """Static kernel half-length covering ``ceil(3 * max_sigma)``."""
    return int(math.ceil(3.0 * max_sigma))
