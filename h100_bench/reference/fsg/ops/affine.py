"""Batched affine matrices and centered grids (port of ``fetalsyngen_tpu.ops.affine``)."""

from __future__ import annotations

import torch


def _mat(rows) -> torch.Tensor:
    """Stack a 3x3 nested list of (B,) tensors into a (B, 3, 3) tensor."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def make_affine_matrix(rot: torch.Tensor, sh: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Build the (B, 3, 3) affines ``diag(s) @ SHx @ SHy @ SHz @ Rx @ Ry @ Rz``.

    Same composition and shear index layout as the reference
    (``generation.py:39-71``). ``rot`` (radians), ``sh`` and ``s`` are (B, 3).
    """
    rot = rot.to(torch.float32)
    sh = sh.to(torch.float32)
    s = s.to(torch.float32)
    cx, sx = torch.cos(rot[:, 0]), torch.sin(rot[:, 0])
    cy, sy = torch.cos(rot[:, 1]), torch.sin(rot[:, 1])
    cz, sz = torch.cos(rot[:, 2]), torch.sin(rot[:, 2])
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    Rx = _mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = _mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = _mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])

    SHx = _mat([[one, zero, zero], [sh[:, 1], one, zero], [sh[:, 2], zero, one]])
    SHy = _mat([[one, sh[:, 0], zero], [zero, one, zero], [zero, sh[:, 2], one]])
    SHz = _mat([[one, zero, sh[:, 0]], [zero, one, sh[:, 1]], [zero, zero, one]])

    A = SHx @ SHy @ SHz @ Rx @ Ry @ Rz
    return A * s[:, :, None]


def centered_grid(shape: tuple[int, int, int], device):
    """Centered ij-indexed grids ``xc[i,j,k] = i - (D-1)/2`` etc., as
    broadcastable (D,1,1), (1,H,1), (1,1,W) f32 tensors."""
    D, H, W = shape
    xc = torch.arange(D, dtype=torch.float32, device=device)[:, None, None] - (D - 1) / 2.0
    yc = torch.arange(H, dtype=torch.float32, device=device)[None, :, None] - (H - 1) / 2.0
    zc = torch.arange(W, dtype=torch.float32, device=device)[None, None, :] - (W - 1) / 2.0
    return xc, yc, zc
