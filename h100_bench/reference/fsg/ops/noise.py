"""Structured noise fields: Perlin/fractal noise and mixture-of-Gaussian maps
(port of ``fetalsyngen_tpu.ops.noise``).

- :func:`perlin_noise_3d` / :func:`fractal_noise_3d` ==
  ``generate_perlin_noise_3d`` / ``generate_fractal_noise_3d``
  (``utils.py:224-388``) in the JAX package's separable form: three small
  per-axis fade operators upsample each gradient-component lattice.
- :func:`mog_3d` == ``mog_3d_tensor`` (``utils.py:125-160``) with centers in
  (i, j, k) grid order.

The lattice's random gradient angles are arguments: ``draw_perlin_uniforms``
and ``draw_fractal_uniforms`` fill them from a ``torch.Generator``, and a
test hands in the JAX package's own draws instead. The contractions take the
matmul precision scope (``linops.prec_einsum``), as the JAX package's
``precision=_prec()`` does.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .linops import prec_einsum
from .numerics import device_const


@lru_cache(maxsize=64)
def _perlin_axis_mats(s: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis (s, r) fade-interpolation operators: ``A`` holds the fade
    weights, ``Ad`` the fade-weighted displacements (JAX's
    ``_perlin_axis_mats``; the ``% r`` wrap makes the field tileable)."""
    c = s // r
    i = np.arange(s)
    i0 = i // c
    d = (i % c) / c
    t = d * d * d * (d * (d * 6 - 15) + 10)
    A = np.zeros((s, r), np.float32)
    Ad = np.zeros((s, r), np.float32)
    np.add.at(A, (i, i0), 1 - t)
    np.add.at(A, (i, (i0 + 1) % r), t)
    np.add.at(Ad, (i, i0), (1 - t) * d)
    np.add.at(Ad, (i, (i0 + 1) % r), t * (d - 1))
    return A, Ad


def draw_perlin_uniforms(gen: torch.Generator, res, device):
    """The two (r0, r1, r2) uniform lattices of one Perlin field (the
    gradients' azimuth and polar angles over 2 pi)."""
    return tuple(torch.rand(tuple(res), generator=gen, device=device) for _ in range(2))


def perlin_noise_3d(shape, res, uniforms) -> torch.Tensor:
    """Tileable 3D Perlin noise of ``shape`` (divisible by ``res``) from the
    lattice uniforms ``(u_theta, u_phi)``."""
    u_theta, u_phi = uniforms
    dev = u_theta.device
    theta = 2 * math.pi * u_theta
    phi = 2 * math.pi * u_phi
    gx = torch.sin(phi) * torch.cos(theta)
    gy = torch.sin(phi) * torch.sin(theta)
    gz = torch.cos(phi)
    mats = [
        tuple(device_const(m, torch.float32, dev) for m in _perlin_axis_mats(shape[d], res[d]))
        for d in range(3)
    ]

    def up(g, M0, M1, M2):
        t = prec_einsum("Ia,abc->Ibc", M0, g)
        t = prec_einsum("Jb,Ibc->IJc", M1, t)
        return prec_einsum("Kc,IJc->IJK", M2, t)

    (A0, A0d), (A1, A1d), (A2, A2d) = mats
    return up(gx, A0d, A1, A2) + up(gy, A0, A1d, A2) + up(gz, A0, A1, A2d)


def fractal_lattices(shape, res, octaves: int, lacunarity: int = 2, max_octaves: int = 4):
    """The lattice shape of each octave ``o < min(octaves, max_octaves)``
    that still divides the grid (JAX's loop stops at the first that does not)."""
    out = []
    frequency = 1
    for _ in range(min(int(octaves), max_octaves)):
        if any(s % (frequency * r) or frequency * r > s for s, r in zip(shape, res)):
            break
        out.append(tuple(frequency * r for r in res))
        frequency *= lacunarity
    return out


def draw_fractal_uniforms(gen, shape, res, octaves, lacunarity=2, max_octaves=4, device=None):
    """One :func:`draw_perlin_uniforms` pair per octave of :func:`fractal_lattices`."""
    return [
        draw_perlin_uniforms(gen, lat, device)
        for lat in fractal_lattices(shape, res, octaves, lacunarity, max_octaves)
    ]


def fractal_noise_3d(
    shape, res, uniforms, persistence: float = 0.5, lacunarity: int = 2, increase: float = 0.0
) -> torch.Tensor:
    """Multi-octave Perlin normalized to [0, 1] (``utils.py:330-388``): one
    octave per entry of ``uniforms`` (:func:`draw_fractal_uniforms`), the
    lattice ``lacunarity`` times finer and the amplitude ``persistence`` times
    smaller each octave. An octave the JAX package gates off adds exactly
    zero there, so leaving it out gives the same field."""
    noise = None
    frequency = 1
    amplitude = 1.0
    for u in uniforms:
        term = amplitude * perlin_noise_3d(shape, tuple(frequency * r for r in res), u)
        noise = term if noise is None else noise + term
        frequency *= lacunarity
        amplitude *= persistence
    dev = uniforms[0][0].device if uniforms else None
    if noise is None:
        noise = torch.zeros(tuple(shape), dtype=torch.float32, device=dev)
    lo, hi = noise.min(), noise.max()
    noise = (noise + increase - lo) / (hi - lo)
    return torch.clamp(noise, 0.0, 1.0)


def mog_3d(shape, centers: torch.Tensor, sigmas: torch.Tensor, valid: torch.Tensor | None = None):
    """Sum of axis-aligned Gaussians clipped to [0, 1] (``utils.py:125-160``):
    ``centers`` (N, 3) in (i, j, k) order, ``sigmas`` broadcastable to (N, 3),
    ``valid`` an optional (N,) mask. The mixture factors per axis into a
    rank-N contraction."""
    centers = centers.to(torch.float32)
    sigmas = torch.broadcast_to(sigmas.to(torch.float32).to(centers.device), centers.shape)
    dev = centers.device

    def axis_factor(axis):
        g = torch.arange(shape[axis], dtype=torch.float32, device=dev)[None, :]
        return torch.exp(-0.5 * ((g - centers[:, axis : axis + 1]) / sigmas[:, axis : axis + 1]) ** 2)

    fx = axis_factor(0)
    if valid is not None:
        fx = fx * valid[:, None].to(torch.float32)
    t = fx[:, :, None] * axis_factor(1)[:, None, :]
    return torch.clamp(prec_einsum("ndh,nw->dhw", t, axis_factor(2)), 0.0, 1.0)
