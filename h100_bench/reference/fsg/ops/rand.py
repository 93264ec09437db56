"""Closed-form samplers for the stream's small non-uniform draws (port of
``fetalsyngen_tpu.ops.rand``).

The artifact chain draws a handful of gamma, Poisson and beta scalars per
sample (reference ``fetalsyngen/generator/augmentation/artifacts.py:104,110,
499-585`` uses host NumPy). The JAX package samples them in closed form from
uniforms:

- integer-shape gamma: Gamma(k, 1) == -log(product of k uniforms), one
  uniform tensor per term, each clamped at 1e-12 (exact law);
- Poisson: inverse CDF against a cumulative table of ``kmax + 1`` terms;
- integer beta: Beta(a, b) == G_a / (G_a + G_b) from integer gammas.

Each sampler here is a function of explicit uniforms, so a test can hand in
the JAX package's own; the ``draw_*`` helpers fill them from a
``torch.Generator``. For a non-integer shape, where the JAX package calls
``jax.random.gamma``, :func:`gamma_mt` samples the same law by
Marsaglia-Tsang rejection with a bounded number of rounds.
"""

from __future__ import annotations

import math

import torch

U_MIN = 1e-12  # gamma_int's clamp: log(u) stays finite
MT_ROUNDS = 8  # Marsaglia-Tsang rounds; each rejects with probability < 0.05


def draw_uniforms(gen: torch.Generator, k: int, shape, device) -> list[torch.Tensor]:
    """``k`` uniform tensors of ``shape`` on ``device``, clamped at 1e-12."""
    return [torch.rand(tuple(shape), generator=gen, device=device).clamp_min_(U_MIN) for _ in range(int(k))]


def gamma_int(uniforms) -> torch.Tensor:
    """Gamma(k, 1) for integer k from its ``k`` uniform tensors: ``-sum(log u)``,
    accumulated in the JAX package's order."""
    acc = None
    for u in uniforms:
        u = torch.clamp_min(u, U_MIN)
        acc = -torch.log(u) if acc is None else acc - torch.log(u)
    return acc


def _is_small_int(a) -> bool:
    return isinstance(a, (int, float)) and float(a).is_integer() and 1 <= a <= 32


def gamma_mt(normals, uniforms, a: float, boost=None) -> torch.Tensor:
    """Gamma(a, 1) by Marsaglia-Tsang from ``len(normals)`` rounds of
    (normal, uniform) tensors: the first accepted round's value. For
    ``a < 1`` the Gamma(a + 1) draw is scaled by ``boost ** (1 / a)``
    (``boost`` one more uniform tensor). A lane that rejects every round
    keeps its last candidate (probability below 0.05 ** rounds)."""
    a = float(a)
    shape_a = a + 1.0 if a < 1.0 else a
    d = shape_a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = done = None
    for x, u in zip(normals, uniforms):
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(torch.clamp_min(u, U_MIN)) < 0.5 * x * x + d - d * v + d * torch.log(torch.clamp_min(v, 1e-30)))
        cand = d * torch.clamp_min(v, 1e-30)
        if out is None:
            out, done = cand, ok
        else:
            out = torch.where(done, out, cand)
            done = done | ok
    if a < 1.0:
        out = out * torch.pow(torch.clamp_min(boost, U_MIN), 1.0 / a)
    return out


def gamma_fast(gen: torch.Generator, a, shape, device) -> torch.Tensor:
    """Gamma(a, 1) of ``shape``: :func:`gamma_int` when ``a`` is an integer in
    [1, 32], else :func:`gamma_mt`; the draws from ``gen``."""
    if _is_small_int(a):
        return gamma_int(draw_uniforms(gen, int(a), shape, device))
    shape = tuple(shape)
    normals = [torch.randn(shape, generator=gen, device=device) for _ in range(MT_ROUNDS)]
    uniforms = draw_uniforms(gen, MT_ROUNDS, shape, device)
    boost = draw_uniforms(gen, 1, shape, device)[0] if float(a) < 1.0 else None
    return gamma_mt(normals, uniforms, a, boost)


def poisson_icdf(u: torch.Tensor, lam, kmax: int = 256) -> torch.Tensor:
    """Poisson(lam) of the uniforms ``u`` by inverse transform on a table of
    ``kmax + 1`` terms (exact within rounding while ``P(K > kmax)`` is
    negligible); int32, the shape of ``u``."""
    k = torch.arange(kmax + 1, dtype=torch.float32, device=u.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=u.device)
    logpmf = k * torch.log(torch.clamp_min(lam, 1e-12)) - lam - torch.lgamma(k + 1.0)
    cdf = torch.cumsum(torch.exp(logpmf), 0)
    return torch.sum(u[..., None] > cdf, dim=-1).to(torch.int32)


def beta_int(uniforms_a, uniforms_b) -> torch.Tensor:
    """Beta(a, b) for integer a, b from the ``a`` and ``b`` uniform tensors
    of two integer gammas."""
    g1 = gamma_int(uniforms_a)
    g2 = gamma_int(uniforms_b)
    return g1 / (g1 + g2)


def draw_beta_int(gen: torch.Generator, a: int, b: int, shape, device) -> torch.Tensor:
    """Beta(a, b) of ``shape`` from ``gen`` (:func:`beta_int`)."""
    return beta_int(draw_uniforms(gen, a, shape, device), draw_uniforms(gen, b, shape, device))
