"""A Gaussian mixture of 1-D data, fitted by EM on the device: the port's
counterpart of the one scikit-learn call that ``generate_seeds`` makes,
``GaussianMixture(n_components=k, n_init=5, init_params="k-means++")
.fit_predict(x[:, None])`` on float32 intensities.

Two parts, with scikit-learn's (1.9) arithmetic:

- :func:`kmeans_plusplus` picks each init's starting points on the host in
  numpy. It makes scikit-learn's ``_kmeans_plusplus`` calls on its
  ``RandomState`` in the same order and its float32 potentials with the same
  numpy calls, so one ``random_state`` gives scikit-learn's indices exactly.
  Its squared distances are computed in float64 and rounded to float32, as
  ``_euclidean_distances`` does for float32 input: other distances would
  break ties in ``searchsorted`` differently.
- :func:`fit_em` runs the EM of the ``n_init`` inits together along a leading
  dimension, in float32, each init frozen at its own convergence (``|Δ| <
  tol`` of the mean log-likelihood, or ``max_iter``), with one host read a
  iteration. The EM draws nothing, so drawing every init's picks first keeps
  scikit-learn's stream of draws.

:func:`fit_predict` chains the two, keeps the init with the highest lower
bound (the first on ties) and labels each value by a final E-step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..train.step import resolve_device

N_INIT = 5
TOL = 1e-3
REG_COVAR = 1e-6
MAX_ITER = 100
_EPS = float(np.finfo(np.float32).eps)
_LOG_2PI = math.log(2 * math.pi)


def check_random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: None is numpy's global
    ``RandomState``, an int seeds a new one, an instance is used as it is."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _sq_dist(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(len(c), len(x)) float32 squared distances of 1-D float32 values, as
    scikit-learn's ``_euclidean_distances(..., squared=True)`` computes them
    for float32 input: ``-2 c x + c² + x²`` in float64, rounded to float32,
    negatives clipped to 0."""
    c64 = c.astype(np.float64)[:, None]
    x64 = x.astype(np.float64)[None, :]
    d = -2 * (c64 * x64)
    d += c64 * c64
    d += x64 * x64
    d = d.astype(np.float32)
    np.maximum(d, 0, out=d)
    return d


def kmeans_plusplus(x: np.ndarray, k: int, random_state=None) -> np.ndarray:
    """The indices into ``x`` (1-D float32) of ``k`` greedy k-means++ starting
    points: scikit-learn's ``kmeans_plusplus(x[:, None], k,
    random_state=random_state)[1]``, with unit sample weights and ``2 +
    int(log k)`` local trials."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    n = x.size
    if n < k:
        raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
    rs = check_random_state(random_state)
    w = np.ones(n, dtype=np.float32)
    n_local_trials = 2 + int(np.log(k))
    indices = np.full(k, -1, dtype=int)
    indices[0] = rs.choice(n, p=w / w.sum())
    closest = _sq_dist(x[indices[:1]], x)
    current_pot = closest @ w
    for c in range(1, k):
        rand_vals = rs.uniform(size=n_local_trials) * current_pot
        candidates = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(candidates, None, closest.size - 1, out=candidates)
        dist = _sq_dist(x[candidates], x)
        np.minimum(closest, dist, out=dist)
        pots = dist @ w.reshape(-1, 1)
        best = np.argmin(pots)
        current_pot = pots[best]
        closest = dist[best]
        indices[c] = candidates[best]
    return indices


def _logsumexp(a: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``_logsumexp`` over the last axis: the maxima counted
    apart, ``log1p(Σ exp(a - max) / m) + log(m) + max`` over the m maxima."""
    amax = a.amax(-1, keepdim=True)
    at_max = a == amax
    m = at_max.sum(-1, keepdim=True, dtype=a.dtype)
    shift = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = torch.exp(a.masked_fill(at_max, -math.inf) - shift).sum(-1, keepdim=True)
    s = torch.where(s == 0, s, s / m)
    return (torch.log1p(s) + torch.log(m) + amax).squeeze(-1)


def _e_step(x, weights, means, prec):
    """(log p(x) (I, N), log responsibilities (I, N, k)) of each init's
    mixture; x (N,), the parameters (I, k)."""
    y = x[None, :, None] * prec[:, None, :] - (means * prec)[:, None, :]
    wlp = -0.5 * (_LOG_2PI + y * y) + torch.log(prec)[:, None, :] + torch.log(weights)[:, None, :]
    lpn = _logsumexp(wlp)
    return lpn, wlp - lpn[..., None]


def _moments(x, resp):
    """scikit-learn's ``_estimate_gaussian_parameters`` (full covariances of
    one feature): nk (with its ``10 eps``), means and variances (with
    ``reg_covar``) of responsibilities ``resp`` (I, N, k)."""
    nk = resp.sum(1) + 10 * _EPS
    means = (resp * x[None, :, None]).sum(1) / nk
    diff = x[None, :, None] - means[:, None, :]
    var = (resp * diff * diff).sum(1) / nk + REG_COVAR
    return nk, means, var


def _precision_chol(var):
    return 1.0 / torch.sqrt(var)


def init_params(x: torch.Tensor, indices: torch.Tensor):
    """Each init's starting (weights, means, Cholesky precisions), each
    (I, k), from its k-means++ ``indices`` (I, k): scikit-learn's
    ``_initialize`` on one-hot responsibilities (each variance is then
    ``reg_covar``; the weights are ``nk / n``, not renormalised)."""
    nk = torch.full(indices.shape, 1 + 10 * _EPS, dtype=x.dtype, device=x.device)
    xi = x[indices]
    means = xi / nk
    diff = xi - means
    var = diff * diff / nk + REG_COVAR
    return nk / x.numel(), means, _precision_chol(var)


@dataclass
class EMResult:
    """The EM of each init: its parameters at its end, its lower bound (the
    mean log-likelihood of its last E-step) and its iterations. Tensors are
    (I, k) or (I,) on the fit's device."""

    weights: torch.Tensor
    means: torch.Tensor
    prec: torch.Tensor
    lower_bound: torch.Tensor
    n_iter: torch.Tensor

    @property
    def variances(self) -> torch.Tensor:
        return 1.0 / (self.prec * self.prec)


def fit_em(x: torch.Tensor, weights, means, prec) -> EMResult:
    """EM from each init's (weights, means, Cholesky precisions) (I, k) on
    the values ``x`` (N,) float32, all inits at once: an init stops when its
    lower bound moves by less than TOL or after MAX_ITER iterations,
    and keeps the parameters of its last M-step (scikit-learn's loop)."""
    n_init = weights.shape[0]
    lb = torch.full((n_init,), -math.inf, dtype=x.dtype, device=x.device)
    n_iter = torch.zeros(n_init, dtype=torch.int32, device=x.device)
    active = torch.ones(n_init, dtype=torch.bool, device=x.device)
    for _ in range(MAX_ITER):
        lpn, log_resp = _e_step(x, weights, means, prec)
        nk, m, var = _moments(x, torch.exp(log_resp))
        new_lb = lpn.mean(1)
        a = active[:, None]
        weights = torch.where(a, nk / nk.sum(1, keepdim=True), weights)
        means = torch.where(a, m, means)
        prec = torch.where(a, _precision_chol(var), prec)
        done = active & ((new_lb - lb).abs() < TOL)
        lb = torch.where(active, new_lb, lb)
        n_iter += active.to(torch.int32)
        active &= ~done
        if not bool(active.any()):  # the iteration's one host read
            break
    return EMResult(weights, means, prec, lb, n_iter)


def best_init(lower_bound) -> int:
    """scikit-learn's choice among the inits: the highest lower bound, the
    first on ties (and the first while the best so far is -inf)."""
    best, best_lb = 0, -math.inf
    for i, v in enumerate(lower_bound):
        if v > best_lb or best_lb == -math.inf:
            best, best_lb = i, v
    return best


@dataclass
class GMMFit:
    """A :func:`fit_predict`: each value's component, the winning init, each
    init's k-means++ indices (I, k) and its EM."""

    labels: torch.Tensor
    best: int
    indices: np.ndarray
    em: EMResult


def fit_predict(x: np.ndarray, k: int, random_state=None, device="cuda") -> GMMFit:
    """Fit a ``k``-component mixture to the 1-D values ``x`` (cast to float32)
    from N_INIT k-means++ inits and label each value by its most probable
    component: ``GaussianMixture(n_components=k, n_init=N_INIT,
    init_params="k-means++", random_state=random_state).fit_predict(x[:, None])``.
    The picks are drawn on the host, the EM runs on ``device``."""
    dev = resolve_device(device)
    x_np = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x_np.size < max(k, 2):
        raise ValueError(f"Expected n_samples >= n_components but got n_components = {k}, n_samples = {x_np.size}")
    rs = check_random_state(random_state)
    indices = np.stack([kmeans_plusplus(x_np, k, rs) for _ in range(N_INIT)])
    xt = torch.from_numpy(x_np).to(dev)
    em = fit_em(xt, *init_params(xt, torch.from_numpy(indices).to(dev)))
    best = best_init(em.lower_bound.tolist())
    pick = slice(best, best + 1)
    _, log_resp = _e_step(xt, em.weights[pick], em.means[pick], em.prec[pick])
    return GMMFit(log_resp[0].argmax(-1), best, indices, em)
