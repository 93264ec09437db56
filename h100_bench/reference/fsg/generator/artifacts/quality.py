"""SR-quality artifacts: BlurCortex, StructNoise, SimulatedBoundaries (port of
``fetalsyngen_tpu.generator.artifacts.quality``).

Reference parity with ``fetalsyngen/generator/augmentation/artifacts.py``:
each class is callable as ``artifact(output, seg, genparams=..., rng=...,
seed=...)`` on one (D, H, W) volume and returns ``(output, metadata)``. The
scalar draws come from the numpy ``rng`` in the JAX package's order, so the
same ``rng`` gives the same metadata. The voxel-scale draws come from
``torch.Generator``s seeded from ``seed`` and the JAX package's
``fold_in`` tags (:mod:`.draws`); ``draws`` (a dict) hands in fixed tensors
instead, as the tests do with JAX's own draws:

- ``BlurCortex``: ``"u"``, the (D*H*W,) uniforms of the weighted top-k;
- ``StructNoise``: ``"pyramid"`` (one normal lattice per noise level, None
  for a level gated off), ``"perlin"`` (:func:`draw_fractal_uniforms`) or
  ``"centers"`` (uniforms of :func:`masked_random_centers`);
- ``SimulatedBoundaries``: ``"keep"`` (one boolean mask per fuzzy round)
  and ``"centers"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops.linops import gaussian_blur_mm, zoom_mm
from ...ops.morphology import ball_dilate, box_sum, dilate, erode
from ...ops.noise import draw_fractal_uniforms, fractal_noise_3d, mog_3d
from ...ops.numerics import device_const
from .draws import derive_seed, make_generator

F32 = torch.float32


@dataclass
class StructNoiseMergeParams:
    merge_type: str
    gauss_nloc_min: int | None = None
    gauss_nloc_max: int | None = None
    gauss_sigma_mu: float | None = None
    gauss_sigma_std: float | None = None
    perlin_res_list: list | None = None
    perlin_octaves_list: list | None = None
    perlin_persistence: float | None = None
    perlin_lacunarity: int | None = None
    perlin_increase_size: float | None = None


@dataclass
class ReconMergeParams:
    merge_type: str
    gauss_ngaussians_min: int | None = None
    gauss_ngaussians_max: int | None = None
    perlin_res_list: list | None = None
    perlin_octaves_list: list | None = None
    perlin_persistence: float | None = None
    perlin_lacunarity: int | None = None
    perlin_increase_size: float | None = None


def _pinned(genparams: dict) -> dict:
    """The genparams without None entries (reference ``model.py:85-92``)."""
    return {k: v for k, v in (genparams or {}).items() if v is not None}


def _volume(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def topk_flat(scores: torch.Tensor, k: int):
    """Exact top-k of a flat f32 score vector (values, indices), descending,
    equal scores in index order as XLA's top-k orders them. Uniform draws
    tie often (a float below 1 has 2^24 values, a 256^3 volume 2^24 voxels),
    and ``torch.topk`` orders ties differently on the card and the CPU, so
    the ranking runs on int64 keys: the score's order-preserving integer
    above the reversed index. The JAX package's blocked prefilter is a TPU
    speed device with the same output outside a collision case its
    docstring bounds."""
    bits = scores.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = 2**32 - 1 - torch.arange(scores.numel(), device=scores.device, dtype=torch.int64)
    _, idx = torch.topk(key * 2**32 + rev, k)
    return scores[idx], idx


def masked_random_centers(u: torch.Tensor, mask: torch.Tensor, n_max: int, n_valid: int):
    """Up to ``n_max`` random voxel coordinates inside ``mask``: the top-k of
    the uniforms ``u`` (one per voxel) masked to the foreground. Returns
    (centers (n_max, 3) f32 in (i, j, k) order, valid (n_max,) bool)."""
    shape = mask.shape
    flat = mask.reshape(-1) > 0
    scores = torch.where(flat, u.reshape(-1), -1.0)
    _, idx = topk_flat(scores, n_max)
    valid = flat[idx] & (torch.arange(n_max, device=mask.device) < n_valid)
    hw = shape[1] * shape[2]
    rem = idx % hw
    centers = torch.stack([idx // hw, rem // shape[2], rem % shape[2]], -1).to(F32)
    return centers, valid


# --------------------------------------------------------------------------
# BlurCortex (reference artifacts.py:24-133)
# --------------------------------------------------------------------------


class BlurCortex:
    """Local cortex blurring (imprecise-reconstruction look)."""

    MAX_BLUR = 200

    def __init__(
        self,
        prob: float,
        cortex_label: int,
        nblur_min: int,
        nblur_max: int,
        sigma_gamma_loc: float = 3,
        sigma_gamma_scale: float = 1,
        std_blur_shape: float = 2,
        std_blur_scale: float = 1,
    ):
        self.prob = prob
        self.cortex_label = cortex_label
        self.nblur_min = nblur_min
        self.nblur_max = nblur_max
        self.sigma_gamma_loc = sigma_gamma_loc
        self.sigma_gamma_scale = sigma_gamma_scale
        self.std_blur_shape = std_blur_shape
        self.std_blur_scale = std_blur_scale

    def apply(self, u, output, seg, nblur: int, std_blurs, sigmas) -> torch.Tensor:
        """Blur ``output`` inside Gaussians centred on ``nblur`` cortex voxels
        picked by weighted top-k of the uniforms ``u`` (keys ``log(u)/w``,
        ``w`` a frontal-lobe-biased mixture, ``artifacts.py:64-81``)."""
        shape = tuple(output.shape)
        dev = output.device
        x, y, z = shape
        prob_field = mog_3d(
            shape,
            device_const([[0.0, y, z / 2.0], [x, y, z / 2.0]], F32, dev),
            device_const([[x / 5.0] * 3, [y / 5.0] * 3], F32, dev),
        )
        w = torch.where((seg == self.cortex_label).reshape(-1), prob_field.reshape(-1), 0.0)
        scores = torch.where(w > 0, torch.log(u) / torch.clamp_min(w, 1e-8), -torch.inf)
        _, idx = topk_flat(scores, self.MAX_BLUR)
        valid = (torch.arange(self.MAX_BLUR, device=dev) < nblur) & torch.isfinite(scores[idx])
        hw = shape[1] * shape[2]
        rem = idx % hw
        centers = torch.stack([idx // hw, rem // shape[2], rem % shape[2]], -1).to(F32)
        gaussian = mog_3d(shape, centers, sigmas, valid)
        # half_len 25 covers 3 sigma of the unclipped gamma(2, 1) draw out to
        # sigma ~ 8.3, as in the JAX package
        blurred = gaussian_blur_mm(output[None], std_blurs[None], 25)[0]
        return output * (1 - gaussian) + blurred * gaussian

    def __call__(self, output, seg, genparams=None, rng=None, seed=None, draws=None, **kw):
        genparams = _pinned(genparams)
        rng = rng or np.random.default_rng()
        if not (rng.random() < self.prob or len(genparams) > 0):
            return output, {"nblur": None}
        # draw-then-override: a pin must not skip a draw
        nblur = int(rng.integers(self.nblur_min, self.nblur_max))
        nblur = int(genparams.get("nblur", nblur))
        std_blurs = rng.gamma(self.std_blur_shape, self.std_blur_scale, 3)
        sigmas = rng.gamma(self.sigma_gamma_loc, self.sigma_gamma_scale, (self.MAX_BLUR, 3))
        seed = int(rng.integers(2**31)) if seed is None else seed
        output = _volume(output)
        dev = output.device
        u = (draws or {}).get("u")
        if u is None:
            u = torch.rand(output.numel(), generator=make_generator(seed, dev), device=dev)
            u = torch.clamp_min(u, 1e-7)  # log(u) finite, as JAX's minval
        out = self.apply(
            u, output, torch.as_tensor(seg, device=dev), nblur,
            device_const(std_blurs, F32, dev), device_const(np.maximum(sigmas, 1e-2), F32, dev),
        )
        return out, {"nblur": nblur, "std_blurs": std_blurs.tolist()}


# --------------------------------------------------------------------------
# StructNoise (reference artifacts.py:136-342)
# --------------------------------------------------------------------------


def _pyramid_shapes(shape, nmax: int):
    """The lattice shape of each of the ``nmax`` noise levels, coarsest first,
    and the grid each is zoomed to."""
    return [
        (tuple(max(s // 2 ** (nmax - k), 1) for s in shape),
         tuple(max(s // 2 ** (nmax - 1 - k), 1) for s in shape))
        for k in range(nmax)
    ]


def draw_pyramid_normals(gen, shape, nstages: int, nmax: int, device):
    """Standard normals for the noise levels that ``nstages`` turns on (the
    last ``nstages`` of ``nmax``); None for the others."""
    return [
        torch.randn(cur, generator=gen, device=device) if nmax - k <= nstages else None
        for k, (cur, _) in enumerate(_pyramid_shapes(shape, nmax))
    ]


def multiscale_noise(shape, normals, nmax: int) -> torch.Tensor:
    """Pyramid noise (``artifacts.py:308-322``): the level normals summed at
    doubling scales with ``myzoom``-style trilinear upsampling, normalized by
    the largest magnitude. A level gated off adds exactly zero in the JAX
    package, so it is left out here."""
    dev = next(n.device for n in normals if n is not None)
    levels = _pyramid_shapes(shape, nmax)
    noise = torch.zeros(levels[0][0], dtype=F32, device=dev)
    for (cur, nxt), n in zip(levels, normals):
        if n is not None:
            noise = noise + n
        factor = device_const([[a / b for a, b in zip(nxt, cur)]], F32, dev)
        noise = zoom_mm(noise[None], nxt, factor, device_const([cur], F32, dev))[0]
    return noise / torch.abs(noise).max()


class StructNoise:
    """Spatially-varying multi-scale noise in the white matter."""

    MAX_LOC = 20

    def __init__(
        self,
        prob: float,
        wm_label: int,
        std_min: float,
        std_max: float,
        merge_params: StructNoiseMergeParams,
        nstages_min: int = 1,
        nstages_max: int = 5,
    ):
        self.prob = prob
        self.wm_label = wm_label
        self.std_min = std_min
        self.std_max = std_max
        self.nstages_min = nstages_min
        self.nstages_max = nstages_max
        self.merge_params = merge_params

    def __call__(self, output, seg, genparams=None, rng=None, seed=None, draws=None, **kw):
        genparams = _pinned(genparams)
        rng = rng or np.random.default_rng()
        draws = draws or {}
        if not (rng.random() < self.prob or "nloc" in genparams or "nstages" in genparams):
            return output, {}
        nstages = int(rng.integers(self.nstages_min, self.nstages_max))
        nstages = int(genparams.get("nstages", nstages))
        noise_std = self.std_min + (self.std_max - self.std_min) * rng.random()
        seed = int(rng.integers(2**31)) if seed is None else seed
        output = _volume(output)
        dev = output.device
        shape = tuple(output.shape)
        seg = torch.as_tensor(seg, device=dev)

        normals = draws.get("pyramid")
        if normals is None:
            gen = make_generator(derive_seed(seed, 1), dev)
            normals = draw_pyramid_normals(gen, shape, nstages, self.nstages_max, dev)
        noise = multiscale_noise(shape, normals, self.nstages_max)
        noisy = torch.minimum(torch.clamp_min(output + noise_std * noise, 0.0), output.max() * 2)

        meta = {"nstages": nstages, "noise_std": noise_std}
        mp = self.merge_params
        if mp.merge_type == "perlin":
            # draw-then-override (see BlurCortex)
            res = int(rng.choice(mp.perlin_res_list))
            octave = int(rng.choice(mp.perlin_octaves_list))
            res = int(genparams.get("res", res))
            octave = int(genparams.get("octave", octave))
            lattices = (res, res, res)
            uniforms = draws.get("perlin")
            if uniforms is None:
                uniforms = draw_fractal_uniforms(
                    make_generator(derive_seed(seed, 2), dev), shape, lattices, octave,
                    mp.perlin_lacunarity, max(mp.perlin_octaves_list), dev,
                )
            weight = fractal_noise_3d(
                shape, lattices, uniforms, mp.perlin_persistence, mp.perlin_lacunarity,
                mp.perlin_increase_size,
            )
            meta.update({"res": res, "octave": octave})
        else:
            nloc = int(rng.integers(mp.gauss_nloc_min, mp.gauss_nloc_max))
            nloc = int(genparams.get("nloc", nloc))
            u = draws.get("centers")
            if u is None:
                u = torch.rand(shape, generator=make_generator(derive_seed(seed, 3), dev), device=dev)
            centers, valid = masked_random_centers(u, seg == self.wm_label, self.MAX_LOC, nloc)
            sigmas = np.clip(
                mp.gauss_sigma_mu + mp.gauss_sigma_std * rng.standard_normal((self.MAX_LOC, 1)), 1, 40
            )
            weight = mog_3d(shape, centers, device_const(sigmas, F32, dev), valid)
            meta["nloc"] = nloc

        mask = (seg > 0).to(F32)
        return (1 - mask * weight) * output + mask * weight * noisy, meta


# --------------------------------------------------------------------------
# SimulatedBoundaries (reference artifacts.py:428-604)
# --------------------------------------------------------------------------


def draw_keep(gen, shape, device) -> torch.Tensor:
    """The shell voxels one fuzzy round keeps: 10% at random (bool)."""
    return torch.rand(tuple(shape), generator=gen, device=device) < 0.1


def fuzzy_once(mask: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """One fuzzy-boundary round (``artifacts.py:501-522``): the kept part of
    the dilation shell, neighbour-count filtered, then a closing."""
    shell = (dilate(mask, 7) - mask) * keep.to(torch.int32)
    dsamp = (box_sum(shell, 3) > 3).to(torch.int32)
    return erode(dilate(torch.clamp(mask + dsamp, 0, 1), 5), 5)


class SimulatedBoundaries:
    """No-mask / halo / fuzzy-boundary masking of the skull-stripped volume."""

    MAX_CENTERS = 160
    MAX_DILATE = 24

    def __init__(self, prob_no_mask: float, prob_if_mask_halo: float, prob_if_mask_fuzzy: float):
        self.prob_no_mask = prob_no_mask
        self.prob_halo = prob_if_mask_halo
        self.prob_fuzzy = prob_if_mask_fuzzy

    def __call__(self, output, seg, genparams=None, rng=None, seed=None, draws=None, **kw):
        rng = rng or np.random.default_rng()
        draws = draws or {}
        seed = int(rng.integers(2**31)) if seed is None else seed
        output = _volume(output)
        dev = output.device
        mask = (torch.as_tensor(seg, device=dev) > 0).to(torch.int32)

        no_mask_on = bool(rng.random() < self.prob_no_mask)
        meta = {"no_mask_on": no_mask_on, "halo_on": None, "fuzzy_on": None}
        if no_mask_on:
            return output, meta
        halo_on = bool(rng.random() < self.prob_halo)
        fuzzy_on = bool(rng.random() < self.prob_fuzzy)
        meta.update({"halo_on": halo_on, "fuzzy_on": fuzzy_on})

        if halo_on:
            mask = ball_dilate(mask, int(rng.integers(5, 15)))

        if fuzzy_on:
            n_generate_fuzzy = int(rng.integers(2, 5))
            n_centers = min(int(rng.poisson(100)), self.MAX_CENTERS)
            base_sigma = max(int(rng.poisson(8)), 1)

            keeps = draws.get("keep")
            if keeps is None:
                keeps = [
                    draw_keep(make_generator(derive_seed(seed, 10 + r), dev), mask.shape, dev)
                    for r in range(n_generate_fuzzy)
                ]
            mask_modif = mask
            for keep in keeps:
                mask_modif = fuzzy_once(mask_modif, keep)

            added = ((mask_modif - mask) > 0).to(torch.int32)
            u = draws.get("centers")
            if u is None:
                u = torch.rand(mask.shape, generator=make_generator(derive_seed(seed, 20), dev), device=dev)
            centers, valid = masked_random_centers(u, added, self.MAX_CENTERS, n_centers)
            sigmas = base_sigma + 10 * rng.beta(2, 5, (self.MAX_CENTERS, 1))
            mog = mog_3d(tuple(mask.shape), centers, device_const(sigmas, F32, dev), valid)
            surf_proba = torch.where(added > 0, mog, 0.0)

            # dilation stack intersected with the fuzzy mask (artifacts.py:582-602):
            # a voxel is kept if the dilation step that reaches it is <= its level
            n_dilate = min(6 * (n_generate_fuzzy - 1), self.MAX_DILATE)
            levels = torch.clamp_min(
                torch.round(surf_proba * (n_dilate + 2) - 1).to(torch.int32), 0
            )
            cur = mask
            reach = torch.where(mask > 0, 0, self.MAX_DILATE + 10).to(torch.int32)
            for i in range(n_dilate):
                cur = ball_dilate(cur, 1) if i >= 2 else cur
                reach = torch.where((reach > i) & (cur > 0), i, reach).to(torch.int32)
            mask = ((reach <= levels) & (mask_modif > 0)).to(torch.int32) | mask

        return output * mask, meta
