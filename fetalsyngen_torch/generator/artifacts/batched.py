"""The stream's SR-artifact chain (port of
``fetalsyngen_tpu.generator.artifacts.batched``).

The host classes (:mod:`.quality`, :mod:`.scanner`) follow the reference's
per-sample call structure. The stream instead runs the same artifact laws
per batch element, in the reference's order: blur_cortex -> struct_noise ->
simulate_motion -> boundaries (``fetalsyngen/generator/model.py:210-220``),
with the [0, 1] division after all of them (``datasets.py:311-312``).

Randomness. The JAX stream draws inside its program from ``fold_in`` keys.
The port draws each named value from a generator of its own
(:class:`Draws`): the scalars that pick a branch (gates, counts, radii,
lattice and octave picks) on the host from numpy, so each branch is a Python
branch, and the voxel-sized fields from a ``torch.Generator`` on the device.
Each function takes its draws through a :class:`Draws`, whose ``given``
values replace the generators: the tests hand in the JAX stream's own.

The motion engine (:func:`pack_motion`, :func:`motion_t`) packs each
sample's geometry on the host, in the smallest static cube tier covering its
slice-resolution draw or in the small isotropic px frame, and resolves the
reference's stack acceptance (``simulate_reco.py:366-440``) from the
validity counts alone: in the stream's fast mode a stack's validity depends
only on its geometry and the pooled mask (:func:`scanner._valid_coarse`), so
:func:`apply_chain` computes every sample's counts first and reads them in
one device-to-host transfer per batch; only the accepted stacks are then
acquired and reconstructed. The stream's documented deviations from the host
path are the JAX stream's: zero-valid stacks are dropped instead of redrawn,
removed slices are a per-slice Bernoulli draw, the recon weight may ride
pooled grids (``coarse_w``), the small frame and the dz-split are
approximations bounded in the tests.

One deliberate difference from the JAX stream: a pinned
``resolution_slice_fac`` is an absolute slice resolution in mm, as the host
path (:meth:`scanner.Scanner.get_resolution`) and the reference take it; the
JAX stream multiplies it by the volume resolution.
"""

from __future__ import annotations

import collections
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ... import trace as spans
from ...ops.linops import toeplitz_blur_matrix
from ...ops.noise import draw_fractal_uniforms, fractal_noise_3d, mog_3d
from ...ops.numerics import device_const
from ...ops.rand import draw_beta_int, gamma_fast, poisson_icdf
from ...ops.warp import warp_rigid_zoom_first
from .draws import derive_seed, make_generator
from .quality import (
    BlurCortex,
    SimulatedBoundaries,
    StructNoise,
    draw_pyramid_normals,
    fuzzy_once,
    masked_random_centers,
    multiscale_noise,
)
from .scanner import (
    _BLUR_HALF,
    _acquire_one,
    _coarse_mask,
    _extract_pair,
    _finalize,
    _pad_centered,
    _recon_one,
    _slice_artifacts,
    _slice_coef_tables,
    _valid_coarse,
    draw_slice_artifacts,
)

F32 = torch.float32
MAX_HALO_RADIUS = 14  # randint(5, 15) upper bound (artifacts.py:499)
MAX_FUZZY_ROUNDS = 4  # randint(2, 5) upper bound (artifacts.py:560)
MAX_DILATE = 18  # 6 * (n_fuzzy - 1) <= 18 (artifacts.py:582)
_SEED_TAG = 77  # the chain's seed: derive_seed(sample seed, 77), as JAX's fold_in(key, 77)

# apply_chain's device-to-host reads (one a batch with motion)
COUNTS = {"transfers": 0}


def _to(v, device):
    """``v`` (a tensor, or lists / tuples / dicts of them, or host values) on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, (list, tuple)):
        return type(v)(_to(x, device) for x in v)
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    return v


class Draws:
    """The random draws of one sample's artifact chain, by name.

    Each name has its own generator, seeded by ``seed`` and the name:
    :meth:`host` values (Python scalars) from a numpy generator, :meth:`dev`
    values (tensors) from a ``torch.Generator`` on ``device``. ``given``
    maps names to values used instead (moved to ``device``); ``record``
    keeps every value in ``recorded``, so a run can be repeated elsewhere
    with the same draws (torch's CUDA and CPU generators differ).
    """

    def __init__(self, seed: int, device, given: dict | None = None, record: bool = False):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.given = given or {}
        self.recorded = {} if record else None

    def _take(self, name: str, make):
        if name in self.given:
            v = _to(self.given[name], self.device)
        else:
            v = make(derive_seed(self.seed, zlib.crc32(name.encode())))
        if self.recorded is not None:
            self.recorded[name] = v
        return v

    def host(self, name: str, fn):
        """``fn(numpy Generator)`` for ``name``: a host value."""
        return self._take(name, lambda s: fn(np.random.default_rng(s)))

    def dev(self, name: str, fn):
        """``fn(torch.Generator on the device)`` for ``name``: device tensors."""
        return self._take(name, lambda s: fn(make_generator(s, self.device)))


def chain_draws(seeds, device, given=None, record: bool = False) -> list[Draws]:
    """One :class:`Draws` per batch element from the elements' seeds."""
    given = given or [None] * len(seeds)
    return [Draws(derive_seed(int(s), _SEED_TAG), device, g, record) for s, g in zip(seeds, given)]


# ---------------------------------------------------------------------------
# morphology with a host radius
# ---------------------------------------------------------------------------


def sq_edt(mask: torch.Tensor, max_radius: int) -> torch.Tensor:
    """Squared Euclidean distance to the mask, exact up to ``max_radius``:
    three 1-D min-plus passes with costs ``off^2`` in int16 (sentinel 20000
    keeps ``d2 + off^2`` below 32767). ``sq_edt <= r^2`` is the radius-r ball
    dilation for any ``r <= max_radius``."""
    d2 = torch.where(mask > 0, 0, 20000).to(torch.int16)
    for axis in range(3):
        n = d2.shape[axis]
        acc = d2.clone()
        for off in range(1, min(max_radius, n - 1) + 1):
            hi, lo = acc.narrow(axis, off, n - off), acc.narrow(axis, 0, n - off)
            torch.minimum(hi, d2.narrow(axis, 0, n - off) + off * off, out=hi)
            torch.minimum(lo, d2.narrow(axis, off, n - off) + off * off, out=lo)
        d2 = acc
    return d2


def ball_dilate_traced(mask: torch.Tensor, radius: int, max_radius: int) -> torch.Tensor:
    """Euclidean-ball dilation of radius ``radius <= max_radius`` (int32)."""
    return (sq_edt(mask, max_radius) <= radius * radius).to(torch.int32)


def _dilate1(mask: torch.Tensor) -> torch.Tensor:
    """Unit-ball (6-neighbourhood) dilation, in the mask's dtype."""
    out = mask.clone()
    for axis in range(3):
        n = mask.shape[axis]
        hi, lo = out.narrow(axis, 1, n - 1), out.narrow(axis, 0, n - 1)
        torch.maximum(hi, mask.narrow(axis, 0, n - 1), out=hi)
        torch.maximum(lo, mask.narrow(axis, 1, n - 1), out=lo)
    return out


def _pin_gate(drawn: bool, gate) -> bool:
    """A drawn gate under an optional pin: -1 (or None) keeps the draw, 0
    forces it off, 1 on."""
    if gate is None or int(gate) < 0:
        return bool(drawn)
    return int(gate) > 0


# ---------------------------------------------------------------------------
# the three quality artifacts (laws: reference artifacts.py; .quality)
# ---------------------------------------------------------------------------


def blur_cortex_t(out, seg, bc: BlurCortex, draws: Draws, gate=None):
    """BlurCortex on one (D, H, W) volume: gate ~ U < prob; nblur ~
    U{nmin..nmax-1}; std_blurs ~ Gamma(2, 1)^3; centre sigmas ~ Gamma(3, 1)
    (``artifacts.py:104,110``); frontal-lobe-biased weighted centres
    (:meth:`quality.BlurCortex.apply`)."""
    if not _pin_gate(draws.host("blur.on", lambda r: r.random() < bc.prob), gate):
        return out
    dev = out.device
    nblur = draws.host("blur.nblur", lambda r: int(r.integers(bc.nblur_min, bc.nblur_max)))
    std_g = draws.dev("blur.std_blurs", lambda g: gamma_fast(g, bc.std_blur_shape, (3,), dev))
    sig_g = draws.dev("blur.sigmas", lambda g: gamma_fast(g, bc.sigma_gamma_loc, (bc.MAX_BLUR, 3), dev))
    u = draws.dev("blur.u", lambda g: torch.rand(out.numel(), generator=g, device=dev).clamp_min_(1e-7))
    sigmas = torch.clamp_min(sig_g * bc.sigma_gamma_scale, 1e-2)
    return bc.apply(u, out, seg, nblur, std_g * bc.std_blur_scale, sigmas)


def struct_noise_t(out, seg, sn: StructNoise, draws: Draws, gate=None):
    """StructNoise on one volume (``artifacts.py:136-342``): pyramid noise of
    ``nstages`` levels at a uniform std, merged in the white matter through a
    Perlin or Gaussian-mixture weight."""
    if not _pin_gate(draws.host("struct.on", lambda r: r.random() < sn.prob), gate):
        return out
    dev = out.device
    shape = tuple(out.shape)
    nstages = draws.host("struct.nstages", lambda r: int(r.integers(sn.nstages_min, sn.nstages_max)))
    noise_std = draws.host(
        "struct.noise_std", lambda r: float(np.float32(sn.std_min + (sn.std_max - sn.std_min) * r.random()))
    )
    normals = draws.dev("struct.pyramid", lambda g: draw_pyramid_normals(g, shape, nstages, sn.nstages_max, dev))
    noise = multiscale_noise(shape, normals, sn.nstages_max)
    # clip(x, 0, 2 max) as jnp.clip computes it; a tensor bound in torch.clamp reads it on the host
    noisy = torch.minimum(torch.clamp_min(out + noise_std * noise, 0.0), out.max() * 2)
    mp = sn.merge_params
    if mp.merge_type == "perlin":
        r = int(mp.perlin_res_list[draws.host("struct.res", lambda r: int(r.integers(len(mp.perlin_res_list))))])
        octave = int(mp.perlin_octaves_list[
            draws.host("struct.octave", lambda r: int(r.integers(len(mp.perlin_octaves_list))))
        ])
        lattice = (r, r, r)
        uniforms = draws.dev("struct.perlin", lambda g: draw_fractal_uniforms(
            g, shape, lattice, octave, mp.perlin_lacunarity, int(max(mp.perlin_octaves_list)), dev))
        weight = fractal_noise_3d(shape, lattice, uniforms, mp.perlin_persistence, mp.perlin_lacunarity,
                                  mp.perlin_increase_size)
    else:
        nloc = draws.host("struct.nloc", lambda r: int(r.integers(mp.gauss_nloc_min, mp.gauss_nloc_max)))
        u = draws.dev("struct.centers", lambda g: torch.rand(shape, generator=g, device=dev))
        centers, valid = masked_random_centers(u, seg == sn.wm_label, sn.MAX_LOC, nloc)
        z = draws.dev("struct.sigmas", lambda g: torch.randn((sn.MAX_LOC, 1), generator=g, device=dev))
        weight = mog_3d(shape, centers, torch.clamp(mp.gauss_sigma_mu + mp.gauss_sigma_std * z, 1, 40), valid)
    mask = (seg > 0).to(F32)
    return (1 - mask * weight) * out + mask * weight * noisy


def _fuzzy(mask, sb: SimulatedBoundaries, draws: Draws):
    """The fuzzy boundary (``artifacts.py:501-602``): up to
    ``MAX_FUZZY_ROUNDS`` :func:`fuzzy_once` rounds, Gaussian surface
    probabilities on the added shell, and the dilation ladder."""
    dev = mask.device
    shape = tuple(mask.shape)
    n_fuzzy = draws.host("bound.n_fuzzy", lambda r: int(r.integers(2, MAX_FUZZY_ROUNDS + 1)))
    n_centers = draws.host("bound.n_centers", lambda r: min(
        int(poisson_icdf(torch.tensor(r.random(), dtype=F32), 100.0, 224)), sb.MAX_CENTERS))
    base_sigma = draws.host("bound.base_sigma", lambda r: max(
        int(poisson_icdf(torch.tensor(r.random(), dtype=F32), 8.0, 64)), 1))
    mask_modif = mask
    for r in range(n_fuzzy):
        keep = draws.dev(f"bound.keep.{r}", lambda g: torch.rand(shape, generator=g, device=dev) < 0.1)
        mask_modif = fuzzy_once(mask_modif, keep)
    added = ((mask_modif - mask) > 0).to(torch.int32)
    u = draws.dev("bound.centers", lambda g: torch.rand(shape, generator=g, device=dev))
    centers, valid = masked_random_centers(u, added, sb.MAX_CENTERS, n_centers)
    beta = draws.dev("bound.beta", lambda g: draw_beta_int(g, 2, 5, (sb.MAX_CENTERS, 1), dev))
    mog = mog_3d(shape, centers, float(base_sigma) + 10 * beta, valid)
    surf_proba = torch.where(added > 0, mog, 0.0)
    n_dilate = min(6 * (n_fuzzy - 1), MAX_DILATE)
    levels = torch.clamp_min(torch.round(surf_proba * float(n_dilate + 2) - 1).to(torch.int32), 0)
    # the ladder in int8: the dilation step that first reaches each voxel
    cur = mask.to(torch.int8)
    reach = torch.where(mask > 0, 0, MAX_DILATE + 10).to(torch.int8)
    for i in range(n_dilate):
        if i >= 2:
            cur = _dilate1(cur)
        reach = torch.where((reach > i) & (cur > 0), i, reach).to(torch.int8)
    return ((reach <= levels) & (mask_modif > 0)).to(torch.int32) | mask


def boundaries_t(out, seg, sb: SimulatedBoundaries, draws: Draws, gate=None, trace=None):
    """SimulatedBoundaries on one volume (``artifacts.py:428-604``): no mask,
    or the brain mask grown by a halo and / or a fuzzy boundary. A gate pin
    forces the masking path on (1) or off (0); the sub-gates stay drawn.
    ``trace`` (a dict) receives the mask applied (``"mask"``)."""
    no_mask = draws.host("bound.no_mask", lambda r: r.random() < sb.prob_no_mask)
    if gate is not None and int(gate) >= 0:
        no_mask = int(gate) == 0
    halo_on = draws.host("bound.halo", lambda r: r.random() < sb.prob_halo)
    fuzzy_on = draws.host("bound.fuzzy", lambda r: r.random() < sb.prob_fuzzy)
    if no_mask:
        return out
    mask = (seg > 0).to(torch.int32)
    if halo_on:
        radius = draws.host("bound.radius", lambda r: int(r.integers(5, MAX_HALO_RADIUS + 1)))
        mask = ball_dilate_traced(mask, radius, radius)
    if fuzzy_on:
        mask = _fuzzy(mask, sb, draws)
    if trace is not None:
        trace["mask"] = mask
    return out * mask


@dataclass
class QualityArtifacts:
    """The generator's configured quality artifacts."""

    blur_cortex: BlurCortex | None = None
    struct_noise: StructNoise | None = None
    boundaries: SimulatedBoundaries | None = None

    @classmethod
    def from_generator(cls, generator) -> "QualityArtifacts":
        a = getattr(generator, "artifacts", None) or {}
        return cls(blur_cortex=a.get("blur_cortex"), struct_noise=a.get("struct_noise"),
                   boundaries=a.get("boundaries"))


def apply_pre_motion(out, seg, qa: QualityArtifacts, draws: Draws, gates=None):
    """blur_cortex then struct_noise; ``gates`` an optional (3,) row of pins
    (blur_cortex, struct_noise, boundaries), see :func:`_pin_gate`."""
    if qa.blur_cortex is not None:
        out = blur_cortex_t(out, seg, qa.blur_cortex, draws, None if gates is None else gates[0])
    if qa.struct_noise is not None:
        out = struct_noise_t(out, seg, qa.struct_noise, draws, None if gates is None else gates[1])
    return out


def apply_post_motion(out, seg, qa: QualityArtifacts, draws: Draws, gates=None):
    """boundaries, after simulate_motion in the reference chain."""
    if qa.boundaries is not None:
        out = boundaries_t(out, seg, qa.boundaries, draws, None if gates is None else gates[2])
    return out


# ---------------------------------------------------------------------------
# the motion engine: host geometry packer and the per-sample engine
# ---------------------------------------------------------------------------


def _acquire_one_small(vol_p, fwd, G, gap_px, z0, sig_px, thr_frac, ns_count, gamma, gamma_on, sigma,
                       void_prob, threshold, S: int, ns_grid: int, coarse_mask, draws, split_dz=False,
                       valid=None):
    """One stack's acquisition in the small isotropic slice-pixel frame.

    For samples whose slice FOV fits an ``S``-cube in px units, the stack
    frame lives on an ``S`` buffer: the zoom-first rigid warp
    (:func:`warp_rigid_zoom_first`) shrinks the content by ``rs`` before the
    rotation's shears, with the acquisition PSF (in px) composed into its
    final matmuls; the extraction, the coarse validity (zoom-first too,
    unless ``valid`` is given) and the slice artifacts are the big frame's
    with ``rs = 1``. Returns (slices, valid).
    """
    c_s = (S - 1) / 2.0
    post = tuple(toeplitz_blur_matrix(sig_px[i].reshape(1), S, _BLUR_HALF)[0] for i in range(3))
    Wv = warp_rigid_zoom_first(vol_p, *fwd, out_size=S, post=post, out_perm=(1, 2, 0), emit_f32=False)
    dz, dv_tab, du_tab = _slice_coef_tables(G, 1.0, c_s, z0, gap_px, ns_grid)
    slices, _ = _extract_pair(Wv, None, gap_px, z0, dz, 1.0, c_s, dv_tab, du_tab, S, ns_grid, split_dz)
    if valid is None:
        valid = _valid_coarse(coarse_mask, *fwd, G, thr_frac, ns_count, S, ns_grid, zoom_first=True)
    slices = _slice_artifacts(slices, valid, gamma, gamma_on, sigma, void_prob, threshold, **draws, fast=True)
    return slices, valid


def _identity_stack_row(ns_grid: int):
    """Inert per-stack geometry for motion-off samples."""
    eye = np.eye(3, 4, dtype=np.float32)[None].repeat(ns_grid, 0)
    return dict(
        q_idx=0, angles=np.zeros(3, np.float32), wscale=1.0,
        wdelta=np.zeros(3, np.float32), G=eye, Grec=eye, Greset=eye,
        scal=np.array([0.2, 1.0, 0.0, 0.0], np.float32),
        qinv=0, iang=np.zeros(3, np.float32), iscl=1.0,
        idlt=np.zeros(3, np.float32), dz_ok=0.0,
        cqinv=0, ciang=np.zeros(3, np.float32), ciscl=1.0,
        cidlt=np.zeros(3, np.float32),
    )


def _coarse_inv_decomp(A, t, cube_s: int) -> tuple:
    """The stack -> recon inverse map between the stack frame pooled by
    ``f = cube_s // 128`` and the recon frame pooled by 2 (pooled
    coordinates: ``p_f = f p_c + (f-1)/2``), decomposed on the 128 grid."""
    from ...ops.warp import decompose_affine_paeth_host

    f = max(1, cube_s // 128)
    g = 2
    A = np.asarray(A, np.float64)
    t = np.asarray(t, np.float64)
    ones = np.ones(3)
    A_c = A * (g / f)
    t_c = (A @ (ones * (g - 1) / 2.0) + t - ones * (f - 1) / 2.0) / f
    return decompose_affine_paeth_host(A_c, t_c, 128)


def _dz_split_ok(G, Grec, ns, gap_u, margin: float = 2.05) -> float:
    """1.0 when the dz-split attributes every lane exactly for this stack:
    every pair of plane centres, acquisition and recon tables, stays more
    than ``margin`` frame units apart."""
    if ns < 2:
        return 1.0
    for tab in (G, Grec):
        pos = np.sort(tab[:ns, 0, 3])
        if np.min(np.diff(pos)) <= margin:
            return 0.0
    return 1.0 if gap_u > margin else 0.0


def _cubes(cube) -> tuple:
    return (int(cube),) if isinstance(cube, (int, np.integer)) else tuple(int(c) for c in cube)


def pack_motion(rng, B: int, shape, res: float, sm, cube, ns_grid: int, small_cube: int | None = None,
                genparams: dict | None = None, with_record: bool = False) -> dict:
    """Host geometry of one batch for :func:`motion_t` (numpy, in the JAX
    package's draw order).

    Mirrors ``Scanner.scan``'s host work for ``Kb = max_num_stack`` attempt
    stacks per motion-on sample, plus the reconstructor's host draws. ``cube``
    may be a tuple of static tiers: each sample packs in the smallest tier
    covering its ``res_slice`` draw (``scanner.slice_grid``) and
    ``tier_idx`` routes it; draws below the largest tier's reach are clamped
    to it. ``small_cube``: samples whose slice FOV fits that buffer in px
    units pack in the isotropic px frame (``fs = rs``) and set ``small``.

    ``genparams`` pins ``resolution_slice`` (or ``resolution_slice_fac``,
    both absolute mm), ``slice_thickness`` and ``gap``, drawn then
    overridden; a non-empty dict forces the motion gate on, ``{"apply":
    False}`` off. ``with_record`` adds ``"_record"``: the effective
    per-sample scalars in mm and ``motion_on``.
    """
    from .motion import sample_motion
    from .scanner import GAUSSIAN_FWHM, SINC_FWHM, _slice_affine_table, _stack_geometry, slice_grid
    from .transforms import (
        RigidTransform,
        interleave_index,
        random_angle,
        random_init_stack_transforms,
        reset_transform,
    )
    from ...ops.warp import decompose_affine_paeth_host

    sp, rp = sm.scanner_args, sm.recon_args
    Kb = int(sp.max_num_stack)
    cubes = _cubes(cube)
    diag = float(np.sqrt(sum(s * s for s in shape) / 2.0))
    rs_min = diag / max(cubes)
    c_vol = (np.asarray(shape) - 1) / 2.0
    mp = rp.merge_params
    gp = {k: v for k, v in (genparams or {}).items() if v is not None}
    apply_pin = gp.pop("apply", None)
    force_on = bool(gp) or apply_pin is True
    force_off = apply_pin is False
    pin_res_s = gp.get("resolution_slice", gp.get("resolution_slice_fac"))

    rows: dict[str, list] = collections.defaultdict(list)
    record: dict[str, list] = collections.defaultdict(list)
    for _ in range(B):
        on = (rng.random() < sm.prob or force_on) and not force_off
        if not on:
            for k in ("resolution_slice", "slice_thickness", "gap"):
                record[k].append(np.nan)
            record["motion_on"].append(False)
            for k, v in _identity_stack_row(ns_grid).items():
                rows[k].append([v] * Kb)
            for name, val in (
                ("motion_on", False), ("small", False), ("tier_idx", 0), ("rs", 1.0), ("gap_vox", 1.0),
                ("z0", 0.0), ("ns", 1), ("num_stacks", 0), ("sig", np.zeros(3, np.float32)),
                ("sig_rec", np.zeros(2, np.float32)), ("smooth_on", False), ("merge_on", False),
                ("rm_on", False), ("rm_ratio", 0.0), ("mis_on", False), ("mis_idx", 0), ("ngauss", 1),
                ("mres_idx", 0), ("octave", 1), ("gsigmas", np.full((8, 1), 20.0, np.float32)),
            ):
                rows[name].append(val)
            continue

        # draw-then-override: a pin must not skip a host draw
        res_s = float(rng.uniform(sp.resolution_slice_fac_min * res,
                                  min(sp.resolution_slice_fac_max * res, sp.resolution_slice_max)))
        if pin_res_s is not None:
            res_s = float(pin_res_s)
        res_s = max(res_s, rs_min * res)  # largest-tier clamp
        s_thick = float(rng.uniform(sp.slice_thickness_min, sp.slice_thickness_max))
        if gp.get("slice_thickness") is not None:
            s_thick = float(gp["slice_thickness"])
        gap = float(rng.uniform(sp.gap_min, sp.gap_max))
        if gp.get("gap") is not None:
            gap = float(gp["gap"])
        record["resolution_slice"].append(res_s)
        record["slice_thickness"].append(s_thick)
        record["gap"].append(gap)
        record["motion_on"].append(True)
        rs = res_s / res
        gap_vox = gap / res
        ns = min(int(max(shape) * res / gap) + 2, ns_grid)
        cube_t = slice_grid(shape, rs, sp.slice_size, cubes) if len(cubes) > 1 else cubes[0]
        tier_idx = cubes.index(cube_t)
        # the small frame: the in-plane FOV and the slab fit the buffer in px
        # units, and the gap exceeds 2 px (the extraction's factorization is
        # exact only then)
        small = bool(
            small_cube is not None
            and small_cube < cube_t
            and rs * small_cube >= diag
            and (ns - 1) * gap_vox / rs <= small_cube - 12
            and gap_vox / rs > 2.0
            and max(shape) <= small_cube
        )
        cube_s = small_cube if small else cube_t
        fs = rs if small else 1.0  # frame unit in voxels
        gap_u = gap_vox / fs
        z0 = (cube_s - 1) / 2.0 - (ns - 1) / 2.0 * gap_u
        num_stacks = int(rng.integers(sp.min_num_stack, sp.max_num_stack + 1))
        sig = np.array([GAUSSIAN_FWHM * s_thick / res / fs, SINC_FWHM * rs / fs, SINC_FWHM * rs / fs], np.float32)
        sig_rec = np.array([GAUSSIAN_FWHM * s_thick / res / fs, SINC_FWHM * rs / fs], np.float32)

        per_stack: dict[str, list] = collections.defaultdict(list)
        for _k in range(Kb):
            t_init = random_init_stack_transforms(ns, gap_vox * res, sp.restrict_transform, sp.txy, rng)
            ts = np.arange(ns) * rng.uniform(sp.TR_min, sp.TR_max)
            t_motion = sample_motion(ts, rng)
            ilv = interleave_index(ns, int(rng.integers(2, int(np.sqrt(ns)) + 1)))
            t_motion = t_motion[np.asarray(ilv)]
            t_target = t_motion.compose(t_init)
            mats_vox = t_target.matrix(True).copy()
            mats_vox[:, :, 3] /= res
            geo = _stack_geometry(t_init.matrix(True)[0, :, :3], mats_vox, shape, ns, cube_s, ns_grid, fs=fs)
            gamma_on = rng.random() < sp.prob_gamma
            gamma = float(np.exp(sp.gamma_std * rng.standard_normal()))
            sigma = float(rng.uniform(sp.noise_sigma_min, sp.noise_sigma_max))
            thr_frac = float(rng.uniform(0.1, 0.3))

            mats_rec = mats_vox.copy()
            if rng.random() < rp.prob_misreg_stack:
                off = RigidTransform(np.concatenate([
                    np.broadcast_to(random_angle(1, True, rng), (ns, 3)),
                    np.stack([
                        np.full(ns, rng.uniform(-rp.txy, rp.txy), np.float32),
                        np.full(ns, rng.uniform(-rp.txy, rp.txy), np.float32),
                        np.zeros(ns, np.float32),
                    ], -1),
                ], -1).astype(np.float32))
                mats_rec[:ns] = off.compose(RigidTransform(mats_rec[:ns])).matrix(True)
            mats_reset = reset_transform(t_init).matrix(True).copy()
            mats_reset[:, :, 3] /= res
            if small:
                kw = dict(fs=fs, c_frame=(cube_s - 1) / 2.0)
                Grec = _slice_affine_table(mats_rec, geo["Minv"], c_vol, c_vol, ns, ns_grid, **kw)
                Greset = _slice_affine_table(mats_reset, geo["Minv"], c_vol, c_vol, ns, ns_grid, **kw)
                # inverse px-frame -> recon map: isotropic scale 1/fs
                A_inv = geo["Minv"] / fs
                t_inv = np.full(3, (cube_s - 1) / 2.0) - geo["Minv"] @ c_vol / fs
            else:
                Grec = _slice_affine_table(mats_rec, geo["Minv"], geo["t_stack"], c_vol, ns, ns_grid)
                Greset = _slice_affine_table(mats_reset, geo["Minv"], geo["t_stack"], c_vol, ns, ns_grid)
                # inverse stack -> recon map (res_recon == res: scale 1)
                A_inv = geo["Minv"]
                t_inv = -geo["Minv"] @ geo["t_stack"]
            qinv, iang, iscl, idlt = decompose_affine_paeth_host(A_inv, t_inv, cube_s)
            cqinv, ciang, ciscl, cidlt = _coarse_inv_decomp(A_inv, t_inv, cube_s)
            qi, ang, ws, wd = geo["fwd"]
            for name, val in (
                ("q_idx", qi), ("angles", ang), ("wscale", ws), ("wdelta", wd),
                ("G", geo["G"]), ("Grec", Grec), ("Greset", Greset),
                ("scal", np.array([thr_frac, gamma, 1.0 if gamma_on else 0.0, sigma], np.float32)),
                ("qinv", qinv), ("iang", iang), ("iscl", iscl), ("idlt", idlt),
                ("cqinv", cqinv), ("ciang", ciang), ("ciscl", ciscl), ("cidlt", cidlt),
                ("dz_ok", _dz_split_ok(geo["G"], Grec, ns, gap_u)),
            ):
                per_stack[name].append(val)
        for k, v in per_stack.items():
            rows[k].append(v)

        for name, val in (("motion_on", True), ("small", small), ("tier_idx", tier_idx), ("rs", rs),
                          ("gap_vox", gap_u), ("z0", z0), ("ns", ns), ("num_stacks", num_stacks),
                          ("sig", sig), ("sig_rec", sig_rec)):
            rows[name].append(val)
        rows["smooth_on"].append(bool(rng.random() < rp.prob_smooth))
        rm_on = bool(rng.random() < rp.prob_rm_slices)
        rows["rm_on"].append(rm_on)
        rows["rm_ratio"].append(float(rng.uniform(rp.rm_slices_min, rp.rm_slices_max)) if rm_on else 0.0)
        rows["mis_on"].append(bool(rng.random() < rp.prob_misreg_slice))
        rows["mis_idx"].append(int(rng.integers(Kb * ns_grid)))
        rows["merge_on"].append(bool(rng.random() < rp.prob_merge))
        if mp.merge_type == "gaussian":
            rows["ngauss"].append(int(rng.integers(mp.gauss_ngaussians_min, mp.gauss_ngaussians_max)))
            rows["mres_idx"].append(0)
            rows["octave"].append(1)
        else:
            rows["ngauss"].append(1)
            rows["mres_idx"].append(int(rng.integers(len(mp.perlin_res_list))))
            rows["octave"].append(int(rng.choice(mp.perlin_octaves_list)))
        rows["gsigmas"].append(np.clip(20 + 10 * rng.standard_normal((8, 1)), 5, 40).astype(np.float32))

    int_keys = {"q_idx", "qinv", "cqinv", "ns", "num_stacks", "mis_idx", "ngauss", "mres_idx", "octave", "tier_idx"}
    bool_keys = {"motion_on", "small", "smooth_on", "merge_on", "rm_on", "mis_on"}
    out = {}
    for k, v in rows.items():
        arr = np.asarray(v)
        out[k] = arr.astype(np.int32 if k in int_keys else bool if k in bool_keys else np.float32)
    if with_record:
        out["_record"] = {k: np.asarray(v, bool if k == "motion_on" else np.float32) for k, v in record.items()}
    return out


# pack keys the engine reads on the device
_DEVICE_KEYS = ("angles", "wscale", "wdelta", "G", "Grec", "iang", "iscl", "idlt", "ciang", "ciscl", "cidlt",
                "sig", "sig_rec", "gsigmas")


def upload_pack(pack: dict, device) -> dict:
    """The pack's float arrays on ``device``, one non-blocking copy per key;
    a sample's row is then a view (:func:`row_of`)."""
    return {k: device_const(pack[k], F32, device) for k in _DEVICE_KEYS if k in pack}


def row_of(pack: dict, b: int) -> dict:
    """Sample ``b``'s row of a host or device pack."""
    return {k: v[b] for k, v in pack.items() if not k.startswith("_")}


def engine_cube(row, cube, small_cube) -> tuple[int, bool]:
    """(the cube a motion-on sample runs at, whether in the small frame):
    the small cube for a small-frame sample, else its tier."""
    cubes = _cubes(cube)
    if small_cube is not None and small_cube < min(cubes) and bool(row["small"]):
        return int(small_cube), True
    return (cubes[int(row["tier_idx"])] if len(cubes) > 1 else cubes[0]), False


def motion_validity(seg, row, drow, cube, ns_grid: int, small_cube=None) -> torch.Tensor:
    """(Kb, ns_grid) f32 validity of every attempt stack of one motion-on
    sample: the coarse z-profile rule of :func:`scanner._valid_coarse` on the
    pooled brain mask, zoom-first in the small frame."""
    cube_s, small = engine_cube(row, cube, small_cube)
    cmask = _coarse_mask(_pad_centered((seg > 0).to(F32), cube_s))
    thr = row["scal"][:, 0]
    return torch.stack([
        _valid_coarse(cmask, int(row["q_idx"][k]), drow["angles"][k], drow["wscale"][k], drow["wdelta"][k],
                      drow["G"][k], float(thr[k]), int(row["ns"]), cube_s, ns_grid, zoom_first=small)
        for k in range(len(row["q_idx"]))
    ])


def accept_stacks(nv, num_stacks: int, max_slices: float) -> list[int]:
    """The attempt stacks the reference's sequential acceptance keeps
    (``simulate_reco.py:366-440``, as the JAX engine's scan resolves it):
    in order, while fewer than ``num_stacks`` are kept and none overflowed,
    a stack with ``nv > 0`` valid slices is kept unless the running total
    reaches ``max_slices``, which discards it and stops."""
    count, total, stopped, kept = 0, np.float32(0.0), False, []
    for k, n in enumerate(np.asarray(nv, np.float32)):
        if count >= num_stacks or stopped:
            continue
        overflow = bool(n > 0 and total + n >= np.float32(max_slices))
        if n > 0 and not overflow:
            kept.append(k)
            count += 1
            total = total + n
        stopped = stopped or overflow
    return kept


def _merge_weight(seg, row, drow, mp, shape, draws: Draws):
    """The recon's merge weight (``get_merging_weights``,
    ``simulate_reco.py:649-691``): fractal noise at the packed lattice and
    octave, or a Gaussian mixture at brain voxels."""
    dev = seg.device
    if mp.merge_type == "perlin":
        r = int(mp.perlin_res_list[int(row["mres_idx"])])
        lattice = (r, r, r)
        uniforms = draws.dev("motion.merge", lambda g: draw_fractal_uniforms(
            g, shape, lattice, int(row["octave"]), mp.perlin_lacunarity, int(max(mp.perlin_octaves_list)), dev))
        return fractal_noise_3d(shape, lattice, uniforms, mp.perlin_persistence, mp.perlin_lacunarity,
                                mp.perlin_increase_size)
    u = draws.dev("motion.merge", lambda g: torch.rand(shape, generator=g, device=dev))
    centers, cvalid = masked_random_centers(u, (seg > 0).to(torch.int32), 8, int(row["ngauss"]))
    return mog_3d(shape, centers, drow["gsigmas"], cvalid)


def motion_t(out, seg, row, sm, shape, cube, ns_grid: int, draws: Draws, small_cube=None, split_dz=False,
             coarse_w=False, drow=None, valid=None, valid_host=None, trace=None):
    """SimulateMotion on one (D, H, W) volume from its packed host ``row``.

    The sample runs at its tier's cube (or the small frame's, see
    :func:`engine_cube`). Validity (``valid``, (Kb, ns_grid) on the device,
    and its host copy ``valid_host``; computed here and read back when not
    given) decides the accepted stacks (:func:`accept_stacks`); each is
    acquired (fast mode: coarse validity, one noise field) and placed on the
    recon grid, value and weight summed in stack order, then equalised,
    smoothed and merged (``scanner._finalize``). No accepted stack leaves
    the volume as it was. ``split_dz``: the stack's packed ``dz_ok`` flag
    engages the dz-split (off for the stack of a misregistered slice);
    ``coarse_w``: the coarse weight chain where the cube is a multiple of
    128 and the shape even. ``drow``: the row's float arrays on the device
    (:func:`upload_pack`). ``trace`` (a dict) receives the validity flags,
    the accepted stacks and the final weight. With tracing on, a motion-on
    sample annotates the open span with ``stacks_attempted`` and
    ``stacks_accepted``, and each accepted stack is a ``motion.stack`` span.
    """
    if not bool(row["motion_on"]):
        return out
    sp, rp = sm.scanner_args, sm.recon_args
    dev = out.device
    cube_s, small = engine_cube(row, cube, small_cube)
    if drow is None:
        drow = row_of(upload_pack({k: np.asarray(v)[None] for k, v in row.items()}, dev), 0)
    if valid is None:
        valid = motion_validity(seg, row, drow, cube, ns_grid, small_cube)
    if valid_host is None:
        valid_host = valid.cpu().numpy()
    kept = accept_stacks(valid_host.sum(1), int(row["num_stacks"]), float(sp.max_num_slices))
    spans.annotate(stacks_attempted=len(valid_host), stacks_accepted=len(kept))
    if trace is not None:
        trace.update(accepted=kept, valid=valid_host)
    if not kept:
        return out
    vol_p = _pad_centered(out, cube_s)
    rs = 1.0 if small else float(row["rs"])
    gap, z0, ns = float(row["gap_vox"]), float(row["z0"]), int(row["ns"])
    use_coarse = coarse_w and cube_s % 128 == 0 and all(s % 2 == 0 for s in shape)
    mis_on, mis_idx = bool(row["mis_on"]), int(row["mis_idx"])
    value = weight = None
    for k in kept:
        with spans.span("motion.stack", stack=k):
            hit_stack = mis_on and mis_idx // ns_grid == k
            split_f = float(row["dz_ok"][k]) * (0.0 if hit_stack else 1.0) if split_dz else False
            thr, gamma, gamma_on, sigma = (float(v) for v in row["scal"][k])
            d = draws.dev(f"motion.slices.{k}", lambda g: draw_slice_artifacts(g, ns_grid, cube_s, dev, fast=True))
            fwd = (int(row["q_idx"][k]), drow["angles"][k], drow["wscale"][k], drow["wdelta"][k])
            args = (thr, ns, gamma, gamma_on > 0.5, sigma, float(np.float32(sp.prob_void)),
                    float(np.float32(sp.slice_noise_threshold)))
            if small:
                slices, _ = _acquire_one_small(vol_p, fwd, drow["G"][k], gap, z0, drow["sig"], *args, cube_s,
                                               ns_grid, None, d, split_f, valid=valid[k])
            else:
                slices, _ = _acquire_one(vol_p, None, fwd, drow["G"][k], rs, gap, z0, drow["sig"], *args, cube_s,
                                         ns_grid, d, split_dz=split_f, valid=valid[k])
            u_rm = draws.dev(f"motion.rm.{k}", lambda g: torch.rand(ns_grid, generator=g, device=dev))
            keep = valid[k] * (1.0 - (u_rm < float(row["rm_ratio"])).to(F32) * float(bool(row["rm_on"])))
            # the misregistered slice, if it is a valid slice of this stack,
            # takes the reset transform's table row
            j = mis_idx % ns_grid
            if hit_stack and valid_host[k, j] > 0:
                grec = np.array(row["Grec"][k])
                grec[j] = row["Greset"][k][j]
                grec = device_const(grec, F32, dev)
            else:
                grec = drow["Grec"][k]
            inv = (int(row["qinv"][k]), drow["iang"][k], drow["iscl"][k], drow["idlt"][k])
            cinv = (int(row["cqinv"][k]), drow["ciang"][k], drow["ciscl"][k], drow["cidlt"][k]) if use_coarse else None
            v_s, w_s = _recon_one(slices, keep, grec, rs, gap, z0, drow["sig_rec"], inv, cube_s, ns_grid,
                                  tuple(shape), split_dz=split_f, coarse_inv=cinv)
            del slices
            # summed in f32: in the production mode the pooled weight chain
            # hands bf16 (the JAX engine sums into f32 zeros)
            value = v_s if value is None else value + v_s
            weight = w_s.float() if weight is None else weight + w_s
    if trace is not None:
        trace["weight"] = weight
    mw = _merge_weight(seg, row, drow, rp.merge_params, tuple(shape), draws) if bool(row["merge_on"]) else None
    return _finalize(value, weight, out, bool(row["smooth_on"]), bool(row["merge_on"]), mw)


# ---------------------------------------------------------------------------
# the chain over a batch
# ---------------------------------------------------------------------------


@dataclass
class ChainSpec:
    """The stream's artifact chain: the configured artifacts and the motion
    engine's static geometry."""

    qa: QualityArtifacts | None
    sm: object | None
    shape: tuple
    cube: tuple
    ns_grid: int
    small_cube: int | None = None
    split_dz: bool = False
    coarse_w: bool = False


def _planned_transfer(t: torch.Tensor) -> np.ndarray:
    """The chain's one device-to-host read a batch (the validity flags), the
    span ``chain.sync``; CUDA's sync debug mode is lifted around it alone."""
    COUNTS["transfers"] += 1
    with spans.span("chain.sync"):
        if t.device.type != "cuda":
            return t.numpy()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return t.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def apply_chain(out, seg, spec: ChainSpec, pack: dict, draws: list[Draws], traces=None):
    """The artifact chain on a (B, D, H, W) batch, one sample after another
    (one sample's scanner buffers live at a time): blur_cortex ->
    struct_noise -> simulate_motion -> boundaries.

    ``pack``: :func:`pack_motion`'s host arrays (and ``"gates"``, a (B, 3)
    row of pins, if any). The motion-on samples' stack validity is computed
    first and read back in one transfer. ``traces`` (a list) receives one
    dict per sample, filled by :func:`motion_t` and :func:`boundaries_t`.
    With tracing on, each artifact of each sample is a span
    (``chain.blur_cortex``, ``chain.struct_noise``, ``chain.motion``,
    ``chain.boundaries``).
    """
    B = out.shape[0]
    dev = out.device
    gates = pack.get("gates")
    motion = spec.sm is not None and "motion_on" in pack
    drows = valid = valid_host = None
    if motion:
        dpack = upload_pack(pack, dev)
        drows = [row_of(dpack, b) for b in range(B)]
        on = [b for b in range(B) if pack["motion_on"][b]]
        if on:
            valid = torch.stack([
                motion_validity(seg[b], row_of(pack, b), drows[b], spec.cube, spec.ns_grid, spec.small_cube)
                for b in on
            ])
            valid_host = dict(zip(on, _planned_transfer(valid)))
            valid = dict(zip(on, valid))

    cuda = dev.type == "cuda"
    res = []
    for b in range(B):
        o, s, d = out[b], seg[b], draws[b]
        g = None if gates is None else gates[b]
        qa = spec.qa
        tr = {} if traces is not None else None
        if qa is not None and qa.blur_cortex is not None:
            with spans.span("chain.blur_cortex", cuda=cuda):
                o = blur_cortex_t(o, s, qa.blur_cortex, d, None if g is None else g[0])
        if qa is not None and qa.struct_noise is not None:
            with spans.span("chain.struct_noise", cuda=cuda):
                o = struct_noise_t(o, s, qa.struct_noise, d, None if g is None else g[1])
        if motion:
            with spans.span("chain.motion", cuda=cuda):
                o = motion_t(o, s, row_of(pack, b), spec.sm, spec.shape, spec.cube, spec.ns_grid, d, spec.small_cube,
                             spec.split_dz, spec.coarse_w, drow=drows[b], valid=None if valid is None else valid.get(b),
                             valid_host=None if valid_host is None else valid_host.get(b), trace=tr)
        if qa is not None and qa.boundaries is not None:
            with spans.span("chain.boundaries", cuda=cuda):
                o = boundaries_t(o, s, qa.boundaries, d, None if g is None else g[2], trace=tr)
        if traces is not None:
            traces.append(tr)
        res.append(o)
    return torch.stack(res)
