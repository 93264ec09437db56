"""Motion simulation: slice acquisition and PSF reconstruction (port of the
host path of ``fetalsyngen_tpu.generator.artifacts.scanner``).

Reference behavior: ``Scanner.scan`` + ``PSFReconstructor``
(``fetalsyngen/generator/artifacts/simulate_reco.py:57-774``). The JAX
package's design carries over stage for stage, one stack at a time:

  acquisition:  (V, brain mask) --rigid pair warp (quarter turn, unit shears,
                zoom; PSF blur and xy scale composed into the zoom)-->
                stack frame --z-extraction: K1 lane-affine pass + interp
                matmul--> --in-plane motion: two K1 per-slice passes-->
                (slices, mask slices) --validity from mask-slice mass-->
                (+ gamma / Rician noise / signal voids)
  reconstruction: (slices x keep) --two K2 per-slice passes (inverse
                in-plane motion)--> --K1 lane-affine pass over the slice
                axis (value and weight)--> --placement + recon PSF matmuls-->
                --inverse rigid pair warp--> accumulate (value, weight) over
                the stacks --> equalize --> smooth --> merge with GT

Every arrow is a matmul or a hat pass (``fetalsyngen_torch.kernels.hat``).
The slice FOV is the static tiered cube of :func:`slice_grid`, slices stay
padded to ``ns_grid`` with a validity mask, as in the JAX package.

Randomness. Every host draw comes from ``np.random.default_rng(rng_seed)``
in the JAX package's order, including the ``Kb = max_num_stack`` attempts
drawn per acquisition round, so the port and the JAX package draw the same
geometry from the same ``rng_seed``. The device draws (slice noise and
voids, the merge weights) come from generators seeded from ``device_seed``
and the JAX package's ``fold_in`` tags (``100 + attempt``, 7, 8); they are
arguments of the compute functions (``draw_slice_artifacts``). The returned
metadata holds both seeds, so a call replays from the genparams dict alone.

The stream's motion engine (``batched.motion_t``) adds its own modes to
these stages: the coarse validity of :func:`_valid_coarse` (no mask
operand), the dz-split of :func:`_extract_pair` and :func:`_recon_one`, the
fast noise mode of :func:`_slice_artifacts`, the coarse weight chain of
:func:`_recon_one` and the small-frame (``fs != 1``) geometry.

Precision: the stages read the caller's scopes (``ops.linops``), as the JAX
package's do: in the stream's production mode the chain contractions keep
bf16 intermediates (``einsum_store``), the hat passes read and write bf16
rows, and the operator compositions take one bf16 pass (``prec_matmul``).
The host path (:class:`SimulateMotion`) runs under ``f32_scope``, as the JAX
package pins its acquisition and reconstruction programs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels.hat import hat_pass, hat_pass_pair
from ...ops.linops import (
    axis_mm,
    einsum_store,
    f32_scope,
    interp_matrix_1d,
    io_dtype,
    prec_matmul,
    toeplitz_blur_matrix,
)
from ...ops.morphology import box_sum
from ...ops.noise import draw_fractal_uniforms, fractal_noise_3d, mog_3d
from ...ops.numerics import device_const
from ...ops.warp import _interp_or_nearest_matrix, decompose_affine_paeth_host, warp_rigid_pair_traced
from .draws import derive_seed, make_generator
from .motion import sample_motion
from .psf import GAUSSIAN_FWHM, SINC_FWHM
from .quality import ReconMergeParams, masked_random_centers
from .transforms import (
    RigidTransform,
    interleave_index,
    random_angle,
    random_init_stack_transforms,
    reset_transform,
)

F32 = torch.float32

# Static stack-frame cube tiers: the smallest covering the reference's
# dynamic slice FOV (simulate_reco.py:349-354) is used.
DEFAULT_TIERS = (384, 512, 640)
NS = 128  # default max slices per stack (ns_grid)

_FLIP = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float32)
_BLUR_HALF = 12  # covers 3 sigma of the largest thickness/res ratio (3.5/0.5)
_LANE_PAD = 128  # the slice-axis pass runs on lanes padded to a multiple of 128


def slice_grid(shape, rs: float, slice_size: int | None = None, tiers=DEFAULT_TIERS) -> int:
    """Static stack-frame cube edge for one scan: the reference's slice size
    ``ceil(sqrt(sum(vs^2)/2)/rs/32)*32`` (or ``slice_size``), at least the
    volume's largest edge, rounded up to the smallest tier (capped at the
    largest)."""
    if slice_size is not None:
        need = int(slice_size)
    else:
        need = int(np.ceil(np.sqrt(sum(s * s for s in shape) / 2.0) / rs / 32.0) * 32)
    need = max(need, max(shape))
    for c in sorted(tiers):
        if c >= need:
            return int(c)
    return int(max(tiers))


@dataclass
class ScannerParams:
    """Schema parity with reference ``artifacts/utils.py:10-38``."""

    resolution_slice_fac_min: float
    resolution_slice_fac_max: float
    resolution_slice_max: float
    slice_thickness_min: float
    slice_thickness_max: float
    gap_min: float
    gap_max: float
    min_num_stack: int
    max_num_stack: int
    max_num_slices: int
    noise_sigma_min: float
    noise_sigma_max: float
    TR_min: float
    TR_max: float
    prob_void: float
    prob_gamma: float
    gamma_std: float
    slice_size: int | None = None
    restrict_transform: bool = False
    txy: float = 3.0
    resolution_recon: float | None = None
    slice_noise_threshold: float = 0.1


@dataclass
class ReconParams:
    """Schema parity with reference ``artifacts/utils.py:67-78``."""

    prob_misreg_slice: float
    slices_misreg_ratio: float
    prob_misreg_stack: float
    txy: float
    prob_smooth: float
    prob_rm_slices: float
    rm_slices_min: float
    rm_slices_max: float
    prob_merge: float
    merge_params: ReconMergeParams


def _f32(x) -> float:
    """A host scalar rounded to f32, as the JAX package ships it to the device."""
    return float(np.float32(x))


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one true division (torch computes ``scalar / tensor`` as
    ``t.reciprocal() * a``, two roundings)."""
    return torch.full_like(t, a) / t


def _toeplitz(sigma: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size) Gaussian blur operator of a 0-d ``sigma``."""
    return toeplitz_blur_matrix(sigma.reshape(1), size, _BLUR_HALF)[0]


# ---------------------------------------------------------------------------
# Device stages (one stack)
# ---------------------------------------------------------------------------


def _pad_centered(vol: torch.Tensor, cube: int) -> torch.Tensor:
    """Zero-pad to a centered (cube, cube, cube) buffer."""
    pads = []
    for s in reversed(vol.shape):
        lo = (cube - s) // 2
        pads += [lo, cube - s - lo]
    return F.pad(vol, pads)


def _inplane_coef_tables(G, rs, c_ss, sign: float):
    """(NS, 4) per-slice coefficient tables of the dv and du passes: the
    in-plane deviations are affine per slice, ``pos = cj*row_j + ck*lane +
    bias``. ``sign=+1``: the acquisition's deviation, ``-1``: the
    reconstruction's inverse. dv runs on the (n, u, v) layout with rows 1 of
    ``G``, du on (n, v, u) with rows 2."""
    z = torch.zeros_like(G[:, 0, 0])

    def tab(a, b, g):
        ck = 1.0 + sign * (a - 1.0)
        cj = sign * b
        bias = sign * (-(a - 1.0) * c_ss - b * c_ss + (g - c_ss) / rs)
        return torch.stack([z, cj, ck, bias], -1)

    return tab(G[:, 1, 1], G[:, 1, 2], G[:, 1, 3]), tab(G[:, 2, 2], G[:, 2, 1], G[:, 2, 3])


def _slice_coef_tables(G, rs, c_ss, z0, gap, ns_grid):
    """(dz coefficients (NS, 3), dv table, du table) of one stack's
    extraction; dz is affine per slice, ``a1*v + a2*u + a3``."""
    nidx = torch.arange(ns_grid, dtype=F32, device=G.device)
    dv_tab, du_tab = _inplane_coef_tables(G, rs, c_ss, 1.0)
    dz = torch.stack([G[:, 0, 1], G[:, 0, 2], G[:, 0, 3] - (z0 + nidx * gap)], -1)
    return dz, dv_tab, du_tab


def _dz_lane_table(dz, rs, c_ss, z0, gap_vox, cube, ns_grid, n_near=None, okf=None):
    """(3, cube) lane-affine table of the acquisition's z-deviation pass on
    the (v, u, z) layout: lane z takes the dz coefficients of its nearest
    slice (``n_near[z]``, by default by the nominal plane spacing), in voxel
    units of the stack frame's rows. With the dz-split engaged (``okf`` 1)
    the translation term rides the extraction matmul instead."""
    if n_near is None:
        lanes = torch.arange(cube, dtype=F32, device=dz.device)
        n_near = torch.clamp(torch.round((lanes - z0) / gap_vox), 0, ns_grid - 1).to(torch.int64)
    a = dz[n_near]  # (cube, 3)
    a3 = a[:, 2] if okf is None else a[:, 2] * (1.0 - okf)
    return torch.stack([a[:, 0] * rs, a[:, 1] * rs, a3 - (a[:, 0] + a[:, 1]) * rs * c_ss])


def _dzr_lane_table(Grec, rs, c_ss, z0, gap_vox, ns_grid, okf=None):
    """(3, nsp) lane-affine table of the reconstruction's slice-index pass on
    the (u, v, n) layout, zero past ``ns_grid`` up to ``nsp``, the slice
    count padded to a multiple of 128 as in the JAX package (the pass clamps
    at the last lane, so the padding changes positions past ns_grid - 1).
    With the dz-split engaged (``okf`` 1) the translation rides the
    placement matmul."""
    nidx = torch.arange(ns_grid, dtype=F32, device=Grec.device)
    base_z = z0 + nidx * gap_vox
    g1, g2, g3 = Grec[:, 0, 1], Grec[:, 0, 2], Grec[:, 0, 3]
    t_eff = g3 - base_z if okf is None else (g3 - base_z) * (1.0 - okf)
    dzr = torch.stack([-g2 * rs / gap_vox, -g1 * rs / gap_vox, (-t_eff + (g1 + g2) * rs * c_ss) / gap_vox])
    return F.pad(dzr, (0, -(-ns_grid // _LANE_PAD) * _LANE_PAD - ns_grid))


def _pair(a, b, coefs, disp):
    """One K1 pass of the linear pair (a, b) of (D, H, W) volumes, on rows
    of the storage scope's type (``linops.io_dtype``)."""
    io = io_dtype()
    oa, ob = hat_pass_pair(a.to(io).contiguous()[None], b.to(io).contiguous()[None], coefs[None], disp,
                           nearest_b=False)
    return oa[0], ob[0]


def _single(x, coefs, disp=None):
    """One K2 pass of a (D, H, W) volume on rows of the storage scope's
    type: a (4,) coefficient row with a (3, W) lane-affine ``disp``, or
    (D, 4) per-slice coefficients."""
    return hat_pass(x.to(io_dtype()).contiguous()[None], coefs.contiguous()[None],
                    None if disp is None else disp.contiguous()[None])[0]


def _unit_coefs(device) -> torch.Tensor:
    """The (0, 0, 1, 0) coefficient row: position = lane (+ displacement)."""
    return device_const([0.0, 0.0, 1.0, 0.0], F32, device)


def _extract_pair(Wv, Wm, gap_vox, z0, dz, rs, c_ss, dv, du, cube, ns_grid, split_dz=False):
    """NS slices of the (volume, mask) stack frames, in the (v, u, z) layout
    the rigid warp emits, with shared motion; ``Wm`` None: the volume alone
    (K2 instead of K1).

    The z extraction ``out(n) = V[z0 + gap_vox*n + dz(n)]`` has lane slope
    ``gap_vox``; it factors exactly (for ``gap_vox > 2``) into a unit-slope
    deviation pass ``V'[z] = V[z + dz(n_near(z))]``, ``n_near(z)`` the slice
    nearest to z (lane-affine table: dz is affine per slice), and an
    interpolation matmul ``out(n) = V'[z0 + gap_vox*n]``. The in-plane
    deviations dv and du are per-slice affine: per-slice coefficients.

    ``split_dz`` (the stream's dz-split, a 0/1 float): the per-slice plane
    translation moves from the hat pass into the extraction matmul (slice
    n sampled about its actual plane centre), and lanes attach to the slice
    whose centre is nearest; 0 gives the exact tables in the same program.
    Returns (slices, mask slices or None), (n, v, u) each.
    """
    dev = Wv.device
    nidx = torch.arange(ns_grid, dtype=F32, device=dev)
    okf = n_near = None
    if split_dz is False or split_dz is None:
        Mzn = interp_matrix_1d(z0 + gap_vox * nidx, cube)  # (ns_grid, cube)
    else:
        okf = float(split_dz)
        # plane centres (padded table rows repeat the last real slice: argmin
        # ties resolve to the real row)
        pos_n = z0 + gap_vox * nidx + dz[:, 2] * okf
        if okf > 0.5:
            lanes = torch.arange(cube, dtype=F32, device=dev)
            n_near = torch.argmin(torch.abs(lanes[:, None] - pos_n[None, :]), dim=1)
        Mzn = interp_matrix_1d(pos_n, cube)
    dz_tab = _dz_lane_table(dz, rs, c_ss, z0, gap_vox, cube, ns_grid, n_near, okf)
    unit = _unit_coefs(dev)
    if Wm is not None:
        x, m = _pair(Wv, Wm, unit, dz_tab[None].contiguous())
        # n-extraction emitting (n, u, v)
        m = einsum_store("oi,jki->okj", Mzn, m)
        x = einsum_store("oi,jki->okj", Mzn, x)
        x, m = _pair(x, m, dv, None)
        x, m = _pair(x.transpose(1, 2), m.transpose(1, 2), du, None)  # (n, v, u)
        return x, m
    x = _single(Wv, unit, dz_tab)
    x = einsum_store("oi,jki->okj", Mzn, x)
    x = _single(x, dv)
    return _single(x.transpose(1, 2), du), None


def draw_slice_artifacts(gen: torch.Generator, ns_grid: int, size: int, device, fast: bool = False) -> dict:
    """The device draws of :func:`_slice_artifacts` for one stack: the two
    Rician noise components (one with ``fast``), the void gates and the six
    void shape uniforms."""
    return {
        "noise": torch.randn((1 if fast else 2, ns_grid, size, size), generator=gen, device=device),
        "void_on": torch.rand((ns_grid, 1, 1), generator=gen, device=device),
        "void": torch.rand((6, ns_grid, 1, 1), generator=gen, device=device),
    }


def _slice_artifacts(slices, valid, gamma, gamma_on, sigma, void_prob, threshold, noise, void_on, void,
                     fast=False):
    """Per-slice gamma, Rician noise and signal voids over the valid slices
    (reference ``simulate_reco.py:210-298``). ``fast`` (the stream's mode):
    one normal field, the Rician partner its roll by ``(1, h // 2)``.
    Slices in bf16 (the production mode) come out f32, as the JAX package's
    f32 draws promote them: the gamma's power is taken in f32."""
    if gamma_on:
        # normalization max over the kept slices (simulate_reco.py:210-234)
        g = 300.0 * torch.pow((torch.clamp_min(slices, 0.0) / 300.0).float(), gamma)
        slices = g / torch.clamp_min(torch.max(g * valid[:, None, None]), 1e-6)
    if fast:
        n1 = noise.reshape(slices.shape) * sigma
        n12 = (n1, torch.roll(n1, (1, slices.shape[1] // 2), (0, 1)))
    else:
        n12 = noise * sigma
    noisy = torch.sqrt((slices + n12[0]) ** 2 + n12[1] ** 2)
    slices = torch.where(slices > threshold, noisy, slices)
    # signal voids (simulate_reco.py:258-298); the grid offsets are the
    # exact half-integers (JAX's linspace puts a few an ulp off, ROADMAP §3)
    n, h, w = slices.shape
    on = void_on < void_prob
    y = (torch.arange(h, dtype=F32, device=slices.device) - (h - 1) / 2)[None, :, None]
    x = (torch.arange(w, dtype=F32, device=slices.device) - (w - 1) / 2)[None, None, :]
    yc = (void[0] - 0.5) * (h - 1)
    xc = (void[1] - 0.5) * (w - 1)
    theta = 2 * math.pi * void[2]
    xv = torch.cos(theta) * (x - xc) - torch.sin(theta) * (y - yc)
    yv = torch.sin(theta) * (x - xc) + torch.cos(theta) * (y - yc)
    a = 30 + void[3] * 90
    A = void[4] * 0.5 + 0.5
    sx = void[5] * 30 + 39
    sy = a**2 / sx
    mask = 1 - A * torch.exp(_rdiv(-0.5, sx**2) * xv**2 - _rdiv(0.5, sy**2) * yv**2)
    return torch.where(on, slices * mask, slices)


def _validity(mslices, thr_frac, ns_count, ns_grid):
    """Slice validity from the PSF-free mask-slice mass
    (``simulate_reco.py:408-420``): the slices between the first and the last
    whose mass exceeds ``thr_frac`` of the largest. (NS,) f32."""
    arange_n = torch.arange(ns_grid, device=mslices.device)
    nnz = torch.sum(mslices, (1, 2)) * (arange_n < ns_count)
    valid = nnz > torch.max(nnz) * thr_frac
    first = torch.min(torch.where(valid, arange_n, ns_grid))
    last = torch.max(torch.where(valid, arange_n, -1))
    return ((arange_n >= first) & (arange_n <= last) & (arange_n < ns_count)).to(F32)


def _coarse_mask(mask_p: torch.Tensor, f: int = 4) -> torch.Tensor:
    """Box mean of the padded cube mask over ``f``-cubes (the coarse grid's
    voxel centres land on fine positions ``f*i + (f-1)/2``). A 0/1 mask
    sums exactly, so any summation order gives the same pool."""
    return F.avg_pool3d(mask_p[None, None], f)[0, 0]


def _valid_coarse(cmask, q_idx, angles, wscale, wdelta, G, thr_frac, ns_count, cube: int, ns_grid: int,
                  f: int = 4, zoom_first: bool = False):
    """Slice validity from the z-profile of the rigidly warped coarse mask
    (the stream's fast mode): the relative threshold of
    ``simulate_reco.py:408-420`` cancels every mass-preserving stage, so the
    profile sampled at each plane centre ``G[n, 0, 3]`` on the ``f``-times
    coarser grid decides. Band-edge slices at the threshold may flip against
    the exact mask-mass rule. ``zoom_first``: the small frame's warp order.
    (NS,) f32 flags."""
    from ...ops.warp import warp_rigid_zoom_first

    delta_c = (wdelta + ((f - 1) / 2.0) * (wscale - 1.0)) / f
    if zoom_first:
        wm = warp_rigid_zoom_first(cmask, q_idx, angles, wscale, delta_c)
    else:
        wm, _ = warp_rigid_pair_traced(cmask, None, q_idx, angles, wscale, delta_c)
    prof = torch.sum(wm, (1, 2))  # (cube / f,) z mass profile
    pos_c = (G[:, 0, 3] - (f - 1) / 2.0) / f
    nnz = prec_matmul(interp_matrix_1d(pos_c, cube // f), prof)
    arange_n = torch.arange(ns_grid, device=G.device)
    nnz = nnz * (arange_n < ns_count)
    valid = nnz > torch.max(nnz) * thr_frac
    first = torch.min(torch.where(valid, arange_n, ns_grid))
    last = torch.max(torch.where(valid, arange_n, -1))
    return ((arange_n >= first) & (arange_n <= last) & (arange_n < ns_count)).to(F32)


def _acquire_slices(vol_p, mask_p, fwd, G, rs, gap_vox, z0, sig, cube, ns_grid, split_dz=False):
    """One stack's slices (and mask slices, unless ``mask_p`` is None) from
    the padded cube volume: the rigid warp with the acquisition PSF and xy
    scale, then :func:`_extract_pair`. Under the storage scope the warp
    hands the extraction bf16 (``emit_f32=False``)."""
    dev = vol_p.device
    c_ss = (cube - 1) / 2.0
    lanes = torch.arange(cube, dtype=F32, device=dev)
    # the PSF blur (volume only: the mask slices are PSF-free) and the xy
    # scale to slice-pixel spacing act in the stack frame, so they compose
    # into the rigid warp's zoom matrices
    scale_m = interp_matrix_1d((lanes - c_ss) * rs + c_ss, cube)
    q_idx, angles, wscale, wdelta = fwd
    Wv, Wm = warp_rigid_pair_traced(
        vol_p, mask_p, q_idx, angles, wscale, wdelta,
        post_a=(_toeplitz(sig[0], cube), prec_matmul(scale_m, _toeplitz(sig[1], cube)),
                prec_matmul(scale_m, _toeplitz(sig[2], cube))),
        post_b=None if mask_p is None else (None, scale_m, scale_m),
        out_perm=(1, 2, 0),
        emit_f32=False,
    )
    dz, dv_tab, du_tab = _slice_coef_tables(G, rs, c_ss, z0, gap_vox, ns_grid)
    return _extract_pair(Wv, Wm, gap_vox, z0, dz, rs, c_ss, dv_tab, du_tab, cube, ns_grid, split_dz)


def _acquire_one(vol_p, mask_p, fwd, G, rs, gap_vox, z0, sig, thr_frac, ns_count,
                 gamma, gamma_on, sigma, void_prob, threshold, cube, ns_grid, draws,
                 coarse_mask=None, split_dz=False, valid=None):
    """One stack's acquisition from the padded (cube^3) volume and mask.

    ``fwd`` = (q_idx, angles, scale, delta) of the stack-frame map, ``G`` the
    (NS, 3, 4) slice table, ``sig`` the (3,) acquisition PSF sigmas, ``draws``
    :func:`draw_slice_artifacts`. Returns (slices (NS, SS, SS), valid (NS,)
    f32). Mirrors the reference stack-loop body (``simulate_reco.py:366-424``).
    ``coarse_mask`` (:func:`_coarse_mask`, the stream's fast mode): no mask
    operand, validity from :func:`_valid_coarse`, the fast noise mode;
    ``valid`` gives those flags computed beforehand.
    """
    fast = coarse_mask is not None or valid is not None
    slices, mslices = _acquire_slices(vol_p, None if fast else mask_p, fwd, G, rs, gap_vox, z0, sig, cube,
                                      ns_grid, split_dz)
    if fast:
        if valid is None:
            valid = _valid_coarse(coarse_mask, *fwd, G, thr_frac, ns_count, cube, ns_grid)
    else:
        valid = _validity(mslices, thr_frac, ns_count, ns_grid)
    slices = _slice_artifacts(slices, valid, gamma, gamma_on, sigma, void_prob, threshold, **draws, fast=fast)
    return slices, valid


def _placement(rows, centers, z0, gap_vox, ns_grid):
    """(len(rows), ns_grid) n -> z placement hats of the dz-split: slice n's
    hat (width ``gap_vox``) centred on ``centers[n]``; rows before the slab
    take slice 0 and rows past it the last slice (``interp_matrix``'s edge
    clamp, so a zero split is the exact operator)."""
    Mplace = torch.clamp_min(1.0 - torch.abs((rows[:, None] - centers[None, :]) / gap_vox), 0.0)
    qz = ((rows - z0) / gap_vox)[:, None]
    cols = torch.arange(ns_grid, device=rows.device)[None, :]
    return torch.where(qz < 0, (cols == 0).to(F32), torch.where(qz > ns_grid - 1, (cols == ns_grid - 1).to(F32), Mplace))


def _recon_one(slices, keep_f, Grec, rs, gap_vox, z0, sig_rec, inv, cube, ns_grid, out_shape,
               split_dz=False, coarse_inv=None):
    """One stack's placement on the recon grid: (value, weight), each of
    ``out_shape``. Mirrors the adjoint placement (``simulate_reco.py:38-54,
    769``) with the recon PSF spread.

    The inverse motion runs in slice space (du, dv: K2 per-slice passes on the
    (NS, SS, SS) slices), then the slice-index deviation (K1 lane-affine pass
    over the slice axis, value and weight together), then the affine n -> z
    placement and the z recon PSF as one matmul, the in-plane recon PSF with
    the inverse xy scale, and the inverse rigid warp. The weight is constant
    per slice (``keep_f``) until the slice-index pass, so it skips the
    in-plane passes exactly.

    ``split_dz`` (the stream's dz-split, a 0/1 float): the plane translation
    leaves the slice-index pass for the placement matmul (:func:`_placement`).
    ``coarse_inv`` (the stream's coarse weight chain): the host decomposition
    of the inverse map between the stack frame pooled by ``cube // 128`` and
    the recon frame pooled by 2; the value's slice-index pass runs alone (K2
    lane-affine), the weight runs on the pooled grids (K2 lane-affine on
    (128, 128, nsp)) and is upsampled bilinearly. Needs ``cube % 128 == 0``
    and an even ``out_shape``.
    """
    dev = slices.device
    c_ss = (cube - 1) / 2.0
    lanes = torch.arange(cube, dtype=F32, device=dev)
    okf = None if split_dz is False or split_dz is None else float(split_dz)
    dzr_l = _dzr_lane_table(Grec, rs, c_ss, z0, gap_vox, ns_grid, okf)
    dv_tab, du_tab = _inplane_coef_tables(Grec, rs, c_ss, -1.0)

    inv_scale_m = interp_matrix_1d((lanes - c_ss) / rs + c_ss, cube)
    sigz_m = _toeplitz(sig_rec[0], cube)
    inv_scale_blur_m = prec_matmul(inv_scale_m, _toeplitz(sig_rec[1], cube))

    x = (slices * keep_f[:, None, None]).contiguous()
    x = _single(x, du_tab).transpose(1, 2)  # (n, u, v)
    x = _single(x, dv_tab).permute(1, 2, 0)  # (u, v, n)
    # the slice (lane) axis padded with zero value and zero weight (see
    # _dzr_lane_table)
    nsp = dzr_l.shape[1]
    x = F.pad(x, (0, nsp - ns_grid))
    keep_l = F.pad(keep_f, (0, nsp - ns_grid))
    if coarse_inv is None:
        w = keep_l[None, None, :].expand(cube, cube, nsp)
        x, w = _pair(x, w, _unit_coefs(dev), dzr_l[None].contiguous())
        w = w[..., :ns_grid]
    else:
        x = _single(x, _unit_coefs(dev), dzr_l)
    x = x[..., :ns_grid]
    # n -> z placement and the z recon PSF: one (cube, ns_grid) matmul whose
    # einsum emits (z, v, u)
    nidx = torch.arange(ns_grid, dtype=F32, device=dev)
    if okf is None:
        Mn2z = prec_matmul(sigz_m, interp_matrix_1d((lanes - z0) / gap_vox, ns_grid))
    else:
        base_z = z0 + nidx * gap_vox
        centers = base_z + (Grec[:, 0, 3] - base_z) * okf
        Mn2z = prec_matmul(sigz_m, _placement(lanes, centers, z0, gap_vox, ns_grid))
    x = einsum_store("oi,jki->okj", Mn2z, x)

    def spread(y, m):
        # in-plane recon PSF (simulate_reco.py:338-344) with the inverse xy scale
        return axis_mm(axis_mm(y, m, 1), m, 2)

    q_idx, angles, scale, delta = inv
    if coarse_inv is None:
        w = einsum_store("oi,jki->okj", Mn2z, w)
        return warp_rigid_pair_traced(spread(x, inv_scale_blur_m), spread(w, inv_scale_blur_m), q_idx, angles,
                                      scale, delta, out_shape=out_shape)
    v_s, _ = warp_rigid_pair_traced(spread(x, inv_scale_blur_m), None, q_idx, angles, scale, delta,
                                    out_shape=out_shape)

    # --- the coarse weight chain ---------------------------------------------
    f = max(1, cube // 128)
    cc = cube // f
    h = (f - 1) / 2.0
    # pooled rows sit at fine rows f*u + (f-1)/2: the lane-affine table
    # scales by f, the centre offset folds into the constant
    dzr_c = torch.stack([dzr_l[0] * f, dzr_l[1] * f, dzr_l[2] + (dzr_l[0] + dzr_l[1]) * h])
    w_c = keep_l[None, None, :].expand(cc, cc, nsp)
    w_c = _single(w_c, _unit_coefs(dev), dzr_c)[..., :ns_grid]
    # fine-frame positions of the coarse lanes (every axis of the cube); the
    # blur kernels narrow to sigma / f
    lane_f = f * torch.arange(cc, dtype=F32, device=dev) + h
    sigz_c = _toeplitz(sig_rec[0] / f, cc)
    if okf is None:
        Mn2z_c = prec_matmul(sigz_c, interp_matrix_1d((lane_f - z0) / gap_vox, ns_grid))
    else:
        Mn2z_c = prec_matmul(sigz_c, _placement(lane_f, centers, z0, gap_vox, ns_grid))
    w_c = einsum_store("oi,jki->okj", Mn2z_c, w_c)  # (z_c, v_c, u_c)
    # coarse inverse scale and in-plane PSF: coarse lane -> fine position ->
    # fine source -> coarse source
    src_c = ((lane_f - c_ss) / rs + c_ss - h) / f
    m_c = prec_matmul(interp_matrix_1d(src_c, cc), _toeplitz(sig_rec[1] / f, cc))
    os_c = tuple(s // 2 for s in out_shape)
    w_c, _ = warp_rigid_pair_traced(spread(w_c, m_c), None, *coarse_inv, out_shape=os_c)
    # bilinear upsample (recon frame pooled by 2): fine voxel p reads coarse
    # (p - 0.5) / 2, edge-clamped
    for ax in range(3):
        up = interp_matrix_1d((torch.arange(out_shape[ax], dtype=F32, device=dev) - 0.5) / 2.0, os_c[ax])
        w_c = axis_mm(w_c, up, ax)
    return v_s, w_c


def _finalize(value, weight, volume_gt, smooth_on, merge_on, merge_weight):
    """Equalize, optional box smooth, merge with GT (``simulate_reco.py:584-709``)."""
    ok = weight > 1e-2
    recon = torch.where(ok, value / torch.where(ok, weight, 1.0), 0.0)
    if smooth_on:
        recon = box_sum(recon, 3) / 27.0
    if merge_on:
        recon = merge_weight * recon + (1 - merge_weight) * volume_gt
    return recon


# ---------------------------------------------------------------------------
# Host geometry
# ---------------------------------------------------------------------------


def _axis_affine(R_xyz: np.ndarray, t_xyz: np.ndarray, in_center, out_center):
    """xyz-space rigid (x fastest) -> axis-space affine mapping output grid
    indices to input grid indices: p_in = M q_out + t."""
    M = _FLIP @ R_xyz @ _FLIP
    t = np.asarray(in_center) - M @ np.asarray(out_center) + _FLIP @ t_xyz
    return M.astype(np.float32), t.astype(np.float32)


def _stack_geometry(Rb, mats_vox, shape, ns, cube, ns_grid, fs: float = 1.0):
    """Host geometry for one stack: frame map, warp split, slice table.
    ``Rb``: the stack-init rotation (xyz space); ``mats_vox``: per-slice
    trans-first rigids with voxel-unit translations. ``fs != 1`` (the
    stream's small frame): frame units of ``fs`` voxels on a ``cube``
    buffer, an isotropic scale ``fs`` in the forward map and rescaled slice
    translations; ``fs == 1`` is the host path's geometry."""
    c_vol = (np.asarray(shape) - 1) / 2.0
    c_stack = np.full(3, (cube - 1) / 2.0)
    M = _FLIP @ Rb @ _FLIP
    A = fs * M if fs != 1.0 else M
    t_stack = c_vol - A @ c_stack
    # forward map on the zero-padded cube: p_pad = A q + t_stack + off
    off = np.array([(cube - s) // 2 for s in shape], np.float64)
    fwd = decompose_affine_paeth_host(A, t_stack + off, cube)
    Minv = np.linalg.inv(M)
    if fs == 1.0:
        G = _slice_affine_table(mats_vox, Minv, t_stack, c_vol, ns, ns_grid)
    else:
        G = _slice_affine_table(mats_vox, Minv, c_vol, c_vol, ns, ns_grid, fs=fs, c_frame=(cube - 1) / 2.0)
    return dict(M=M, t_stack=t_stack, Minv=Minv, G=G, fwd=fwd)


def _slice_affine_table(mats_vox, Minv_np, t_stack, c_vol, ns, ns_grid, fs=1.0, c_frame=0.0):
    """(ns_grid, 3, 4) axis-space affines: slice-local coords -> stack frame
    (rows past ``ns`` repeat the last slice). ``fs``/``c_frame`` (the
    stream's small frame, with ``t_stack = c_vol``): translations in a frame
    of ``fs``-voxel units about ``c_frame``; the defaults leave them as they
    are (``+ 0.0``: no -0.0 translations, as in the JAX package)."""
    idx = np.minimum(np.arange(ns_grid), ns - 1)
    Rn = mats_vox[idx, :, :3].astype(np.float64)
    tn = mats_vox[idx, :, 3].astype(np.float64)
    F64 = _FLIP.astype(np.float64)
    Ma = np.einsum("ij,njk,kl->nil", F64, Rn, F64)
    ta = c_vol + np.einsum("ij,njk,nk->ni", F64, Rn, tn)
    G = np.empty((ns_grid, 3, 4), np.float32)
    G[:, :, :3] = np.einsum("ij,njk->nik", Minv_np, Ma)
    G[:, :, 3] = np.einsum("ij,nj->ni", Minv_np, ta - t_stack) / fs + c_frame
    return G


def _gt_to_recon(vol, seg, res: float, res_r: float):
    """Resample (volume, seg) to the recon grid (simulate_reco.py:319-333):
    center-aligned spacing ``res_r``, stored in the ``extent`` corner of the
    same buffer (zeros beyond); linear for the volume, nearest for seg."""
    scale = res_r / res
    lin, nst, extent = [], [], []
    for s in vol.shape:
        nr = max(int(s * res / res_r), 1)
        extent.append(nr)
        coords = device_const((s - 1) / 2.0 + (np.arange(s) - (nr - 1) / 2.0) * scale, F32, vol.device)
        lin.append(interp_matrix_1d(coords, s, out_valid=nr))
        rows = torch.arange(s, device=vol.device)[:, None]
        nst.append(_interp_or_nearest_matrix(coords, s, True) * (rows < nr))
    for axis in range(3):
        vol = axis_mm(vol, lin[axis], axis)
        seg = axis_mm(seg, nst[axis], axis)
    return vol, seg, tuple(extent)


def _fwd_tensors(fwd, device):
    """(q_idx, angles, scale, delta) of a host decomposition, the three
    floats as f32 tensors on ``device``."""
    q, ang, scl, dlt = fwd
    return (int(q), device_const(np.asarray(ang, np.float32), F32, device),
            device_const(np.float32(scl), F32, device), device_const(np.asarray(dlt, np.float32), F32, device))


# ---------------------------------------------------------------------------
# Scanner, reconstructor, SimulateMotion
# ---------------------------------------------------------------------------


class Scanner:
    """Reference-parity scanner (``simulate_reco.py:57-466``).

    ``scan(data, genparams, rng, device_seed)`` simulates multi-stack slice
    acquisition from ``data`` = {volume, mask, seg, resolution} ((D, H, W)
    tensors on the device) and returns ``data`` extended with the slice
    stacks, validity masks and the host transform state the reconstructor
    needs.
    """

    def __init__(self, params: ScannerParams | None = None, tiers: tuple = DEFAULT_TIERS,
                 ns_grid: int = NS, **kw):
        self.p = params if params is not None else ScannerParams(**kw)
        self.tiers = tuple(tiers)
        self.ns_grid = int(ns_grid)

    def get_resolution(self, data, rng, genparams=None):
        """res_slice / res_recon / thickness / gap (``simulate_reco.py:142-191``),
        drawn then overridden by genparams pins, so a pin leaves later draws
        unchanged."""
        genparams = genparams or {}
        sp = self.p
        res = float(data["resolution"])
        res_s = float(rng.uniform(
            sp.resolution_slice_fac_min * res,
            min(sp.resolution_slice_fac_max * res, sp.resolution_slice_max),
        ))
        pin = genparams.get("resolution_slice", genparams.get("resolution_slice_fac"))
        if pin is not None:
            res_s = float(pin)
        if sp.resolution_recon is not None:
            res_r = float(sp.resolution_recon)
        else:
            res_r = res + float(rng.uniform(0.0, 1.0)) * (res_s - res)
        res_r = float(genparams.get("resolution_recon", res_r))
        s_thick = float(rng.uniform(sp.slice_thickness_min, sp.slice_thickness_max))
        s_thick = float(genparams.get("slice_thickness", s_thick))
        gap = float(rng.uniform(sp.gap_min, sp.gap_max))
        gap = float(genparams.get("gap", gap))
        data.update(resolution_slice=res_s, slice_thickness=s_thick, gap=gap, resolution_recon=res_r)
        return data

    def scan(self, data: dict, genparams: dict | None = None, rng=None, device_seed: int | None = None):
        genparams = genparams or {}
        rng = rng or np.random.default_rng()
        if device_seed is None:
            device_seed = int(rng.integers(2**31))
        sp = self.p
        data = self.get_resolution(data, rng, genparams)
        res = float(data["resolution"])
        res_r = data["resolution_recon"]
        res_s = data["resolution_slice"]
        s_thick = data["slice_thickness"]
        gap = data["gap"]
        vol, mask = data["volume"], data["mask"]
        dev = vol.device
        shape = tuple(vol.shape)

        if res_r != res:
            volume_gt, seg_gt, recon_extent = _gt_to_recon(vol, data["seg"], res, res_r)
        else:
            volume_gt, seg_gt, recon_extent = vol, data["seg"], shape
        data.update(volume_gt=volume_gt, seg_gt=seg_gt, recon_extent=tuple(int(x) for x in recon_extent))

        rs = res_s / res
        gap_vox = gap / res
        cube = slice_grid(shape, rs, sp.slice_size, self.tiers)
        ns_grid = self.ns_grid
        ns = min(int(max(shape) * res / gap) + 2, ns_grid)
        num_stacks = int(rng.integers(sp.min_num_stack, sp.max_num_stack + 1))
        sig = device_const([GAUSSIAN_FWHM * s_thick / res, SINC_FWHM * rs, SINC_FWHM * rs], F32, dev)
        c_vol = (np.asarray(shape) - 1) / 2.0
        c_stack = np.full(3, (cube - 1) / 2.0)
        z0 = float(c_stack[0] - (ns - 1) / 2.0 * gap_vox)
        vol_p, mask_p = _pad_centered(vol, cube), _pad_centered(mask, cube)

        # Each round draws Kb = max_num_stack attempts on the host, then
        # acquires them in order and replays the reference's sequential
        # acceptance (simulate_reco.py:366-440): a stack with no valid slice
        # is redrawn, the one that would exceed max_num_slices is discarded.
        # Attempts after the round's decision are not acquired: their device
        # draws are their own, so nothing else changes.
        Kb = int(sp.max_num_stack)
        stacks = []
        total_slices = 0
        attempts = 0
        overflow = False
        while len(stacks) < num_stacks and not overflow and attempts <= 50 * sp.max_num_stack:
            batch = []
            for _ in range(Kb):
                attempts += 1
                t_init = random_init_stack_transforms(ns, gap_vox * res, sp.restrict_transform, sp.txy, rng)
                ts = np.arange(ns) * rng.uniform(sp.TR_min, sp.TR_max)
                t_motion = sample_motion(ts, rng)
                ilv = interleave_index(ns, int(rng.integers(2, int(np.sqrt(ns)) + 1)))
                t_motion = t_motion[np.asarray(ilv)]
                t_target = t_motion.compose(t_init)
                mats_vox = t_target.matrix(True).copy()
                mats_vox[:, :, 3] /= res
                geo = _stack_geometry(t_init.matrix(True)[0, :, :3], mats_vox, shape, ns, cube, ns_grid)
                gamma_on = rng.random() < sp.prob_gamma
                gamma = float(np.exp(sp.gamma_std * rng.standard_normal()))
                sigma = float(rng.uniform(sp.noise_sigma_min, sp.noise_sigma_max))
                thr_frac = float(rng.uniform(0.1, 0.3))
                batch.append(dict(geo=geo, mats_vox=mats_vox, t_init=t_init, attempt=attempts,
                                  scal=(thr_frac, gamma, bool(gamma_on), sigma)))

            for b in batch:
                thr_frac, gamma, gamma_on, sigma = b["scal"]
                geo = b["geo"]
                gen = make_generator(derive_seed(device_seed, 100 + b["attempt"]), dev)
                slices, valid = _acquire_one(
                    vol_p, mask_p, _fwd_tensors(geo["fwd"], dev), device_const(geo["G"], F32, dev),
                    _f32(rs), _f32(gap_vox), _f32(z0), sig, _f32(thr_frac), ns,
                    _f32(gamma), gamma_on, _f32(sigma), _f32(sp.prob_void),
                    _f32(sp.slice_noise_threshold), cube, ns_grid,
                    draw_slice_artifacts(gen, ns_grid, cube, dev),
                )
                valid = valid.cpu().numpy() > 0  # one host sync per attempt
                nvalid = int(valid.sum())
                if nvalid == 0:
                    continue  # reference retry (simulate_reco.py:410-415)
                if sp.max_num_slices is not None and total_slices + nvalid >= sp.max_num_slices:
                    overflow = True  # overflowing stack discarded (simulate_reco.py:425-430)
                    break
                stacks.append(dict(slices=slices, valid=valid, mats_vox=b["mats_vox"],
                                   t_init=b["t_init"], M=geo["M"], Minv=geo["Minv"],
                                   t_stack=geo["t_stack"], ns=ns))
                total_slices += nvalid
                if len(stacks) >= num_stacks:
                    break

        data.update(stacks=stacks, total_slices=total_slices, rs=rs, gap_vox=gap_vox, z0=z0,
                    ns=ns, c_vol=c_vol, c_stack=c_stack, shape=shape, device_seed=device_seed,
                    cube=cube, ns_grid=ns_grid)
        return data


class PSFReconstructor:
    """Reference-parity PSF reconstructor (``simulate_reco.py:469-774``)."""

    def __init__(self, params: ReconParams | None = None, **kw):
        self.p = params if params is not None else ReconParams(**kw)
        self._seeds: dict = {}

    def sample_seeds(self, rng, genparams=None):
        """(``simulate_reco.py:523-560``): drawn then overridden by genparams pins."""
        genparams = genparams or {}
        rp = self.p
        s: dict = {}
        s["smooth_volume_on"] = bool(rng.random() < rp.prob_smooth)
        s["rm_slices_on"] = bool(rng.random() < rp.prob_rm_slices)
        s["misreg_slice_on"] = bool(rng.random() < rp.prob_misreg_slice)
        ratio = float(rng.uniform(rp.rm_slices_min, rp.rm_slices_max)) if s["rm_slices_on"] else None
        if genparams.get("rm_slices_ratio") is not None:
            ratio = float(genparams["rm_slices_ratio"])
        s["rm_slices_ratio"] = ratio
        s["misreg_stack_on"] = []
        s["merge_volume_on"] = bool(rng.random() < rp.prob_merge)
        mp = rp.merge_params

        def pin(name, drawn):
            v = genparams.get(name)
            return int(v) if v is not None else int(drawn)

        if mp.merge_type == "gaussian":
            s["merge_type"] = "gaussian"
            s["ngaussians_merge"] = pin("ngaussians_merge", rng.integers(mp.gauss_ngaussians_min, mp.gauss_ngaussians_max))
        else:
            s["merge_type"] = "perlin"
            pres = rng.choice(mp.perlin_res_list)
            octv = rng.choice(mp.perlin_octaves_list)
            s["res"] = pin("res", pres)
            s["octave"] = pin("octave", octv)
        self._seeds = s
        return s

    def get_seeds(self) -> dict:
        return dict(self._seeds)

    def recon_psf(self, data: dict, genparams: dict | None = None, rng=None):
        rng = rng or np.random.default_rng()
        rp = self.p
        s = self.sample_seeds(rng, genparams)
        device_seed = data["device_seed"]
        res = float(data["resolution"])
        res_r = data["resolution_recon"]
        res_s = data["resolution_slice"]
        s_thick = data["slice_thickness"]
        shape = data["shape"]
        c_vol = data["c_vol"]
        stacks = data["stacks"]
        cube = int(data["cube"])
        ns_grid = int(data["ns_grid"])
        dev = data["volume_gt"].device

        # recon PSF sigmas in recon-voxel units (simulate_reco.py:338-344)
        sig_rec = device_const([GAUSSIAN_FWHM * s_thick / res_r, SINC_FWHM * res_s / res_r], F32, dev)

        # global random slice removal across all valid slices (simulate_reco.py:711-728)
        valid_flat = np.concatenate([st["valid"] for st in stacks]) if stacks else np.zeros(0, bool)
        keep_flat = valid_flat.copy()
        if s["rm_slices_on"] and s["rm_slices_ratio"] is not None and valid_flat.any():
            vidx = np.nonzero(valid_flat)[0]
            n_rm = int(len(vidx) * s["rm_slices_ratio"])
            keep_flat[rng.permutation(vidx)[:n_rm]] = False

        # one misregistered slice (misregister_slices, simulate_reco.py:629-647)
        misreg_slice_global = -1
        if s["misreg_slice_on"] and valid_flat.any():
            vidx = np.nonzero(valid_flat)[0]
            n_mis = max(int(rp.slices_misreg_ratio * len(vidx)), 0)
            cand = rng.permutation(vidx)[:n_mis][:1]  # reference keeps [:1]
            if len(cand):
                misreg_slice_global = int(cand[0])

        # per-stack host geometry, in the reference loop's draw order
        scale = res_r / res
        c_rec = (np.asarray(data["recon_extent"], np.float64) - 1) / 2.0
        per_stack = []
        offset = 0
        for st in stacks:
            ns = st["ns"]
            mats_rec = st["mats_vox"].copy()
            # slice swap first (reference order), then the per-stack offset
            j = misreg_slice_global - offset
            if 0 <= j < ns_grid:
                mats_rec[j] = reset_transform(st["t_init"])[min(j, ns - 1)].matrix(True)[0]
                mats_rec[j, :, 3] /= res
            misreg_stack = bool(rng.random() < rp.prob_misreg_stack)
            s["misreg_stack_on"].append(misreg_stack)
            if misreg_stack:
                off = RigidTransform(np.concatenate([
                    np.broadcast_to(random_angle(1, True, rng), (ns, 3)),
                    np.stack([
                        np.full(ns, rng.uniform(-rp.txy, rp.txy), np.float32),
                        np.full(ns, rng.uniform(-rp.txy, rp.txy), np.float32),
                        np.zeros(ns, np.float32),
                    ], -1),
                ], -1).astype(np.float32))
                mats_rec[:ns] = off.compose(RigidTransform(mats_rec[:ns])).matrix(True)
            Grec = _slice_affine_table(mats_rec, st["Minv"], st["t_stack"], c_vol, ns, ns_grid)
            keep = keep_flat[offset: offset + ns_grid].astype(np.float32)
            offset += ns_grid
            # inverse stack map placing the stack frame on the recon grid:
            # recon index i sits at volume coordinate c_vol + (i - c_rec)*scale
            A_full = st["Minv"] * scale
            t_full = st["Minv"] @ (c_vol - scale * c_rec - st["t_stack"])
            inv = decompose_affine_paeth_host(A_full, t_full, cube)
            per_stack.append((st["slices"], keep, Grec, inv))

        # merge weights (get_merging_weights, simulate_reco.py:649-691)
        mp = rp.merge_params
        if s["merge_volume_on"]:
            if s["merge_type"] == "perlin":
                lattices = (s["res"],) * 3
                gen = make_generator(derive_seed(device_seed, 7), dev)
                mw = fractal_noise_3d(
                    shape, lattices,
                    draw_fractal_uniforms(gen, shape, lattices, s["octave"], mp.perlin_lacunarity,
                                          int(max(mp.perlin_octaves_list)), dev),
                    mp.perlin_persistence, mp.perlin_lacunarity, mp.perlin_increase_size,
                )
            else:
                gen = make_generator(derive_seed(device_seed, 8), dev)
                centers, cvalid = masked_random_centers(
                    torch.rand(shape, generator=gen, device=dev), data["seg_gt"] > 0, 8, s["ngaussians_merge"]
                )
                sigmas = np.clip(20 + 10 * rng.standard_normal((8, 1)), 5, 40)
                mw = mog_3d(shape, centers, device_const(sigmas, F32, dev), cvalid)
        else:
            mw = None

        # all stacks' placement, accumulated in stack order (the JAX
        # package's padding stacks, keep == 0, add exact zeros: skipped)
        value = torch.zeros(shape, dtype=F32, device=dev)
        weight = torch.zeros(shape, dtype=F32, device=dev)
        for slices, keep, Grec, inv in per_stack:
            v_s, w_s = _recon_one(
                slices, device_const(keep, F32, dev), device_const(Grec, F32, dev),
                _f32(data["rs"]), _f32(data["gap_vox"]), _f32(data["z0"]), sig_rec,
                _fwd_tensors(inv, dev), cube, ns_grid, tuple(shape),
            )
            value = value + v_s
            weight = weight + w_s
        out = _finalize(value, weight, data["volume_gt"], s["smooth_volume_on"], s["merge_volume_on"], mw)
        e = data["recon_extent"]
        out[e[0]:] = 0.0
        out[:, e[1]:] = 0.0
        out[:, :, e[2]:] = 0.0
        return out, mw


class SimulateMotion:
    """Reference-parity motion artifact (``artifacts.py:345-425``).

    ``resolution_recon`` is pinned to the volume resolution, as the
    reference's own ``SimulateMotion`` does (``artifacts.py:402``).
    ``seed`` seeds the device draws; the returned metadata holds it as
    ``device_seed`` beside the host stream's ``rng_seed``, and a genparams
    dict with ``rng_seed`` replays the call (its ``device_seed``, if it has
    none, defaults to ``rng_seed``: a JAX package dict replays the geometry).
    """

    def __init__(self, prob: float, scanner_params: ScannerParams, recon_params: ReconParams,
                 tiers: tuple = DEFAULT_TIERS, ns_grid: int = NS):
        self.prob = prob
        self.scanner_args = scanner_params
        self.recon_args = recon_params
        self.tiers = tuple(tiers)
        self.ns_grid = int(ns_grid)

    def __call__(self, output, seg, genparams=None, resolution=(0.5, 0.5, 0.5), rng=None, seed=None, **kw):
        genparams = {k: v for k, v in (genparams or {}).items() if v is not None}
        if "rng_seed" in genparams:
            rng_seed = int(genparams["rng_seed"])
            seed = int(genparams.get("device_seed", rng_seed))
        else:
            rng = rng or np.random.default_rng()
            if rng.random() >= self.prob and not genparams:
                return output, {}
            rng_seed = int(rng.integers(2**63))
            if seed is None:
                seed = int(rng.integers(2**31))
        rng = np.random.default_rng(rng_seed)  # internal stream, replayable

        res = float(resolution[0])
        sp = ScannerParams(**{**self.scanner_args.__dict__, "resolution_recon": res})
        scanner = Scanner(sp, tiers=self.tiers, ns_grid=self.ns_grid)
        recon = PSFReconstructor(self.recon_args)
        output = torch.as_tensor(output, dtype=F32)
        seg = torch.as_tensor(seg, device=output.device)
        data = {
            "resolution": res,
            "volume": output,
            "mask": (seg > 0).to(F32),
            "seg": seg.to(F32),
        }
        # the host path is replay-faithful f32 whatever the caller's scopes
        # (the JAX package pins its acquisition and recon programs so)
        with f32_scope():
            d_scan = scanner.scan(data, genparams, rng=rng, device_seed=seed)
            out, _ = recon.recon_psf(d_scan, genparams, rng=rng)
        meta = {
            "rng_seed": rng_seed,
            "device_seed": seed,
            "resolution_recon": d_scan["resolution_recon"],
            "resolution_slice": d_scan["resolution_slice"],
            "slice_thickness": d_scan["slice_thickness"],
            "gap": d_scan["gap"],
            "nstacks": len(d_scan["stacks"]),
            "total_slices": d_scan["total_slices"],
        }
        meta.update(recon.get_seeds())
        return out, meta
