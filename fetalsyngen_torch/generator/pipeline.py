"""The artifact-free synthesis pipeline, batch-first (port of
``fetalsyngen_tpu.generator.pipeline``).

seed -> GMM intensities -> flip/affine/nonlinear warp -> gamma -> bias field
-> anisotropic resample -> noise -> resize back, over (B, D, H, W) volumes.

As in the JAX package, the reference's dynamic behaviour is fixed-shape:
probability gates are per-sample booleans applied with ``torch.where`` (every
branch computes); low-resolution fields live in static max-size buffers whose
logical extent is a per-sample size tensor; the resample grid is the
full-resolution buffer with a logical corner ``new_size``. No stage reads a
tensor back to the host.

Randomness: one ``torch.Generator`` per sample. :func:`sample_params` draws
the scalar parameters first, then :func:`draw_fields` draws the four voxel
fields from the same generators, so (seed, overrides) -> volume replays.

Precision: f32, or the caller's scopes (``ops.linops``; the stream's bf16
production mode), read by each contraction and hat pass as the JAX
package's ``_synth_core`` reads them. Positions stay f32 either way: the
nonlinear field's upsampling runs under ``f32_scope`` (a bf16 field would
jitter every warp coordinate and flip labels at deformation-cell
boundaries). The labels go through the warp's bf16 passes exactly (they are
below 257).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import trace
from ..kernels import deform_mask
from ..ops.affine import centered_grid, make_affine_matrix
from ..ops.interp import nearest_interp, trilinear_interp, zoom_coords
from ..ops.linops import apply_separable, f32_scope, gaussian_blur_mm, interp_matrix, zoom_mm
from ..ops.numerics import device_const
from ..ops.warp import (
    FIELD_LIM,
    ul_decompose,
    warp_affine_field_pair,
    warp_affine_field_pair_pre,
    warp_affine_field_separable,
    warp_affine_separable,
)
from .config import GeneratorCfg
from .params import GenParams, sample_params


@dataclasses.dataclass(frozen=True)
class Fields:
    """The four standard-normal voxel fields of a batch."""

    intensity: torch.Tensor  # (B, D, H, W)
    nonlin: torch.Tensor  # (B, 3, *cfg.deform.small_field_max())
    bias: torch.Tensor  # (B, *cfg.bias_field.small_field_max(shape))
    noise: torch.Tensor  # (B, D, H, W)

    def to(self, device) -> Fields:
        return Fields(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def field_shapes(cfg: GeneratorCfg) -> dict[str, tuple[int, ...]]:
    """Per-sample shape of each voxel field."""
    shape = tuple(cfg.shape)
    return {
        "intensity": shape,
        "nonlin": (3, *cfg.deform.small_field_max()),
        "bias": tuple(cfg.bias_field.small_field_max(shape)),
        "noise": shape,
    }


def draw_fields(generators, cfg: GeneratorCfg, device) -> Fields:
    """Draw each sample's voxel fields from its generator, on ``device``
    (the generators' device)."""
    shapes = field_shapes(cfg)
    per = {name: [] for name in shapes}
    for g in generators:
        for name, shp in shapes.items():
            per[name].append(torch.randn(shp, generator=g, device=device, dtype=torch.float32))
    return Fields(**{name: torch.stack(v) for name, v in per.items()})


def make_generators(seeds_per_sample, device) -> list[torch.Generator]:
    """One seeded ``torch.Generator`` per sample on ``device``."""
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds_per_sample]


def _bcast(v: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """A (B,) per-sample value shaped to broadcast over (B, ...) of ``ndim`` dims."""
    return v.reshape(v.shape[0], *([1] * (ndim - 1)))


# ---------------------------------------------------------------------------
# Stage 1: GMM intensity sampling (reference rand_gmm.py:101-154)
# ---------------------------------------------------------------------------

def intensity_stage(seeds: torch.Tensor, p: GenParams, noise: torch.Tensor) -> torch.Tensor:
    """``max(mus[seeds] + sigmas[seeds] * noise, 0)``, labels clamped to the table."""
    B = seeds.shape[0]
    nlabels = p.mus.shape[1]
    idx = torch.clamp(seeds.reshape(B, -1).to(torch.int64), 0, nlabels - 1)
    mu = torch.gather(p.mus, 1, idx).reshape(seeds.shape)
    sigma = torch.gather(p.sigmas, 1, idx).reshape(seeds.shape)
    return torch.clamp_min(mu + sigma * noise, 0.0)


# ---------------------------------------------------------------------------
# Stage 2: spatial deformation (reference affine_nonrigid.py:86-366)
# ---------------------------------------------------------------------------

def _small_field(p: GenParams, f_nonlin: torch.Tensor) -> torch.Tensor:
    return _bcast(p.nonlin_std, 5) * f_nonlin


def _nonlin_field(p: GenParams, f_nonlin: torch.Tensor, cfg: GeneratorCfg):
    """Upsample the low-res displacement field to three (B, D, H, W) volumes,
    in f32 whatever the caller's scopes (positions)."""
    shape = tuple(cfg.shape)
    f_small = _small_field(p, f_nonlin)
    factor = device_const(shape, torch.float32, f_small.device) / p.size_F_small.to(torch.float32)
    with f32_scope():
        return tuple(zoom_mm(f_small[:, c], shape, factor, in_shape=p.size_F_small) for c in range(3))


def deformation_coords(p: GenParams, f_nonlin: torch.Tensor, cfg: GeneratorCfg):
    """Warp coordinate grids ``xx2, yy2, zz2`` (B, D, H, W) of
    ``generate_deformation`` + ``deform_image`` (``affine_nonrigid.py:195-366``)."""
    shape = tuple(cfg.shape)
    dev = f_nonlin.device
    xc, yc, zc = centered_grid(shape, dev)
    if cfg.deform.nonlinear_transform:
        Fx, Fy, Fz = _nonlin_field(p, f_nonlin, cfg)
        xx1, yy1, zz1 = xc + Fx, yc + Fy, zc + Fz
    else:
        zeros = torch.zeros((f_nonlin.shape[0], *shape), dtype=torch.float32, device=dev)
        xx1, yy1, zz1 = xc + zeros, yc + zeros, zc + zeros

    A = make_affine_matrix(p.rotations, p.shears, p.scalings)
    c2 = [(s - 1.0) / 2.0 for s in shape]
    out = []
    for r in range(3):
        v = _bcast(A[:, r, 0]) * xx1 + _bcast(A[:, r, 1]) * yy1 + _bcast(A[:, r, 2]) * zz1 + c2[r]
        v = torch.clamp(v, 0, shape[r] - 1)
        if cfg.deform.margin_shift:
            # affine_nonrigid.py:350-358: shift coords by the floor of their min
            v = v - _bcast(torch.floor(torch.amin(v, dim=(1, 2, 3))))
        out.append(v)
    return tuple(out)


def pair_mask_plain(h_s, size, A, c2, shape, margin_shift: bool):
    """The composite OOB mask and margin shift of the small-field pair warp
    from the zoomed A-mixed field ``H = zoom(h_s)`` (``deform_image``'s clamp
    and ``floor(min(coord))``, ``affine_nonrigid.py:327-366``): (shift (B,
    3), ok (B, D, H, W) bool). The plain version of ``kernels.deform_mask``,
    taken for CPU tensors."""
    factor = device_const(shape, torch.float32, h_s.device) / size.to(torch.float32)
    with f32_scope():
        Hs = [zoom_mm(h_s[:, c], shape, factor, in_shape=size) for c in range(3)]

    xc, yc, zc = centered_grid(shape, h_s.device)
    coords = []
    for r, Hr in enumerate(Hs):
        v = _bcast(A[:, r, 0]) * xc + _bcast(A[:, r, 1]) * yc + _bcast(A[:, r, 2]) * zc + _bcast(c2[:, r]) + Hr
        coords.append(torch.clamp(v, 0, shape[r] - 1))

    if margin_shift:
        shift = torch.stack([torch.floor(torch.amin(c, dim=(1, 2, 3))) for c in coords], dim=1)
    else:
        shift = torch.zeros_like(c2)

    ok = None
    for r, c in enumerate(coords):
        cr = c - _bcast(shift[:, r])
        okr = (cr > 0) & (cr <= shape[r] - 1)
        ok = okr if ok is None else ok & okr
    return shift, ok


def _deform_pair_small_fields(p, f_nonlin, cfg, A, c1, c2, vol_lin, vol_near):
    """Pair warp with every field combination formed on the SMALL field.

    The L-mixed warp displacements are upsampled straight into each hat
    pass's layout, and the A-mixed coordinate deviations ``H = A F`` give the
    composite OOB mask and the margin shift: on the card the two kernels of
    ``kernels.deform_mask`` form ``H`` on the fly from the small field, on
    the CPU :func:`pair_mask_plain` zooms it. Positions stay f32: the
    upsampling runs under ``f32_scope``.
    """
    shape = tuple(cfg.shape)
    dev = vol_lin.device
    f_small = _small_field(p, f_nonlin)
    _, L = ul_decompose(A)
    lim = FIELD_LIM

    def s4(v):
        return _bcast(v, 4)

    gx_s = f_small[:, 0]
    gy_s = s4(L[:, 1, 0]) * f_small[:, 0] + f_small[:, 1]
    gz_s = s4(L[:, 2, 0]) * f_small[:, 0] + s4(L[:, 2, 1]) * f_small[:, 1] + f_small[:, 2]
    h_s = torch.einsum("bij,bjxyz->bixyz", A, f_small)
    factor = device_const(shape, torch.float32, dev) / p.size_F_small.to(torch.float32)

    def zoomP(small, perm):
        out_shape = tuple(shape[q] for q in perm)
        return zoom_mm(
            small.permute(0, *(q + 1 for q in perm)),
            out_shape,
            torch.stack([factor[:, q] for q in perm], 1),
            in_shape=torch.stack([p.size_F_small[:, q] for q in perm], 1),
        )

    with f32_scope():
        gyT = torch.clamp(zoomP(gy_s, (0, 2, 1)), -lim, lim)
        gz = torch.clamp(zoomP(gz_s, (0, 1, 2)), -lim, lim)
        gxT = torch.clamp(zoomP(gx_s, (1, 2, 0)), -lim, lim)

    if dev.type == "cuda":
        field = (h_s.contiguous(), p.size_F_small.contiguous(), A.contiguous(), c2)
        shift = deform_mask.mask_shift(*field, shape) if cfg.deform.margin_shift else torch.zeros_like(c2)
    else:
        shift, ok = pair_mask_plain(h_s, p.size_F_small, A, c2, shape, cfg.deform.margin_shift)

    t = c2 - torch.einsum("bij,bj->bi", A, c1) - shift
    a, b = warp_affine_field_pair_pre(vol_lin, vol_near, A, t, gyT, gz, gxT)
    if dev.type == "cuda":
        return deform_mask.mask_apply(a, *field, shift), b.to(vol_near.dtype)
    return torch.where(ok, a, 0.0), b.to(vol_near.dtype)


def _deform_separable(p, f_nonlin, cfg, volumes_linear, volumes_nearest):
    """Separable warp (``warp_impl='separable'``) of lists of linear and
    nearest volumes: ``V[A (o - c1 + F(o)) + c2 - shift]`` with the composite
    OOB mask and margin shift in closed form. Returns (linear list, nearest
    list).

    The branches are the JAX package's: the (image, segmentation) pair alone
    forms its field combinations on the small field; with an extra linear
    volume the pair takes the paired passes on full-resolution fields and the
    extra volume the single-operand field warp (six K2 passes); without the
    nonlinear field every volume takes the affine warp (five K2 passes).
    """
    shape = tuple(cfg.shape)
    nonlinear = cfg.deform.nonlinear_transform
    dev = volumes_linear[0].device
    B = volumes_linear[0].shape[0]
    c1 = device_const([(s - 1.0) / 2.0 for s in shape], torch.float32, dev).expand(B, 3)
    c2 = c1  # random_shift degenerates to the centre when the crop equals the shape
    A = make_affine_matrix(p.rotations, p.shears, p.scalings)

    if nonlinear and len(volumes_linear) == 1 and len(volumes_nearest) == 1:
        a, b = _deform_pair_small_fields(
            p, f_nonlin, cfg, A, c1, c2, volumes_linear[0], volumes_nearest[0]
        )
        return [a], [b]

    if nonlinear:
        Fx, Fy, Fz = _nonlin_field(p, f_nonlin, cfg)
    else:
        Fx = Fy = Fz = torch.zeros((B, *shape), dtype=torch.float32, device=dev)

    # composite raw coordinates, their clamp, the margin shift and the mask
    xc, yc, zc = centered_grid(shape, dev)
    g = (xc + Fx, yc + Fy, zc + Fz)
    coords = []
    for r in range(3):
        v = (_bcast(A[:, r, 0]) * g[0] + _bcast(A[:, r, 1]) * g[1] + _bcast(A[:, r, 2]) * g[2]
             + _bcast(c2[:, r]))
        coords.append(torch.clamp(v, 0, shape[r] - 1))
    if cfg.deform.margin_shift:
        shift = torch.stack([torch.floor(torch.amin(c, dim=(1, 2, 3))) for c in coords], dim=1)
    else:
        shift = torch.zeros_like(c2)
    ok = None
    for r, c in enumerate(coords):
        cr = c - _bcast(shift[:, r])
        okr = (cr > 0) & (cr <= shape[r] - 1)
        ok = okr if ok is None else ok & okr

    t = c2 - torch.einsum("bij,bj->bi", A, c1) - shift

    def run(vol, nearest):
        if nonlinear:
            return warp_affine_field_separable(vol, A, t, Fx, Fy, Fz, nearest=nearest)
        return warp_affine_separable(vol, A, t, nearest=nearest)

    if nonlinear and len(volumes_nearest) == 1:
        a, b = warp_affine_field_pair(volumes_linear[0], volumes_nearest[0], A, t, Fx, Fy, Fz)
        lin = [torch.where(ok, a, 0.0)] + [
            torch.where(ok, run(v, False), 0.0) for v in volumes_linear[1:]
        ]
        return lin, [b.to(volumes_nearest[0].dtype)]
    lin = [torch.where(ok, run(v, False), 0.0) for v in volumes_linear]
    near = [run(v.to(torch.float32), True).to(v.dtype) for v in volumes_nearest]
    return lin, near


def deform_stage(p: GenParams, f_nonlin: torch.Tensor, cfg: GeneratorCfg, output, segmentation,
                 image=None):
    """Flip + warp of the output and the optional co-deformed ``image``
    (linear) and the segmentation (nearest). Returns (output, segmentation,
    image or None).

    When the gate is off there is neither flip nor warp
    (``generate_deformation_and_flip``, ``affine_nonrigid.py:122-162``).
    """
    apply = _bcast(p.deform_apply)
    flip = _bcast(p.flip & p.deform_apply)
    lins = [output] + ([image] if image is not None else [])
    lins_f = [torch.where(flip, v.flip(1), v) for v in lins]
    seg_f = torch.where(flip, segmentation.flip(1), segmentation)

    if cfg.deform.warp_impl == "exact":
        xx2, yy2, zz2 = deformation_coords(p, f_nonlin, cfg)
        lin_w = [trilinear_interp(v, xx2, yy2, zz2) for v in lins_f]
        seg_w = nearest_interp(seg_f, xx2, yy2, zz2)
    else:
        lin_w, (seg_w,) = _deform_separable(p, f_nonlin, cfg, lins_f, [seg_f])
    out_w = [torch.where(apply, w, v) for w, v in zip(lin_w, lins)]
    img = out_w[1] if image is not None else None
    return out_w[0], torch.where(apply, seg_w, segmentation), img


# ---------------------------------------------------------------------------
# Stage 3: gamma (synthseg.py:250-275)
# ---------------------------------------------------------------------------

def gamma_stage(output: torch.Tensor, p: GenParams) -> torch.Tensor:
    transformed = 300.0 * torch.pow(torch.clamp_min(output, 0.0) / 300.0, _bcast(p.gamma))
    return torch.where(_bcast(p.gamma_apply), transformed, output)


# ---------------------------------------------------------------------------
# Stage 4: bias field (synthseg.py:144-188)
# ---------------------------------------------------------------------------

def bias_stage(output: torch.Tensor, p: GenParams, f_bias: torch.Tensor, cfg: GeneratorCfg):
    shape = tuple(cfg.shape)
    small = _bcast(p.bf_std) * f_bias
    factor = device_const(shape, torch.float32, output.device) / p.bf_size.to(torch.float32)
    bf = torch.exp(zoom_mm(small, shape, factor, in_shape=p.bf_size))
    return torch.where(_bcast(p.bf_apply), output * bf, output)


# ---------------------------------------------------------------------------
# Stage 5+6+7: resample -> noise -> resize back
# (synthseg.py:50-114, 206-235; orchestration model.py:193-207)
# ---------------------------------------------------------------------------

def resample_noise_stage(output: torch.Tensor, p: GenParams, f_noise: torch.Tensor, cfg: GeneratorCfg):
    shape = tuple(cfg.shape)
    dev = output.device
    in_res = device_const(cfg.resolution, torch.float32, dev)
    apply = p.resample_apply
    shape_f = device_const(shape, torch.float32, dev)

    # blur (synthseg.py:78-81): std law, zeroed where spacing <= in_res
    log5 = torch.log(torch.full((), 5.0, dtype=torch.float32, device=dev))
    stds = p.blur_mult[:, None] * log5 / math.pi * p.spacing / in_res
    stds = torch.where((p.spacing > in_res) & apply[:, None], stds, 0.0)
    blurred = gaussian_blur_mm(output, stds, cfg.resample.blur_half_len(cfg.resolution))

    # downsample to the logical corner [0:new_size] (synthseg.py:84-104): the
    # trilinear product-grid interpolation factorises into three 1-D operators
    new_size = torch.where(apply[:, None], p.new_size, shape_f.to(torch.int32))
    factors = new_size.to(torch.float32) / shape_f
    down_Ms = tuple(
        interp_matrix(
            zoom_coords(shape[a], factors[:, a]), shape[a], out_valid=new_size[:, a], oob_zero=True
        )
        for a in range(3)
    )
    ds = torch.where(_bcast(apply), apply_separable(blurred, down_Ms), blurred)

    # noise at the logical low resolution (synthseg.py:218-233)
    corner = None
    for a in range(3):
        idx = torch.arange(shape[a], device=dev).reshape([1] + [shape[a] if i == a else 1 for i in range(3)])
        inside = idx < new_size[:, a].reshape(-1, 1, 1, 1)
        corner = inside if corner is None else corner & inside
    noisy = torch.clamp_min(ds + _bcast(p.noise_std) * f_noise * corner, 0.0)
    noisy = torch.where(_bcast(p.noise_apply), noisy, ds)

    # resize back (synthseg.py:109-114): zoom by 1/factors, then divide by the max
    up_Ms = tuple(
        interp_matrix(
            zoom_coords(shape[a], shape_f[a] / new_size[:, a].to(torch.float32)),
            shape[a],
            in_valid=new_size[:, a],
        )
        for a in range(3)
    )
    up = apply_separable(noisy, up_Ms)
    peak = _bcast(torch.amax(up, dim=(1, 2, 3)))
    up = up / torch.where(peak > 0, peak, 1.0)
    return torch.where(_bcast(apply), up, noisy)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

# Stage sets of the reference's split public API (model.py:94-159 generate =
# intensity + deform; model.py:161-229 augment = gamma .. resize back).
STAGES_ALL = ("intensity", "deform", "augment")
STAGES_GENERATE = ("intensity", "deform")
STAGES_AUGMENT = ("augment",)


def synth_core(
    p: GenParams, fields: Fields, seeds: torch.Tensor | None, seg: torch.Tensor, cfg: GeneratorCfg,
    image: torch.Tensor | None = None, intensity_prior: torch.Tensor | None = None,
    stages: tuple = STAGES_ALL,
):
    """One batch through the ``stages`` (counterpart of ``_synth_core_body``).

    (B, D, H, W) seed labels and segmentation -> (output, segmentation,
    image or None). The output starts as the GMM intensities of ``seeds``,
    or as ``intensity_prior`` when given (image as intensity, or augment
    alone; ``seeds`` is then unused). An ``image`` is co-deformed with the
    output. With tracing on, each stage is a span (``core.<stage>``).
    """
    cuda = seg.is_cuda
    if intensity_prior is not None:
        output = intensity_prior
    elif "intensity" in stages:
        with trace.span("core.intensity", cuda=cuda):
            output = intensity_stage(seeds, p, fields.intensity)
    else:
        raise ValueError(f"stages {stages} without 'intensity' need an intensity_prior")
    if "deform" in stages:
        with trace.span("core.deform", cuda=cuda):
            output, seg, image = deform_stage(p, fields.nonlin, cfg, output, seg, image)
    if "augment" in stages:
        with trace.span("core.gamma", cuda=cuda):
            output = gamma_stage(output, p)
        with trace.span("core.bias", cuda=cuda):
            output = bias_stage(output, p, fields.bias, cfg)
        with trace.span("core.resample_noise", cuda=cuda):
            output = resample_noise_stage(output, p, fields.noise, cfg)
    return output, seg, image


def synth_batch(seeds, segs, cfg: GeneratorCfg, seeds_per_sample, device, overrides=None):
    """Generate a batch: (B, D, H, W) seed labels and segmentations, one
    integer seed per sample. Returns (image, segmentation, GenParams)."""
    if tuple(seeds.shape[1:]) != tuple(cfg.shape) or seeds.shape != segs.shape:
        raise ValueError(f"seeds/segs {tuple(seeds.shape)}/{tuple(segs.shape)} do not match cfg.shape {cfg.shape}")
    if len(seeds_per_sample) != seeds.shape[0]:
        raise ValueError(f"{len(seeds_per_sample)} seeds for a batch of {seeds.shape[0]}")
    gens = make_generators(seeds_per_sample, device)
    p = sample_params(gens, cfg, overrides)
    fields = draw_fields(gens, cfg, device)
    out, seg, _ = synth_core(p, fields, seeds.to(device), segs.to(device), cfg)
    return out, seg, p


def synth_sample(seeds, seg, cfg: GeneratorCfg, seed: int, device, overrides=None):
    """Generate one (D, H, W) sample; returns (image, segmentation, GenParams with B=1)."""
    out, seg_out, p = synth_batch(seeds[None], seg[None], cfg, [seed], device, overrides)
    return out[0], seg_out[0], p
