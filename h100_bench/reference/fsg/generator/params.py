"""Per-sample generation parameters: the replay contract (port of
``fetalsyngen_tpu.generator.params``).

``GenParams`` is a dataclass of (B, ...) tensors, one row per sample.
:func:`sample_params` draws them from one ``torch.Generator`` per sample under
the same laws as the JAX package. Streams are positional: every value is drawn
on every call, in a fixed layout, and overridden values replace their draws
afterwards. So pinning one parameter never shifts another parameter's draw,
nor the voxel fields drawn after the parameters from the same generator, and
(seed, overrides) -> volume replays exactly.

A value present in ``overrides`` forces its stage's probability gate on
unless the gate itself is also overridden, as in the reference
(``model.py:99-113``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..ops.numerics import device_const, floor_div_exact
from .config import GeneratorCfg


@dataclasses.dataclass(frozen=True)
class GenParams:
    """Dense per-sample generation parameters, each a (B, ...) tensor."""

    # seed_intensities (rand_gmm.py:120-145)
    mus: torch.Tensor  # (B, nlabels) f32
    sigmas: torch.Tensor  # (B, nlabels) f32
    # deform_params (affine_nonrigid.py:140-151, 239-325)
    deform_apply: torch.Tensor  # (B,) bool
    flip: torch.Tensor  # (B,) bool
    rotations: torch.Tensor  # (B, 3) radians
    shears: torch.Tensor  # (B, 3)
    scalings: torch.Tensor  # (B, 3)
    nonlin_scale: torch.Tensor  # (B,)
    nonlin_std: torch.Tensor  # (B,)
    size_F_small: torch.Tensor  # (B, 3) int32
    # gamma_params (synthseg.py:263-268)
    gamma_apply: torch.Tensor  # (B,) bool
    gamma: torch.Tensor  # (B,)
    # bf_params (synthseg.py:157-170)
    bf_apply: torch.Tensor  # (B,) bool
    bf_scale: torch.Tensor  # (B,)
    bf_std: torch.Tensor  # (B,)
    bf_size: torch.Tensor  # (B, 3) int32
    # resample_params (synthseg.py:63-80)
    resample_apply: torch.Tensor  # (B,) bool
    spacing: torch.Tensor  # (B, 3)
    new_size: torch.Tensor  # (B, 3) int32 downsample grid (synthseg.py:84)
    blur_mult: torch.Tensor  # (B,) the (0.85 + 0.3 U) blur factor
    # noise_params (synthseg.py:218-223)
    noise_apply: torch.Tensor  # (B,) bool
    noise_std: torch.Tensor  # (B,)

    def to(self, device) -> GenParams:
        return GenParams(**{k: v.to(device) for k, v in self.items()})

    def items(self):
        return ((f.name, getattr(self, f.name)) for f in dataclasses.fields(self))


_BOOL = ("deform_apply", "flip", "gamma_apply", "bf_apply", "resample_apply", "noise_apply")
_INT = ("size_F_small", "bf_size", "new_size")
_VEC3 = ("rotations", "shears", "scalings", "size_F_small", "bf_size", "spacing", "new_size")


def field_dtype(name: str) -> torch.dtype:
    if name in _BOOL:
        return torch.bool
    if name in _INT:
        return torch.int32
    return torch.float32


def sample_ndim(name: str) -> int:
    """Dimensions of one sample's value of field ``name`` (batch dim excluded)."""
    return 1 if name in _VEC3 or name in ("mus", "sigmas") else 0


def resolve_new_size_override(ov: dict, cfg: GeneratorCfg) -> dict:
    """Derive the ``new_size`` override from a ``spacing`` override in f64.

    The reference truncates the f64 quotient on the host
    (``synthseg.py:84``); f64(1.2) and f32(1.2) sit on opposite sides of the
    ``24 / 1.2`` truncation boundary, so a host spacing keeps its full
    precision for this step.
    """
    if "spacing" in ov and "new_size" not in ov:
        spacing = ov["spacing"]
        if isinstance(spacing, torch.Tensor):
            spacing = spacing.detach().cpu().numpy()
        ov = dict(ov)
        ov["new_size"] = (
            np.asarray(cfg.shape)
            * np.asarray(cfg.resolution, np.float64)
            / np.asarray(spacing, np.float64)
        ).astype(np.int32)
    return ov


def _layout(cfg: GeneratorCfg):
    """Fixed positional layout of one sample's uniform and normal draws."""
    nl = cfg.intensity.nlabels
    uniform = (
        ("mus", nl), ("sigmas", nl), ("deform_apply", 1), ("flip", 1), ("rotations", 3),
        ("shears", 3), ("scalings", 3), ("nonlin_scale", 1), ("nonlin_std", 1),
        ("gamma_apply", 1), ("bf_apply", 1), ("bf_scale", 1), ("bf_std", 1),
        ("resample_apply", 1), ("spacing", 1), ("blur_mult", 1), ("noise_apply", 1),
        ("noise_std", 1),
    )
    normal = (("class_perturb", len(cfg.intensity.seed_labels)), ("gamma", 1))
    return uniform, normal


def _split(flat: torch.Tensor, layout) -> dict[str, torch.Tensor]:
    out, o = {}, 0
    for name, n in layout:
        v = flat[:, o : o + n]
        out[name] = v if n > 1 or name in ("mus", "sigmas", "class_perturb") else v[:, 0]
        o += n
    return out


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s affine map of [0, 1) draws onto [lo, hi)."""
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def _draw_raw(generators, cfg: GeneratorCfg):
    """One positional block of uniform and normal draws per generator:
    ({name: (B, n) uniform}, {name: (B, n) normal})."""
    uniform, normal = _layout(cfg)
    nu = sum(n for _, n in uniform)
    nn = sum(n for _, n in normal)
    us, ns = [], []
    for g in generators:
        us.append(torch.rand(nu, generator=g, device=g.device, dtype=torch.float32))
        ns.append(torch.randn(nn, generator=g, device=g.device, dtype=torch.float32))
    return _split(torch.stack(us), uniform), _split(torch.stack(ns), normal)


def sample_params(generators, cfg: GeneratorCfg, overrides: dict[str, Any] | None = None) -> GenParams:
    """Draw a (B, ...) ``GenParams`` from one generator per sample.

    ``overrides`` uses the flat field names of :class:`GenParams`; each value
    is broadcast to every sample. Every value is drawn whatever the
    overrides, then the overridden ones replace their draws.
    """
    ov = resolve_new_size_override(dict(overrides or {}), cfg)
    u, n = _draw_raw(generators, cfg)
    B = len(generators)
    dev = generators[0].device
    shape_f = device_const(cfg.shape, torch.float32, dev)

    def pinned(name):
        v = torch.as_tensor(np.array(ov[name]), device=dev).to(field_dtype(name))
        per_sample = (3,) if name in _VEC3 else (cfg.intensity.nlabels,) if sample_ndim(name) else ()
        return torch.broadcast_to(v, (B, *per_sample)).clone()

    def get(name, drawn):
        return pinned(name) if name in ov else drawn

    def gate(name, p, dependents):
        if name in ov:
            return pinned(name)
        if any(d in ov for d in dependents):
            return torch.ones(B, dtype=torch.bool, device=dev)
        return u[name] < p

    icfg = cfg.intensity
    mus = 25.0 + 200.0 * u["mus"]
    if tuple(icfg.generation_classes) != tuple(icfg.seed_labels):
        # class-tied perturbation (rand_gmm.py:139-145): labels sharing a
        # generation class share a mean up to +-25 noise
        classes = device_const(icfg.generation_classes, torch.int64, dev)
        labels = device_const(icfg.seed_labels, torch.int64, dev)
        tied = torch.clamp(mus[:, classes] + 25.0 * n["class_perturb"], 0.0, 225.0)
        mus = mus.index_copy(1, labels, tied)
    mus = get("mus", mus)
    sigmas = get("sigmas", 5.0 + 20.0 * u["sigmas"])

    dcfg = cfg.deform
    deform_apply = gate(
        "deform_apply",
        dcfg.prob,
        ("rotations", "shears", "scalings", "nonlin_scale", "nonlin_std", "size_F_small", "flip"),
    )
    flip = get("flip", u["flip"] < dcfg.flip_prb)
    mr = dcfg.max_rotation
    rotations = get("rotations", _uniform(u["rotations"], -mr, mr) / 180.0 * math.pi)
    shears = get("shears", _uniform(u["shears"], -dcfg.max_shear, dcfg.max_shear))
    scalings = get(
        "scalings", 1.0 + _uniform(u["scalings"], -dcfg.max_scaling, dcfg.max_scaling)
    )
    nonlin_scale = get(
        "nonlin_scale", _uniform(u["nonlin_scale"], dcfg.nonlin_scale_min, dcfg.nonlin_scale_max)
    )
    size_F_small = get(
        "size_F_small", torch.round(nonlin_scale[:, None] * shape_f).to(torch.int32)
    )
    nonlin_std = get("nonlin_std", dcfg.nonlin_std_max * u["nonlin_std"])

    gcfg = cfg.gamma
    gamma_apply = gate("gamma_apply", gcfg.prob, ("gamma",))
    gamma = get("gamma", torch.exp(gcfg.gamma_std * n["gamma"]))

    bcfg = cfg.bias_field
    bf_apply = gate("bf_apply", bcfg.prob, ("bf_scale", "bf_std", "bf_size"))
    bf_scale = get("bf_scale", _uniform(u["bf_scale"], bcfg.scale_min, bcfg.scale_max))
    bf_size = get(
        "bf_size", torch.clamp_min(torch.round(bf_scale[:, None] * shape_f).to(torch.int32), 1)
    )
    bf_std = get("bf_std", _uniform(u["bf_std"], bcfg.std_min, bcfg.std_max))

    rcfg = cfg.resample
    resample_apply = gate("resample_apply", rcfg.prob, ("spacing",))
    spacing = get(
        "spacing",
        _uniform(u["spacing"], rcfg.min_resolution, rcfg.max_resolution)[:, None].expand(B, 3),
    )
    blur_mult = get("blur_mult", 0.85 + 0.3 * u["blur_mult"])
    # downsample grid: trunc(shape * res / spacing) (synthseg.py:84), the f64
    # law reproduced in f32; a host spacing override was resolved in f64 above
    res_f = device_const(cfg.resolution, torch.float32, dev)
    new_size = get("new_size", floor_div_exact(shape_f * res_f, spacing))

    ncfg = cfg.noise
    noise_apply = gate("noise_apply", ncfg.prob, ("noise_std",))
    noise_std = get("noise_std", _uniform(u["noise_std"], ncfg.std_min, ncfg.std_max))

    return GenParams(
        mus=mus, sigmas=sigmas, deform_apply=deform_apply, flip=flip, rotations=rotations,
        shears=shears, scalings=scalings, nonlin_scale=nonlin_scale, nonlin_std=nonlin_std,
        size_F_small=size_F_small, gamma_apply=gamma_apply, gamma=gamma, bf_apply=bf_apply,
        bf_scale=bf_scale, bf_std=bf_std, bf_size=bf_size, resample_apply=resample_apply,
        spacing=spacing.contiguous(), new_size=new_size, blur_mult=blur_mult,
        noise_apply=noise_apply, noise_std=noise_std,
    )


# ---------------------------------------------------------------------------
# Reference-style nested dict <-> flat override conversion
# ---------------------------------------------------------------------------

def overrides_from_genparams(genparams: dict) -> dict[str, Any]:
    """Convert a reference-style nested genparams dict to flat overrides.

    Accepts the structure :func:`genparams_to_dict` returns (and the
    reference's ``sample``): ``seed_intensities``, ``deform_params`` (with
    ``affine``/``non_rigid``/``flip``), ``gamma_params``, ``bf_params``,
    ``resample_params``, ``noise_params``. ``None`` values are dropped.
    """
    ov: dict[str, Any] = {}
    if not genparams:
        return ov

    def put(name, value):
        if value is not None:
            ov[name] = value

    si = genparams.get("seed_intensities") or {}
    put("mus", si.get("mus"))
    put("sigmas", si.get("sigmas"))

    dp = genparams.get("deform_params") or {}
    if dp:
        affine = dp.get("affine") or {}
        put("rotations", affine.get("rotations"))
        put("shears", affine.get("shears"))
        put("scalings", affine.get("scalings"))
        nr = dp.get("non_rigid") or {}
        put("nonlin_scale", nr.get("nonlin_scale"))
        put("nonlin_std", nr.get("nonlin_std"))
        put("size_F_small", nr.get("size_F_small"))
        put("flip", dp.get("flip"))
        if "deform_apply" in dp:
            put("deform_apply", dp["deform_apply"])

    gp = genparams.get("gamma_params") or {}
    put("gamma", gp.get("gamma"))
    bp = genparams.get("bf_params") or {}
    put("bf_scale", bp.get("bf_scale"))
    put("bf_std", bp.get("bf_std"))
    put("bf_size", bp.get("bf_size"))
    rp = genparams.get("resample_params") or {}
    put("spacing", rp.get("spacing"))
    put("blur_mult", rp.get("blur_mult"))
    np_ = genparams.get("noise_params") or {}
    put("noise_std", np_.get("noise_std"))
    return ov


def genparams_to_dict(p: GenParams, i: int = 0) -> dict:
    """Sample ``i`` of ``p`` as the reference-style nested dict (host values)."""

    def h(x):
        return x[i].detach().cpu().numpy()

    return {
        "seed_intensities": {"mus": h(p.mus), "sigmas": h(p.sigmas)},
        "deform_params": {
            "deform_apply": bool(h(p.deform_apply)),
            "flip": bool(h(p.flip)),
            "affine": {
                "rotations": h(p.rotations),
                "shears": h(p.shears),
                "scalings": h(p.scalings),
            },
            "non_rigid": {
                "nonlin_scale": float(h(p.nonlin_scale)),
                "nonlin_std": float(h(p.nonlin_std)),
                "size_F_small": h(p.size_F_small).tolist(),
            },
        },
        "gamma_params": {"gamma": float(h(p.gamma)) if h(p.gamma_apply) else None},
        "bf_params": (
            {
                "bf_scale": float(h(p.bf_scale)),
                "bf_std": float(h(p.bf_std)),
                "bf_size": h(p.bf_size).tolist(),
            }
            if h(p.bf_apply)
            else {"bf_scale": None, "bf_std": None, "bf_size": None}
        ),
        "resample_params": {
            "spacing": h(p.spacing).tolist() if h(p.resample_apply) else None,
            "blur_mult": float(h(p.blur_mult)),
        },
        "noise_params": {"noise_std": float(h(p.noise_std)) if h(p.noise_apply) else None},
    }
