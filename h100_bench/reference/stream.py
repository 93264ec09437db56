"""The plain reference of one stream batch, worked out again from the seed.

This file and the frozen package beside it (``fsg``: the port's plain code,
its kernels replaced by their plain versions) import neither the port nor
JAX. From the configuration's JSON and the run's ``--seed`` they rebuild
what ``SyntheticStream`` draws on the host (each batch's sample seeds,
option uniforms, subjects and motion geometry, in the stream's order), read
the seed NIfTIs themselves, and compute any element of any batch on its own
(B=1): the option gather and int32 sum, ``synth_core``'s stages, the
artifact chain, and the division by the sample's peak.

``mode`` selects the arithmetic: None is f32 throughout (the reference).
The controls: ``"fp8"`` stores what the production mode stores in bf16 in
float8 e4m3 instead (``fsg.ops.linops.FP8``), the precision below the
configuration's bf16 storage; ``"tf32"`` runs the card's f32 matmuls in
TF32, the precision below its f32 positions. ``"bf16"`` is the production
mode itself, for diagnosis.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .fsg.generator.artifacts.batched import ChainSpec, Draws, QualityArtifacts, apply_chain, pack_motion
from .fsg.generator.artifacts.draws import derive_seed
from .fsg.generator.artifacts.quality import (
    BlurCortex,
    ReconMergeParams,
    SimulatedBoundaries,
    StructNoise,
    StructNoiseMergeParams,
)
from .fsg.generator.artifacts.scanner import ReconParams, ScannerParams, SimulateMotion, slice_grid
from .fsg.generator.config import (
    BiasFieldCfg,
    DeformCfg,
    GammaCfg,
    GeneratorCfg,
    IntensityCfg,
    NoiseCfg,
    ResampleCfg,
)
from .fsg.generator.pipeline import draw_fields, make_generators, synth_core
from .fsg.generator.params import sample_params
from .fsg.io import nifti
from .fsg.ops.linops import DEFAULT, FP8, precision_scope, storage_scope

_CLASSES = {c.__name__: c for c in (
    BlurCortex, StructNoise, StructNoiseMergeParams, SimulatedBoundaries, SimulateMotion, ScannerParams,
    ReconParams, ReconMergeParams,
)}
_CHAIN_TAG = 77  # the chain's seed: derive_seed(sample seed, 77)


def _build(node):
    """A ``_target_`` tree of the artifacts' classes, by class name."""
    if isinstance(node, dict):
        kw = {k: _build(v) for k, v in node.items() if k != "_target_"}
        if "_target_" in node:
            return _CLASSES[node["_target_"].rsplit(".", 1)[1]](**kw)
        return kw
    if isinstance(node, list):
        return [_build(v) for v in node]
    return node


def _plain(node: dict) -> dict:
    return {k: v for k, v in node.items() if k not in ("_target_", "device")}


def generator_cfg(gen: dict) -> GeneratorCfg:
    """The generator's ``GeneratorCfg`` from its configuration dict."""
    d = _plain(gen["spatial_deform"])
    d["size"] = tuple(d["size"])
    i = _plain(gen["intensity_generator"])
    return GeneratorCfg(
        shape=tuple(int(s) for s in gen["shape"]),
        resolution=tuple(float(r) for r in gen["resolution"]),
        intensity=IntensityCfg(**{**i, "seed_labels": tuple(i["seed_labels"]),
                                  "generation_classes": tuple(i["generation_classes"])}),
        deform=DeformCfg(**d),
        resample=ResampleCfg(**_plain(gen["resampler"])),
        bias_field=BiasFieldCfg(**_plain(gen["bias_field"])),
        noise=NoiseCfg(**_plain(gen["noise"])),
        gamma=GammaCfg(**_plain(gen["gamma"])),
    )


@contextlib.contextmanager
def arithmetic(mode: str | None):
    """The arithmetic of ``mode``: None (f32, TF32 off as the caller set
    it), ``"bf16"`` or ``"fp8"`` storage scopes, or ``"tf32"``: f32 with
    the card's matmuls in TF32."""
    if mode is None:
        yield
        return
    if mode == "tf32":
        m = torch.backends.cuda.matmul
        prev = m.allow_tf32, torch.backends.cudnn.allow_tf32
        m.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            m.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return
    prec, store = {"bf16": (DEFAULT, torch.bfloat16), "fp8": (FP8, FP8)}[mode]
    with precision_scope(prec), storage_scope(store):
        yield


@dataclass
class StreamSpec:
    """What the stream derives from its configuration (``SyntheticStream``'s
    defaults: small tier, dz-split and pooled recon weight on)."""

    cfg: GeneratorCfg
    qa: QualityArtifacts
    sm: SimulateMotion | None
    chain: ChainSpec | None
    cube: int | tuple
    ns_grid: int
    small_cube: int | None
    lo: int


def stream_spec(gen: dict) -> StreamSpec:
    """The stream's derived settings for the generator configuration ``gen``
    with its configured artifacts."""
    cfg = generator_cfg(gen)
    arts = {k: _build(gen[k]) for k in ("blur_cortex", "struct_noise", "simulate_motion", "boundaries")
            if gen.get(k) is not None}
    sm = arts.get("simulate_motion")
    qa = QualityArtifacts(arts.get("blur_cortex"), arts.get("struct_noise"), arts.get("boundaries"))
    shape = tuple(cfg.shape)
    res0 = float(cfg.resolution[0])
    tiers = tuple(sm.tiers) if sm is not None else (384, 512, 640)
    if sm is not None:
        sp = sm.scanner_args
        rs_lo = float(sp.resolution_slice_fac_min)
        rs_hi = min(float(sp.resolution_slice_fac_max), float(sp.resolution_slice_max) / res0)
        t_small = slice_grid(shape, rs_hi, sp.slice_size, tiers)
        t_big = slice_grid(shape, rs_lo, sp.slice_size, tiers)
        cubes = tuple(t for t in sorted(tiers) if t_small <= t <= t_big)
    else:
        cubes = (int(min((c for c in tiers if c >= max(shape)), default=max(tiers))),)
    cube = cubes[0] if len(cubes) == 1 else cubes
    ns_grid = 128
    if sm is not None:
        need = int(max(shape) * res0 / float(sm.scanner_args.gap_min)) + 2
        ns_grid = min(sm.ns_grid, max(64, -(-need // 32) * 32))
    sc = ((max(shape) + 127) // 128) * 128
    small_cube = sc if sc < cubes[0] else None
    has_quality = any(a is not None for a in (qa.blur_cortex, qa.struct_noise, qa.boundaries))
    chain = None
    if has_quality or sm is not None:
        chain = ChainSpec(qa if has_quality else None, sm, shape, cube, ns_grid, small_cube, True, True)
    return StreamSpec(cfg, qa, sm, chain, cube, ns_grid, small_cube, max(cfg.intensity.min_subclusters - 1, 0))


def host_draws(spec: StreamSpec, seed: int, batch_size: int, n_subjects: int = 1, mix_subjects: int = 1):
    """The stream's host draws, batch after batch: (index, meta) with the
    sample seeds, the option uniforms, the residents (indices into the
    sorted subject names), the motion pack and the subjects."""
    rng = np.random.default_rng(seed)
    draws = np.random.default_rng([seed, 1])
    cfg = spec.cfg
    i, want, index = 0, (), 0
    while True:
        if not want or n_subjects > mix_subjects:
            want = tuple((i + j) % n_subjects for j in range(mix_subjects))
            i += 1
        meta = {
            "seeds": draws.integers(0, 2**31 - 1, batch_size),
            "u": draws.random((batch_size, 4), dtype=np.float32),
            "resident": want,
        }
        pack = {}
        if spec.sm is not None:
            pack = pack_motion(rng, batch_size, tuple(cfg.shape), float(cfg.resolution[0]), spec.sm, spec.cube,
                               spec.ns_grid, small_cube=spec.small_cube, with_record=True)
            meta["motion_on"] = pack.pop("_record")["motion_on"]
        meta["pack"] = pack
        meta["subj"] = rng.integers(0, len(want), batch_size)
        yield index, meta
        index += 1


def batch_meta(spec: StreamSpec, seed: int, batch_size: int, index: int, **kw) -> dict:
    """The host draws of batch ``index``."""
    for i, meta in host_draws(spec, seed, batch_size, **kw):
        if i == index:
            return meta
    raise AssertionError("unreachable")


class Seeds:
    """One subject's seed volumes and segmentation, read from its BIDS tree
    (``<bids>/derivatives/seeds/subclasses_<n>/<sub>/anat/*_mlabel_<m>.nii.gz``
    and ``<bids>/<sub>/anat/*_dseg.nii.gz``), each decoded once."""

    def __init__(self, bids_path, seed_path, subject: str):
        bids, seeds = Path(bids_path), Path(seed_path)
        self.options = sorted(int(p.name.removeprefix("subclasses_")) for p in seeds.glob("subclasses_*"))
        self._paths = {
            (n, m): self._one(seeds / f"subclasses_{n}" / subject / "anat", f"*_mlabel_{m}.nii.gz")
            for n in self.options for m in range(1, 5)
        }
        self.seg_path = self._one(bids / subject / "anat", "*_dseg.nii.gz")
        self._vols: dict = {}

    @staticmethod
    def _one(folder: Path, pattern: str) -> Path:
        found = sorted(folder.glob(pattern))
        if len(found) != 1:
            raise FileNotFoundError(f"{folder}/{pattern}: {len(found)} files")
        return found[0]

    def volume(self, option_index: int, mlabel: int) -> np.ndarray:
        """The int8 RAS seed volume of option ``option_index`` (0-based into
        the sorted subcluster counts) and meta-label ``mlabel``."""
        key = (self.options[option_index], mlabel)
        if key not in self._vols:
            self._vols[key] = nifti.load_ras(self._paths[key]).data.astype(np.int8)
        return self._vols[key]

    def segmentation(self) -> np.ndarray:
        if "seg" not in self._vols:
            self._vols["seg"] = nifti.load_ras(self.seg_path).data.astype(np.int16)
        return self._vols["seg"]


def choose_options(u: torch.Tensor, hi: int, lo: int) -> torch.Tensor:
    """(4,) option per meta-label from (4,) f32 uniforms: ``lo + floor(u *
    (hi - lo))`` in f32, clipped to ``[lo, hi - 1]``."""
    ch = torch.floor(u * float(hi - lo)).to(torch.int32) + lo
    return torch.clamp(ch, lo, hi - 1)


def sample(spec: StreamSpec, seeds: Seeds, meta: dict, j: int, device, mode: str | None = None):
    """Element ``j`` of the batch whose host draws are ``meta``: (image
    (D, H, W) f32 in [0, 1], label (D, H, W) int32), computed alone."""
    cfg = spec.cfg
    dev = torch.device(device)
    s = int(meta["seeds"][j])
    hi = min(cfg.intensity.max_subclusters, len(seeds.options))
    ch = choose_options(torch.from_numpy(meta["u"][j]).to(dev), hi, spec.lo).cpu().tolist()
    vol = None
    for m in range(4):
        v = torch.from_numpy(seeds.volume(ch[m], m + 1)).to(dev).to(torch.int32)
        vol = v if vol is None else vol + v
    seg = torch.from_numpy(seeds.segmentation()).to(dev).to(torch.int32)
    gens = make_generators([s], dev)
    p = sample_params(gens, cfg)
    fields = draw_fields(gens, cfg, dev)
    with arithmetic(mode):
        out, seg_o, _ = synth_core(p, fields, vol[None], seg[None], cfg)
        out = out.float()
        if spec.chain is not None:
            pack = {k: v[j:j + 1] for k, v in meta["pack"].items()}
            out = apply_chain(out, seg_o, spec.chain, pack, [Draws(derive_seed(s, _CHAIN_TAG), dev)])
    out = out.float()
    peak = out.amax(dim=(1, 2, 3), keepdim=True)
    return (out / torch.where(peak > 0, peak, 1.0))[0], seg_o[0].to(torch.int32)
