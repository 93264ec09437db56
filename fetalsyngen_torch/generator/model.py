"""Public generator API (port of ``fetalsyngen_tpu.generator.model``).

``FetalSynthGen`` mirrors the reference orchestrator
(``fetalsyngen/generator/model.py:27-276``): the same constructor, driven by
the same Hydra YAML schema, the same ``generate``/``augment``/``sample``
methods and the same nested genparams dicts for replay. The component
classes (``ImageFromSeeds``, ``SpatialDeformation``, ``RandResample``,
``RandBiasField``, ``RandNoise``, ``RandGamma``) keep the reference's
constructor signatures and carry configuration: the voxel math is
:func:`fetalsyngen_torch.generator.pipeline.synth_core`, one sample (B=1) per
call, on the generator's device.

The four SR artifacts (``blur_cortex``, ``struct_noise``,
``simulate_motion``, ``boundaries``) run after the generator's stages, in
that order, as the JAX package's ``_apply_artifacts`` runs them
(``generator/model.py:271-295``), on the generator's device.

Randomness: a numpy ``default_rng(seed)`` draws one integer per sample. That
integer seeds the sample's ``torch.Generator`` (parameters, then voxel
fields) and the seed-selection rng, and is written into the genparams as
``"seed"``: passing the dict back replays the sample. Each artifact gets a
seed derived from it and the artifact's tag (301-304, JAX's ``fold_in``
tags), which seeds both its numpy rng and its device draws. A ``"key"``
entry, as in the JAX package's genparams, is ignored: the port cannot
reproduce threefry streams. Every parameter such a dict holds, its
``selected_seeds`` and its artifacts' metadata still pin the port's sample.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from ..io import nifti
from .artifacts.draws import derive_seed
from .config import (
    BiasFieldCfg,
    DeformCfg,
    GammaCfg,
    GeneratorCfg,
    IntensityCfg,
    NoiseCfg,
    ResampleCfg,
)
from .params import genparams_to_dict, overrides_from_genparams, sample_params
from .pipeline import (
    STAGES_ALL,
    STAGES_AUGMENT,
    STAGES_GENERATE,
    draw_fields,
    make_generators,
    synth_core,
)

ARTIFACTS = ("blur_cortex", "struct_noise", "simulate_motion", "boundaries")
# each artifact's stream tag (the JAX package's fold_in tags)
ARTIFACT_TAGS = {"blur_cortex": 301, "struct_noise": 302, "simulate_motion": 303, "boundaries": 304}


class _HostSeedCache:
    """Byte-budgeted LRU of decoded host seed volumes.

    The reference re-reads 4 seed NIfTIs from disk per sample
    (``rand_gmm.py:90-97``). Caching the decoded arrays keeps repeated
    samples of the same subject from touching disk. Eviction is by bytes,
    not entry count (one 256^3 int16 volume is ~33 MB).
    """

    def __init__(self, max_bytes: int = 2_000_000_000, loader=None):
        self.max_bytes = int(max_bytes)
        self._loader = loader or (
            lambda p: np.ascontiguousarray(nifti.load_ras(p).data.astype(np.int16))
        )
        self._cache: collections.OrderedDict[str, np.ndarray] = collections.OrderedDict()
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, path: str) -> np.ndarray:
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        arr = self._loader(path)
        self._cache[path] = arr
        self._bytes += arr.nbytes
        while self._bytes > self.max_bytes and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._bytes -= evicted.nbytes
        return arr


_SEED_CACHE = _HostSeedCache()


class ImageFromSeeds:
    """Seed loading + GMM intensity config (reference ``rand_gmm.py:9-99``)."""

    def __init__(
        self,
        min_subclusters: int,
        max_subclusters: int,
        seed_labels: Iterable[int],
        generation_classes: Iterable[int],
        meta_labels: int = 4,
    ):
        self.cfg = IntensityCfg(
            min_subclusters=min_subclusters,
            max_subclusters=max_subclusters,
            seed_labels=tuple(int(x) for x in seed_labels),
            generation_classes=tuple(int(x) for x in generation_classes),
            meta_labels=meta_labels,
        )

    def load_seeds(
        self,
        seeds: dict[int, dict[int, Path]],
        genparams: dict | None = None,
        rng: np.random.Generator | None = None,
    ) -> tuple[np.ndarray, dict]:
        """Select subcluster counts per meta-label and sum the seed volumes.

        Mirrors ``ImageFromSeeds.load_seeds`` (``rand_gmm.py:51-99``): per
        meta-label draw ``n ~ U{min..max}`` among the counts present in the
        seed tree, load ``seeds[n][mlabel]``, orient RAS, and sum.
        """
        genparams = genparams or {}
        rng = rng or np.random.default_rng()
        avail = sorted(seeds.keys())
        opts = [
            n for n in avail
            if self.cfg.min_subclusters <= n <= self.cfg.max_subclusters
        ] or avail
        if "mlabel2subclusters" in genparams:
            m2s = {int(k): int(v) for k, v in genparams["mlabel2subclusters"].items()}
        else:
            m2s = {
                ml: int(rng.choice(opts))
                for ml in range(1, self.cfg.meta_labels + 1)
            }
        total: np.ndarray | None = None
        for ml in range(1, self.cfg.meta_labels + 1):
            vol = _SEED_CACHE.get(str(seeds[m2s[ml]][ml]))
            total = vol.copy() if total is None else total + vol
        return total, {"mlabel2subclusters": m2s}


class SpatialDeformation:
    """Config carrier (reference ``affine_nonrigid.py:12-62``). ``device``
    is accepted for the YAML schema; the generator's own ``device`` places
    the work."""

    def __init__(
        self,
        max_rotation: float,
        max_shear: float,
        max_scaling: float,
        size: Iterable[int],
        prob: float,
        nonlinear_transform: bool,
        nonlin_scale_min: float,
        nonlin_scale_max: float,
        nonlin_std_max: float,
        flip_prb: float,
        device: str | None = None,
    ):
        del device
        self.cfg = DeformCfg(
            max_rotation=max_rotation,
            max_shear=max_shear,
            max_scaling=max_scaling,
            size=tuple(int(s) for s in size),
            prob=prob,
            nonlinear_transform=nonlinear_transform,
            nonlin_scale_min=nonlin_scale_min,
            nonlin_scale_max=nonlin_scale_max,
            nonlin_std_max=nonlin_std_max,
            flip_prb=flip_prb,
        )


class RandResample:
    def __init__(self, prob: float, min_resolution: float, max_resolution: float):
        self.cfg = ResampleCfg(prob=prob, min_resolution=min_resolution, max_resolution=max_resolution)


class RandBiasField:
    def __init__(self, prob: float, scale_min: float, scale_max: float, std_min: float, std_max: float):
        self.cfg = BiasFieldCfg(
            prob=prob, scale_min=scale_min, scale_max=scale_max, std_min=std_min, std_max=std_max
        )


class RandNoise:
    def __init__(self, prob: float, std_min: float, std_max: float):
        self.cfg = NoiseCfg(prob=prob, std_min=std_min, std_max=std_max)


class RandGamma:
    def __init__(self, prob: float, gamma_std: float):
        self.cfg = GammaCfg(prob=prob, gamma_std=gamma_std)


class FetalSynthGen:
    """Reference-parity synthetic generator (``model.py:27-276``).

    ``device``: where the samples are generated; ``None`` means ``"cuda"``.
    Without a CUDA device that raises: set ``device: cpu`` to run the plain
    PyTorch path. The SR artifacts (``blur_cortex``, ``struct_noise``,
    ``simulate_motion``, ``boundaries``; each optional) are applied by
    ``sample`` and ``augment``.
    """

    def __init__(
        self,
        shape: Iterable[int],
        resolution: Iterable[float],
        intensity_generator: ImageFromSeeds,
        spatial_deform: SpatialDeformation,
        resampler: RandResample,
        bias_field: RandBiasField,
        noise: RandNoise,
        gamma: RandGamma,
        device: str | None = None,
        blur_cortex: Any | None = None,
        struct_noise: Any | None = None,
        simulate_motion: Any | None = None,
        boundaries: Any | None = None,
        seed: int | None = None,
    ):
        self.artifacts = dict(zip(ARTIFACTS, (blur_cortex, struct_noise, simulate_motion, boundaries)))
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FetalSynthGen: device {device!r} means CUDA, but torch.cuda.is_available() "
                "is false; set `device: cpu` to generate on the CPU"
            )
        self.intensity_generator = intensity_generator
        self.cfg = GeneratorCfg(
            shape=tuple(int(s) for s in shape),
            resolution=tuple(float(r) for r in resolution),
            intensity=intensity_generator.cfg,
            deform=spatial_deform.cfg,
            resample=resampler.cfg,
            bias_field=bias_field.cfg,
            noise=noise.cfg,
            gamma=gamma.cfg,
        )
        self._rng = np.random.default_rng(seed)

    def _resolve_seed(self, genparams: dict, seed: int | None) -> int:
        if seed is not None:
            return int(seed)
        if "seed" in genparams:
            return int(genparams["seed"])
        return int(self._rng.integers(0, 2**31 - 1))

    def _apply_artifacts(self, out, seg, genparams_artifacts: dict, seed: int):
        """The configured SR artifacts on one (D, H, W) volume, each with its
        own stream (reference ``model.py:210-220``); returns the volume and
        each artifact's metadata."""
        meta = {}
        for name, artifact in self.artifacts.items():
            if artifact is None:
                continue
            aseed = derive_seed(seed, ARTIFACT_TAGS[name])
            out, meta[name] = artifact(
                out, seg, genparams=genparams_artifacts.get(name, {}),
                resolution=self.cfg.resolution, rng=np.random.default_rng(aseed), seed=aseed,
            )
        return out, meta

    def _check_shape(self, segmentation) -> None:
        """Fail fast on a volume/config shape mismatch.

        The reference adapts to the input volume's shape at runtime
        (``deformation/affine_nonrigid.py:105``); the generator works on the
        fixed ``cfg.shape``, so a mismatched volume is a configuration error.
        """
        got = tuple(segmentation.shape)
        want = tuple(self.cfg.shape)
        if got != want:
            raise ValueError(
                f"generator is configured for shape {want} but the input volume is {got}: "
                "set the generator config's `shape` (and `spatial_deform.size`) to the "
                "data's shape, or resample the data (scripts/resample.py)."
            )

    def _upload(self, a, dtype) -> torch.Tensor:
        """A (1, D, H, W) tensor of ``dtype`` on the device from a numpy
        array or a tensor."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=self.device, dtype=dtype)[None]

    def _draw(self, genparams: dict, seed: int):
        """The sample's parameters (genparams pin theirs) and voxel fields."""
        gens = make_generators([seed], self.device)
        p = sample_params(gens, self.cfg, overrides_from_genparams(genparams))
        return p, draw_fields(gens, self.cfg, self.device)

    def prepare(self, image, segmentation, seeds, genparams: dict | None = None,
                seed: int | None = None):
        """Everything :func:`synth_core` needs for one sample, on the device.

        Loads and sums the selected seed volumes (or rescales ``image`` to
        [0, 255] as the intensity prior when ``seeds`` is None, reference
        ``model.py:131-139``) and draws the parameters and fields. Returns
        ``(inputs, seed, selected_seeds)``, ``inputs`` being the keyword
        arguments of ``synth_core`` (without ``cfg`` and ``stages``).
        """
        self._check_shape(segmentation)
        genparams = dict(genparams or {})
        seed = self._resolve_seed(genparams, seed)
        seg = self._upload(segmentation, torch.int32)
        img = self._upload(image, torch.float32) if image is not None else None
        seed_vol, prior, selected = None, None, {}
        if seeds is not None:
            vol, selected = self.intensity_generator.load_seeds(
                seeds, genparams.get("selected_seeds", {}), rng=np.random.default_rng(seed)
            )
            seed_vol = self._upload(vol, torch.int32)
        elif img is None:
            raise ValueError(
                "If no seeds are passed, an image must be loaded to be used as intensity prior!"
            )
        else:
            lo, hi = img.amin(), img.amax()
            prior = (img - lo) / torch.where(hi > lo, hi - lo, 1.0) * 255.0
        p, fields = self._draw(genparams, seed)
        inputs = dict(p=p, fields=fields, seeds=seed_vol, seg=seg, image=img, intensity_prior=prior)
        return inputs, seed, selected

    def generate(self, image, segmentation, seeds, genparams: dict | None = None,
                 seed: int | None = None):
        """Intensity synthesis + spatial deformation only (reference
        ``model.py:94-159``). Returns (output, segmentation, image or None,
        params) with (D, H, W) tensors on the device."""
        inputs, seed, selected = self.prepare(image, segmentation, seeds, genparams, seed)
        out, seg, img = synth_core(**inputs, cfg=self.cfg, stages=STAGES_GENERATE)
        full = genparams_to_dict(inputs["p"])
        params_out = {
            "seed": seed,
            "selected_seeds": selected,
            "seed_intensities": full["seed_intensities"],
            "deform_params": full["deform_params"],
        }
        return out[0], seg[0], (img[0] if img is not None else None), params_out

    def augment(self, image, segmentation, genparams: dict | None = None, seed: int | None = None):
        """Intensity augmentations and the SR artifacts on a given image
        (reference ``model.py:161-229``). Artifact pins are read from
        ``genparams["artifacts"]``, or from ``"artifact_params"`` as the JAX
        package also accepts. Returns (output, params) with a (D, H, W)
        tensor on the device."""
        self._check_shape(segmentation)
        genparams = dict(genparams or {})
        seed = self._resolve_seed(genparams, seed)
        p, fields = self._draw(genparams, seed)
        seg = self._upload(segmentation, torch.int32)
        out, _, _ = synth_core(
            p, fields, None, seg, self.cfg,
            intensity_prior=self._upload(image, torch.float32), stages=STAGES_AUGMENT,
        )
        out, artifact_meta = self._apply_artifacts(
            out[0], seg[0], genparams.get("artifacts", genparams.get("artifact_params", {})), seed
        )
        full = genparams_to_dict(p)
        params_out = {
            "seed": seed,
            "gamma_params": full["gamma_params"],
            "bf_params": full["bf_params"],
            "resample_params": full["resample_params"],
            "noise_params": full["noise_params"],
            "artifacts": artifact_meta,
        }
        return out, params_out

    def sample(self, image, segmentation, seeds, genparams: dict | None = None,
               seed: int | None = None):
        """Generate one synthetic sample (reference ``model.py:231-276``).

        Args:
            image: optional (D, H, W) intensity prior / co-deformed volume
                (numpy or tensor).
            segmentation: (D, H, W) int label volume (RAS).
            seeds: ``{n_subclusters: {meta_label: path}}`` dict, or None to
                use ``image`` as the intensity prior.
            genparams: reference-style nested genparams dict for replay; its
                ``"seed"`` replays the voxel noise too.
            seed: explicit per-sample seed (overrides the internal stream
                and ``genparams["seed"]``).

        Returns:
            (output, segmentation, image or None, genparams_out): (D, H, W)
            tensors on the device, and a host dict that replays this sample
            when passed back.
        """
        inputs, seed, selected = self.prepare(image, segmentation, seeds, genparams, seed)
        out, seg, img = synth_core(**inputs, cfg=self.cfg, stages=STAGES_ALL)
        out, artifact_meta = self._apply_artifacts(
            out[0], seg[0], (genparams or {}).get("artifacts", {}), seed
        )
        params_out = {
            "seed": seed,
            "selected_seeds": selected,
            **genparams_to_dict(inputs["p"]),
            "artifacts": artifact_meta,
        }
        return out, seg[0], (img[0] if img is not None else None), params_out
