"""Generator configuration (port of ``fetalsyngen_tpu.generator.config``).

Frozen dataclasses with the same fields, defaults and derived sizes as the
JAX package's, so one set of keyword arguments configures both packages.
Everything here is fixed per run (shapes, probabilities, bounds); the
per-sample values live in :mod:`fetalsyngen_torch.generator.params`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class IntensityCfg:
    """``ImageFromSeeds`` (reference ``rand_gmm.py:9-49``)."""

    min_subclusters: int = 1
    max_subclusters: int = 6
    seed_labels: tuple[int, ...] = ()
    generation_classes: tuple[int, ...] = ()
    meta_labels: int = 4

    def __post_init__(self):
        if len(set(self.seed_labels)) != len(self.seed_labels):
            raise ValueError("Parameter seed_labels should have unique values.")
        if len(self.seed_labels) != len(self.generation_classes):
            raise ValueError(
                "Parameters seed_labels and generation_classes should have the same lengths."
            )

    @property
    def nlabels(self) -> int:
        return max(self.seed_labels) + 1


@dataclass(frozen=True)
class DeformCfg:
    """``SpatialDeformation`` (reference ``affine_nonrigid.py:18-62``)."""

    max_rotation: float = 20.0
    max_shear: float = 0.02
    max_scaling: float = 0.1
    size: tuple[int, int, int] = (256, 256, 256)
    prob: float = 0.9
    nonlinear_transform: bool = True
    nonlin_scale_min: float = 0.03
    nonlin_scale_max: float = 0.06
    nonlin_std_max: float = 4.0
    flip_prb: float = 0.5
    # Shift warp coordinates by floor(min(coord)), as the reference does
    # (``affine_nonrigid.py:350-358``).
    margin_shift: bool = True
    # 'separable': affine passes as batched matmuls plus the paired hat
    # kernel for the field passes. 'exact': trilinear/nearest gathers with
    # the reference's ``fast_3D_interp_torch`` semantics.
    warp_impl: str = "separable"

    def small_field_max(self) -> tuple[int, int, int]:
        """Buffer size covering the largest possible low-res field."""
        return tuple(int(round(self.nonlin_scale_max * s)) + 1 for s in self.size)


@dataclass(frozen=True)
class ResampleCfg:
    """``RandResample`` (reference ``synthseg.py:25-48``)."""

    prob: float = 0.9
    min_resolution: float = 0.5
    max_resolution: float = 1.5

    def blur_half_len(self, input_resolution: tuple[float, ...]) -> int:
        """Kernel half-length for the worst-case resample blur std.

        Reference std law: ``(0.85 + 0.3 U) * ln(5)/pi * spacing / in_res``
        (``synthseg.py:78``).
        """
        max_std = 1.15 * math.log(5) / math.pi * self.max_resolution / min(input_resolution)
        return int(math.ceil(3.0 * max_std))


@dataclass(frozen=True)
class BiasFieldCfg:
    """``RandBiasField`` (reference ``synthseg.py:117-142``)."""

    prob: float = 0.9
    scale_min: float = 0.004
    scale_max: float = 0.02
    std_min: float = 0.01
    std_max: float = 0.3

    def small_field_max(self, shape: tuple[int, int, int]) -> tuple[int, int, int]:
        return tuple(max(int(round(self.scale_max * s)) + 1, 1) for s in shape)


@dataclass(frozen=True)
class NoiseCfg:
    """``RandNoise`` (reference ``synthseg.py:191-204``)."""

    prob: float = 0.9
    std_min: float = 5.0
    std_max: float = 15.0


@dataclass(frozen=True)
class GammaCfg:
    """``RandGamma`` (reference ``synthseg.py:238-248``)."""

    prob: float = 0.9
    gamma_std: float = 0.1


@dataclass(frozen=True)
class GeneratorCfg:
    """Top-level generator config (reference ``FetalSynthGen.__init__``)."""

    shape: tuple[int, int, int] = (256, 256, 256)
    resolution: tuple[float, float, float] = (0.5, 0.5, 0.5)
    intensity: IntensityCfg = field(default_factory=IntensityCfg)
    deform: DeformCfg = field(default_factory=DeformCfg)
    resample: ResampleCfg = field(default_factory=ResampleCfg)
    bias_field: BiasFieldCfg = field(default_factory=BiasFieldCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    gamma: GammaCfg = field(default_factory=GammaCfg)
