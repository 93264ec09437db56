"""Carry the JAX package's sampled state into the port.

The generator has no weights; its state is the per-sample ``GenParams`` and
the four standard-normal voxel fields. Given them as numpy arrays (for
example ``{f.name: np.asarray(getattr(p, f.name))}`` of a JAX ``GenParams``,
and the JAX-drawn fields), these build the port's tensors, so that both
packages compute the same volume. Numpy in, torch out; no JAX import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .generator.params import GenParams, field_dtype, sample_ndim
from .generator.pipeline import Fields


def params_from_numpy(d: dict) -> GenParams:
    """``{field_name: array}`` -> ``GenParams``. Arrays holding one sample
    (e.g. ``mus`` of shape (nlabels,)) gain a batch dim of 1; batched arrays
    (leading B) are taken as they are."""
    out = {}
    for f in dataclasses.fields(GenParams):
        a = np.asarray(d[f.name])
        if a.ndim == sample_ndim(f.name):
            a = a[None]
        out[f.name] = torch.as_tensor(a.copy()).to(field_dtype(f.name))
    return GenParams(**out)


def fields_from_numpy(intensity, nonlin, bias, noise) -> Fields:
    """Four voxel fields (numpy) -> ``Fields``. One sample's fields (3-D, and
    (3, d, h, w) for ``nonlin``) gain a batch dim of 1; batched ones are
    taken as they are."""

    def t(a, ndim):
        a = np.asarray(a, np.float32)
        if a.ndim == ndim:
            a = a[None]
        return torch.as_tensor(a.copy())

    return Fields(
        intensity=t(intensity, 3), nonlin=t(nonlin, 4), bias=t(bias, 3), noise=t(noise, 3)
    )
