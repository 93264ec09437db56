"""Carry the JAX package's sampled state and weights into the port.

The generator has no weights; its state is the per-sample ``GenParams`` and
the four standard-normal voxel fields. Given them as numpy arrays (for
example ``{f.name: np.asarray(getattr(p, f.name))}`` of a JAX ``GenParams``,
and the JAX-drawn fields), these build the port's tensors, so that both
packages compute the same volume. The trainer's UNet has weights: a flax
parameter tree becomes the port's ``state_dict``. Numpy in, torch out; no
JAX import.
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


def unet_state_from_flax(params) -> dict[str, torch.Tensor]:
    """A flax ``UNet3D`` parameter tree (numpy leaves, with or without the
    outer ``"params"`` key) -> the ``state_dict`` of the port's ``UNet3D``.

    Flax names its modules ``ConvBlock_i`` (each ``Conv_0``,
    ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1``), ``ConvTranspose_j`` and
    ``Conv_0`` (the head); the port's are ``blocks.i``, ``ups.j`` and
    ``head``, in the same order. A conv kernel (kd, kh, kw, I, O) becomes
    (O, I, kd, kh, kw). Flax's ``ConvTranspose`` (``transpose_kernel=False``)
    correlates its stride-dilated input with the kernel as it is, where
    ``conv_transpose3d`` scatters with it: the kernel is flipped in each
    spatial axis as well, (kd, kh, kw, I, O) -> (I, O, kd, kh, kw).
    """
    tree = params.get("params", params)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32, order="C"))

    def conv(p):
        return t(np.transpose(np.asarray(p["kernel"]), (4, 3, 0, 1, 2))), t(p["bias"])

    state = {}
    for name, sub in tree.items():
        kind, _, idx = name.rpartition("_")
        if kind == "ConvBlock":
            for j in range(2):
                state[f"blocks.{idx}.convs.{j}.weight"], state[f"blocks.{idx}.convs.{j}.bias"] = conv(
                    sub[f"Conv_{j}"])
                state[f"blocks.{idx}.norms.{j}.weight"] = t(sub[f"GroupNorm_{j}"]["scale"])
                state[f"blocks.{idx}.norms.{j}.bias"] = t(sub[f"GroupNorm_{j}"]["bias"])
        elif kind == "ConvTranspose":
            k = np.asarray(sub["kernel"])[::-1, ::-1, ::-1]
            state[f"ups.{idx}.weight"] = t(np.transpose(k, (3, 4, 0, 1, 2)))
            state[f"ups.{idx}.bias"] = t(sub["bias"])
        elif name == "Conv_0":
            state["head.weight"], state["head.bias"] = conv(sub)
        else:
            raise KeyError(f"unet_state_from_flax: unknown module {name!r}")
    return state
