"""Host-side dict transforms: the MONAI subset the reference's configs use
(copy of ``fetalsyngen_tpu.data.transforms``).

``configs/dataset/transforms/inference.yaml`` composes Orientationd,
SignalFillEmptyd, CropForegroundd, Spacingd, SpatialPadd, CenterSpatialCropd
and ScaleIntensityd over ``{"image", "label"}`` dicts. MONAI is not a
dependency here; these NumPy implementations cover exactly that subset,
including ``Compose.inverse`` for ``FetalTestDataset.reverse_transform``
(reference ``datasets.py:173-186``).

Data layout: ``image``/``label`` are (C, D, H, W) numpy arrays plus an
``affine`` entry per key (RAS voxel->world 4x4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..io.nifti import to_ras


class Transform:
    keys: Sequence[str] = ("image", "label")

    def __call__(self, data: dict) -> dict:
        raise NotImplementedError

    def inverse(self, data: dict) -> dict:
        return data

    def _present(self, data):
        return [k for k in self.keys if k in data]


@dataclass
class Orientationd(Transform):
    keys: Sequence[str] = ("image", "label")
    axcodes: str = "RAS"
    allow_missing_keys: bool = True

    def __call__(self, data):
        if self.axcodes != "RAS":
            raise NotImplementedError("only RAS supported")
        data = dict(data)
        for k in self._present(data):
            arr = data[k]
            aff = data.get(f"{k}_affine", np.eye(4))
            chans = [to_ras(arr[c], aff)[0] for c in range(arr.shape[0])]
            _, new_aff = to_ras(arr[0], aff)
            data[k] = np.stack(chans)
            data[f"{k}_affine"] = new_aff
        return data


@dataclass
class SignalFillEmptyd(Transform):
    keys: Sequence[str] = ("image", "label")
    replacement: float = 0.0
    allow_missing_keys: bool = True

    def __call__(self, data):
        data = dict(data)
        for k in self._present(data):
            arr = np.asarray(data[k], dtype=np.float32)
            data[k] = np.nan_to_num(
                arr, nan=self.replacement, posinf=self.replacement, neginf=self.replacement
            )
        return data


@dataclass
class CropForegroundd(Transform):
    keys: Sequence[str] = ("image", "label")
    source_key: str = "image"
    margin: int = 0
    allow_smaller: bool = True
    allow_missing_keys: bool = True

    def __call__(self, data):
        data = dict(data)
        src = np.asarray(data[self.source_key])
        fg = src[0] > 0
        if not fg.any():
            data["_crop_fg"] = None
            return data
        bounds = []
        for ax in range(3):
            proj = fg.any(axis=tuple(a for a in range(3) if a != ax))
            idx = np.where(proj)[0]
            lo = max(int(idx[0]) - self.margin, 0)
            hi = min(int(idx[-1]) + 1 + self.margin, fg.shape[ax])
            bounds.append((lo, hi))
        data["_crop_fg"] = (bounds, fg.shape)
        sl = (slice(None),) + tuple(slice(lo, hi) for lo, hi in bounds)
        for k in self._present(data):
            data[k] = np.ascontiguousarray(np.asarray(data[k])[sl])
        return data

    def inverse(self, data):
        info = data.get("_crop_fg")
        if not info:
            return data
        bounds, orig_shape = info
        data = dict(data)
        for k in self._present(data):
            arr = np.asarray(data[k])
            out = np.zeros((arr.shape[0], *orig_shape), dtype=arr.dtype)
            sl = (slice(None),) + tuple(slice(lo, hi) for lo, hi in bounds)
            out[sl] = arr
            data[k] = out
        return data


@dataclass
class Spacingd(Transform):
    """Resample to a target voxel spacing (bilinear image / nearest label)."""

    keys: Sequence[str] = ("image", "label")
    pixdim: Sequence[float] = (0.5, 0.5, 0.5)
    mode: Sequence[str] = ("bilinear", "nearest")
    allow_missing_keys: bool = True

    def _resample(self, arr, zoomf, order):
        from scipy.ndimage import zoom as nd_zoom

        out = [
            nd_zoom(arr[c], zoomf, order=order, mode="nearest", grid_mode=False)
            for c in range(arr.shape[0])
        ]
        return np.stack(out)

    def __call__(self, data):
        data = dict(data)
        for k, m in zip(self.keys, self.mode):
            if k not in data:
                continue
            aff = data.get(f"{k}_affine", np.eye(4))
            zooms = np.sqrt((aff[:3, :3] ** 2).sum(axis=0))
            factor = zooms / np.asarray(self.pixdim, dtype=float)
            if np.allclose(factor, 1.0):
                continue
            order = 1 if m == "bilinear" else 0
            data[f"_spacing_{k}"] = (np.asarray(data[k]).shape[1:], zooms.copy())
            data[k] = self._resample(np.asarray(data[k], np.float32), factor, order)
            new_aff = aff.copy()
            new_aff[:3, :3] = aff[:3, :3] / factor[None, :]
            data[f"{k}_affine"] = new_aff
        return data

    def inverse(self, data):
        data = dict(data)
        for k, m in zip(self.keys, self.mode):
            info = data.get(f"_spacing_{k}")
            if info is None or k not in data:
                continue
            orig_shape, _ = info
            arr = np.asarray(data[k], np.float32)
            factor = np.asarray(orig_shape) / np.asarray(arr.shape[1:])
            order = 1 if m == "bilinear" else 0
            out = self._resample(arr, factor, order)
            # guard rounding mismatch
            out = out[:, : orig_shape[0], : orig_shape[1], : orig_shape[2]]
            data[k] = out
        return data


@dataclass
class SpatialPadd(Transform):
    keys: Sequence[str] = ("image", "label")
    spatial_size: Sequence[int] = (256, 256, 256)
    mode: str = "constant"
    allow_missing_keys: bool = True

    def __call__(self, data):
        data = dict(data)
        for k in self._present(data):
            arr = np.asarray(data[k])
            pads = [(0, 0)]
            orig = arr.shape[1:]
            for ax in range(3):
                extra = max(self.spatial_size[ax] - arr.shape[1 + ax], 0)
                pads.append((extra // 2, extra - extra // 2))
            data[f"_pad_{k}"] = (pads, orig)
            data[k] = np.pad(arr, pads, mode="constant")
        return data

    def inverse(self, data):
        data = dict(data)
        for k in self._present(data):
            info = data.get(f"_pad_{k}")
            if info is None:
                continue
            pads, orig = info
            arr = np.asarray(data[k])
            sl = (slice(None),) + tuple(
                slice(p[0], p[0] + s) for p, s in zip(pads[1:], orig)
            )
            data[k] = arr[sl]
        return data


@dataclass
class CenterSpatialCropd(Transform):
    keys: Sequence[str] = ("image", "label")
    roi_size: Sequence[int] = (256, 256, 256)
    allow_missing_keys: bool = True

    def __call__(self, data):
        data = dict(data)
        for k in self._present(data):
            arr = np.asarray(data[k])
            orig = arr.shape[1:]
            sls = [slice(None)]
            starts = []
            for ax in range(3):
                size = min(self.roi_size[ax], arr.shape[1 + ax])
                start = (arr.shape[1 + ax] - size) // 2
                starts.append(start)
                sls.append(slice(start, start + size))
            data[f"_ccrop_{k}"] = (starts, orig)
            data[k] = np.ascontiguousarray(arr[tuple(sls)])
        return data

    def inverse(self, data):
        data = dict(data)
        for k in self._present(data):
            info = data.get(f"_ccrop_{k}")
            if info is None:
                continue
            starts, orig = info
            arr = np.asarray(data[k])
            out = np.zeros((arr.shape[0], *orig), dtype=arr.dtype)
            sl = (slice(None),) + tuple(
                slice(st, st + s) for st, s in zip(starts, arr.shape[1:])
            )
            out[sl] = arr
            data[k] = out
        return data


@dataclass
class ScaleIntensityd(Transform):
    keys: Sequence[str] = ("image",)
    minv: float = 0.0
    maxv: float = 1.0
    allow_missing_keys: bool = True

    def __call__(self, data):
        data = dict(data)
        for k in self._present(data):
            arr = np.asarray(data[k], np.float32)
            lo, hi = arr.min(), arr.max()
            scale = (self.maxv - self.minv) / (hi - lo) if hi > lo else 1.0
            data[k] = (arr - lo) * scale + self.minv
        return data


def scale_intensity(arr, minv=0.0, maxv=1.0):
    """Array-level ScaleIntensity (reference ``datasets.py:40,311``)."""
    lo, hi = arr.min(), arr.max()
    scale = (maxv - minv) / (hi - lo) if hi > lo else 1.0
    return (arr - lo) * scale + minv


@dataclass
class Compose(Transform):
    transforms: list = field(default_factory=list)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def inverse(self, data):
        for t in reversed(self.transforms):
            data = t.inverse(data)
        return data
