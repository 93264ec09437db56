"""Minimal pure-numpy NIfTI-1 reader/writer (copy of ``fetalsyngen_tpu.io.nifti``).

The reference loads NIfTI volumes through SimpleITK + MONAI
(``fetalsyngen/utils/image_reading.py:8-55``) and re-orients them to RAS with
``monai.transforms.Orientation``.  Neither library is a dependency here: this
module implements the NIfTI-1 on-disk format directly (348-byte header, optional
gzip container) and an nibabel-compatible RAS reorientation, so the framework is
fully standalone.

Data is returned in (i, j, k) index order with ``arr[i, j, k]`` where ``i`` is
the fastest-varying on-disk axis, matching nibabel's ``get_fdata()`` layout and
the reference reader's ``permute(2, 1, 0)`` of the SimpleITK (z, y, x) array.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes.
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume: raw array + 4x4 voxel->world (RAS) affine."""

    data: np.ndarray
    affine: np.ndarray  # (4, 4) float64, RAS+ convention (like nibabel)

    @property
    def shape(self):
        return self.data.shape

    @property
    def zooms(self) -> np.ndarray:
        """Voxel sizes (mm) along each of the 3 spatial axes."""
        return np.sqrt((self.affine[:3, :3] ** 2).sum(axis=0))


def _read_bytes(path: str | Path) -> bytes:
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] == -1 else 1.0
    zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * zooms
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    if sizeof_hdr != 348:
        raise ValueError(f"Not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", raw, 40)
    datatype, bitpix = struct.unpack_from("<2h", raw, 70)
    pixdim = struct.unpack_from("<8f", raw, 76)
    (vox_offset,) = struct.unpack_from("<f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    qform_code, sform_code = struct.unpack_from("<2h", raw, 252)
    quatern = struct.unpack_from("<6f", raw, 256)
    srow = np.array(struct.unpack_from("<12f", raw, 280)).reshape(3, 4)
    magic = raw[344:348]
    if not (magic.startswith(b"n+1") or magic.startswith(b"ni1")):
        raise ValueError(f"Bad NIfTI magic: {magic!r}")
    return {
        "dim": dim,
        "datatype": datatype,
        "bitpix": bitpix,
        "pixdim": pixdim,
        "vox_offset": int(vox_offset),
        "scl_slope": scl_slope,
        "scl_inter": scl_inter,
        "qform_code": qform_code,
        "sform_code": sform_code,
        "quatern_b": quatern[0],
        "quatern_c": quatern[1],
        "quatern_d": quatern[2],
        "qoffset_x": quatern[3],
        "qoffset_y": quatern[4],
        "qoffset_z": quatern[5],
        "srow": srow,
    }


def _shape(hdr: dict) -> tuple[int, ...]:
    ndim = hdr["dim"][0]
    shape = tuple(int(s) for s in hdr["dim"][1 : 1 + ndim])
    # Drop trailing singleton dims (common for 3D volumes stored as 4D).
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    return shape


def _affine(hdr: dict) -> np.ndarray:
    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[:3, :] = hdr["srow"]
    elif hdr["qform_code"] > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3], 1.0])
    return affine.astype(np.float64)


def load_header(path: str | Path) -> tuple[tuple[int, ...], np.ndarray]:
    """A volume's shape and affine, as :func:`load` gives them, from its
    header alone (a ``.nii.gz`` is decompressed no further than the header)."""
    path = str(path)
    with (gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")) as f:
        hdr = _parse_header(f.read(348))
    return _shape(hdr), _affine(hdr)


def load(path: str | Path) -> NiftiImage:
    """Load a ``.nii`` / ``.nii.gz`` volume.

    Applies ``scl_slope``/``scl_inter`` rescaling when present (non-identity),
    mirroring nibabel's ``get_fdata`` semantics.
    """
    raw = _read_bytes(path)
    hdr = _parse_header(raw)

    shape = _shape(hdr)
    dtype = _DTYPES.get(hdr["datatype"])
    if dtype is None:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr['datatype']}")

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np.dtype(dtype).newbyteorder("<"), count=count, offset=hdr["vox_offset"]
    )
    # NIfTI stores the first dim fastest -> Fortran order.
    data = data.reshape(shape, order="F")

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter not in (0.0,):
        if slope == 0.0:
            slope = 1.0
        data = data.astype(np.float32) * slope + inter

    return NiftiImage(data=np.asarray(data), affine=_affine(hdr))


def _prep_save(data: np.ndarray, affine: np.ndarray | None):
    """(normalized data, 352-byte NIfTI-1 header) for :func:`save`."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)  # 348-byte header + 4 pad bytes (extensions flag = 0)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<2h", hdr, 70, code, data.dtype.itemsize * 8)
    zooms = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    pixdim = [1.0] + list(zooms) + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform=0, sform=1
    srow = np.asarray(affine, dtype=np.float32)[:3, :].reshape(-1)
    struct.pack_into("<12f", hdr, 280, *srow)
    hdr[344:348] = b"n+1\x00"
    return data, bytes(hdr)


def save(path: str | Path, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    """Write a ``.nii`` / ``.nii.gz`` volume with an sform affine."""
    data, hdr = _prep_save(data, affine)
    payload = hdr + np.asarray(data, order="F").tobytes(order="F")
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def save_batch(
    paths: list, datas: list, affines: list | None = None, level: int = 1
) -> None:
    """Write many ``.nii.gz`` volumes concurrently via the native
    zlib/pthreads writer (``io/native``); falls back to sequential
    :func:`save` when the native library is unavailable (``native.build_error()``
    says why) or any path is a plain ``.nii``. The batch-export counterpart of
    the batch loader: ``scripts/resample.py``, ``resize_seeds.py`` and
    ``generate_seeds.py`` write whole cohorts."""
    from . import native

    affines = affines if affines is not None else [None] * len(paths)
    spaths = [str(p) for p in paths]
    if all(p.endswith(".gz") for p in spaths) and native.available():
        prepped = [_prep_save(d, a) for d, a in zip(datas, affines)]
        CH = 16  # thread per file, chunked
        ok = True
        for i in range(0, len(spaths), CH):
            ok = ok and native.save_gz_batch(
                spaths[i : i + CH],
                [h for _, h in prepped[i : i + CH]],
                [d for d, _ in prepped[i : i + CH]],
                level=level,
            )
        if ok:
            return
    for p, d, a in zip(spaths, datas, affines):
        save(p, d, a)


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """nibabel-compatible orientation of an affine.

    Returns an (3, 2) array: row n gives (output axis index, flip) for input
    axis n, where flip is +1/-1.
    """
    R = np.asarray(affine)[:3, :3].astype(float)
    # Normalize columns to unit length (zero columns stay zero).
    lengths = np.sqrt((R**2).sum(axis=0))
    lengths[lengths == 0] = 1.0
    Rn = R / lengths
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(-np.abs(Rn.T))  # input axis -> world axis
    ornt = np.zeros((3, 2))
    for inp, world in zip(rows, cols):
        ornt[inp, 0] = world
        ornt[inp, 1] = 1.0 if Rn[world, inp] >= 0 else -1.0
    return ornt


def to_ras(data: np.ndarray, affine: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reorient a volume so voxel axes align with RAS+ world axes.

    Equivalent to ``monai.transforms.Orientation(axcodes="RAS")`` /
    ``nib.as_closest_canonical`` (reference: ``datasets.py:283-284``,
    ``rand_gmm.py:91-96``).
    """
    ornt = io_orientation(affine)
    perm = np.argsort(ornt[:, 0])  # output axis order
    flips = ornt[perm.astype(int), 1]

    out = np.transpose(data, perm)
    slicers = tuple(slice(None, None, -1) if f < 0 else slice(None) for f in flips)
    out = out[slicers]

    # Update affine: new_affine = affine @ inv(transform applied to indices)
    shape = np.array(data.shape[:3])[perm.astype(int)]
    T = np.zeros((4, 4))
    T[3, 3] = 1.0
    for new_ax in range(3):
        old_ax = int(perm[new_ax])
        f = flips[new_ax]
        T[old_ax, new_ax] = f
        if f < 0:
            T[old_ax, 3] = shape[new_ax] - 1
    new_affine = np.asarray(affine) @ T
    return np.ascontiguousarray(out), new_affine


def load_ras(path: str | Path) -> NiftiImage:
    """Load a volume and reorient it to RAS."""
    img = load(path)
    data, affine = to_ras(img.data, img.affine)
    return NiftiImage(data=data, affine=affine)
