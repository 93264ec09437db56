"""ctypes bindings for the native NIfTI loader (port of ``fetalsyngen_tpu.io.native``).

The host path that feeds the generator decodes seed volumes in C++
(``native/nifti_loader.cpp``, zlib and a thread per volume), bound through
``ctypes``. The library is built from that source with the host compiler
(``$CXX``, else ``g++``) at first use, into
``<repo>/build/fetalsyngen_torch_native/`` under a name keyed by a hash of
the source and the command, so an edited source rebuilds and nothing lands
beside the source. Where the build fails, :func:`get_lib` returns None,
:func:`build_error` holds the compiler's message, and callers decode with
the pure-Python reader of :mod:`fetalsyngen_torch.io.nifti`, saying which
reader they used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "nifti_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fetalsyngen_torch_native"
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIBS = ("-lz", "-lpthread")
_lock = threading.Lock()
_lib = None
_error: str | None = None


def _library_path(cxx: str) -> Path:
    """Where the build of the current source with ``cxx`` lives."""
    h = hashlib.sha256(" ".join((cxx, *_FLAGS, *_LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnifti_loader-{h.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> str | None:
    """Compile the loader into ``out``; returns None, or the failure's message."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *_FLAGS, str(SOURCE), *_LIBS, "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} failed ({r.returncode}):\n{r.stderr}"
    os.replace(tmp, out)
    return None


def get_lib():
    """Load (building if needed) the native library, or None if it cannot be
    built or loaded (:func:`build_error` says why)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        cxx = os.environ.get("CXX", "g++")
        path = _library_path(cxx)
        if not path.exists():
            _error = _build(cxx, path)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _error = f"loading {path}: {e}"
            return None
        lib.nifti_load.restype = ctypes.c_int
        lib.nifti_load.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.nifti_save_batch.restype = ctypes.c_int
        lib.nifti_save_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    """The compiler's (or loader's) message where the library is unavailable,
    else None; builds the library first if no attempt was made yet."""
    get_lib()
    return _error


def load_labels_batch(paths: list[str], shape: tuple[int, int, int], out: np.ndarray | None = None):
    """Concurrently decode a batch of int-label NIfTIs.

    Returns a list of n (D, H, W) int32 arrays (Fortran-ordered views), or
    None if the native path is unavailable or any volume mismatches ``shape``
    (callers fall back to the Python reader). ``out``: an int32 buffer of at
    least n * prod(shape) elements to decode into (a caller that decodes
    many batches reuses one, rather than faulting in a new one each time).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    stride = int(np.prod(shape))
    out = np.empty((n, stride), dtype=np.int32) if out is None else out.reshape(-1)[: n * stride].reshape(n, stride)
    shapes = np.zeros((n, 3), dtype=np.int64)
    affines = np.zeros((n, 12), dtype=np.float32)

    # ctypes releases the GIL during the foreign call, so a thread pool over
    # the single-volume entry point runs the zlib decode concurrently in C.
    def one(i):
        return lib.nifti_load(
            paths[i].encode(),
            None,
            out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            stride,
            shapes[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            affines[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )

    with ThreadPoolExecutor(max_workers=min(n, 8)) as ex:
        rcs = list(ex.map(one, range(n)))
    if any(rcs) or not (shapes == np.asarray(shape)).all():
        return None
    # NIfTI voxels are Fortran-ordered: zero-copy Fortran views per volume
    return [out[i].reshape(shape, order="F") for i in range(n)]


def save_gz_batch(paths: list[str], headers: list[bytes], datas: list[np.ndarray],
                  level: int = 6) -> bool:
    """Concurrently gzip-write a batch of NIfTI files (header bytes +
    Fortran-ordered voxel payload per file). Returns False if the native
    path is unavailable or any write failed (callers fall back to the
    Python writer)."""
    lib = get_lib()
    if lib is None:
        return False
    n = len(paths)
    datas = [np.asfortranarray(d) for d in datas]
    path_arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    hdr_arr = (ctypes.c_char_p * n)(*headers)
    hsz = (ctypes.c_int64 * n)(*[len(h) for h in headers])
    data_ptrs = (ctypes.c_char_p * n)(
        *[ctypes.cast(d.ctypes.data, ctypes.c_char_p) for d in datas]
    )
    dsz = (ctypes.c_int64 * n)(*[d.nbytes for d in datas])
    rc = lib.nifti_save_batch(path_arr, hdr_arr, hsz, data_ptrs, dsz, n, level)
    return rc == 0
