"""Build the package's CUDA sources with ``nvcc`` and load them through ``ctypes``.

The sources under ``fetalsyngen_torch/csrc/`` have a plain C interface (no
PyTorch headers), so one ``nvcc`` call builds them in seconds. The shared
library lands in ``<repo>/build/fetalsyngen_torch_kernels/`` under a name keyed
by a hash of the sources and flags: an edited source rebuilds, an unchanged one
is loaded as it is. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fetalsyngen_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}/bin")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    """Where the build for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfsg_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library, unless already built."""
    out = _library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' shared library (once per process)."""
    return ctypes.CDLL(str(build()))
