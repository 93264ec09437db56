"""Build the package's CUDA sources with ``nvcc`` and load them through ``ctypes``.

Each ``fetalsyngen_torch/csrc/*.cu`` has a plain C interface (no PyTorch
headers) and builds into a shared library of its own, all ``nvcc`` calls
started together, so a build takes as long as the slowest source (seconds).
The libraries land in ``<repo>/build/fetalsyngen_torch_kernels/`` under names
keyed by a hash of the source, the shared headers (``*.cuh``) and the flags:
an edited source rebuilds, an unchanged one is loaded as it is. A failed
build raises with nvcc's stderr.
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
    """The kernel sources, one shared library each."""
    return sorted(CSRC.glob("*.cu"))


def _library_path(src: Path) -> Path:
    """Where the build of ``src`` for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> list[Path]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` per source,
    all at once; returns the libraries' paths."""
    outs = [_library_path(src) for src in _sources()]
    todo = [(src, out) for src, out in zip(_sources(), outs) if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        failed = []
        for cmd, tmp, out, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


@functools.cache
def load_library(stem: str) -> ctypes.CDLL:
    """Build if needed and load the library of ``csrc/<stem>.cu`` (once per process)."""
    src = CSRC / f"{stem}.cu"
    if src not in _sources():
        raise ValueError(f"no kernel source {src}")
    build()
    return ctypes.CDLL(str(_library_path(src)))
