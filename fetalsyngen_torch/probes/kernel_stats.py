"""Probe: registers, spill stores and SASS instructions of the port's kernels.

    python -m fetalsyngen_torch.probes.kernel_stats [CSRC_DIR ...]

Compiles each ``*.cu`` of each ``CSRC_DIR`` (default: this package's
``csrc/``) for sm_90a as :mod:`fetalsyngen_torch.kernels.build` does, but to
a cubin with ``-Xptxas -v`` (under ``build/kernel_stats/``), lists it with
``cuobjdump -sass`` and prints a line per kernel: source, registers, spill
store bytes, SASS instructions and the mangled name. Given the ``csrc`` of
two checkouts, it compares their code. Needs ``nvcc`` and ``cuobjdump``; no
card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
from pathlib import Path

from fetalsyngen_torch.kernels import build

_LIBRARY_ONLY = ("-shared", "-Xcompiler", "-fPIC")  # build's flags that make a shared library


def parse_ptxas(text: str) -> dict[str, tuple[int, int]]:
    """{kernel: (registers, spill store bytes)} from ``-Xptxas -v`` output."""
    out, fn, spill = {}, None, 0
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            fn, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out[fn] = (int(m.group(1)), spill)
    return out


def count_sass(text: str) -> dict[str, int]:
    """{kernel: instructions} from a ``cuobjdump -sass`` listing."""
    out, fn = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            out[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[fn] += 1
    return out


def stats(src: Path, work: Path) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, SASS instructions) of each
    kernel of ``src``, compiled into ``work``."""
    nvcc = build._nvcc()
    cubin = work / f"{src.stem}.cubin"
    flags = [f for f in build.NVCC_FLAGS if f not in _LIBRARY_ONLY]
    r = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    regs = parse_ptxas(r.stdout + r.stderr)
    listing = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                             capture_output=True, text=True, check=True).stdout
    return [(fn, *regs[fn], n) for fn, n in count_sass(listing).items()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="*", type=Path, default=[build.CSRC], help="directories of .cu sources")
    args = ap.parse_args(argv)
    work = build.BUILD_DIR.parent / "kernel_stats"
    work.mkdir(parents=True, exist_ok=True)
    for d in args.csrc:
        for src in sorted(d.glob("*.cu")):
            for fn, regs, spill, n in stats(src, work):
                print(f"{d}/{src.name}: registers {regs}, spill stores {spill} B, sass {n}: {fn}", flush=True)


if __name__ == "__main__":
    main()
