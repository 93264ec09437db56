"""Probe: registers, spill stores and SASS instructions of the port's kernels.

    python -m fetalsyngen_torch.probes.kernel_stats [CSRC_DIR ...]

Compiles each ``*.cu`` of each ``CSRC_DIR`` (default: this package's
``csrc/``) for sm_90a as :mod:`fetalsyngen_torch.kernels.build` does, but to
a cubin with ``-Xptxas -v`` (under ``build/kernel_stats/``), lists it with
``cuobjdump -sass`` and prints a line per kernel: source, registers, spill
store bytes, SASS instructions, the instructions per output element of its
innermost loop that stores (:func:`loop_per_element`) and the mangled name.
Given the ``csrc`` of two checkouts, it compares their code. Needs ``nvcc``
and ``cuobjdump``; no card.
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


def parse_sass(text: str) -> dict[str, list[tuple[int, str]]]:
    """{kernel: [(address, instruction)]} from a ``cuobjdump -sass`` listing."""
    out, fn = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            out[fn] = []
        elif fn and (m := re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)):
            out[fn].append((int(m.group(1), 16), m.group(2)))
    return out


def count_sass(text: str) -> dict[str, int]:
    """{kernel: instructions} from a ``cuobjdump -sass`` listing."""
    return {fn: len(ins) for fn, ins in parse_sass(text).items()}


def _store_bits(ins: str) -> int:
    """Bits of a global store (``STG``), 0 for any other instruction."""
    op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
    if not op.startswith("STG"):
        return 0
    for bits in (128, 64):
        if f".{bits}" in op:
            return bits
    return 16 if ".U16" in op or ".S16" in op else 8 if ".U8" in op or ".S8" in op else 32


def _branch(text: str):
    """(target address, unconditional) of a branch (``BRA``), else None."""
    m = re.search(r"\bBRA(?:\.[A-Z]+)*\s+(?:[^,\s]+,\s*)?(0x[0-9a-f]+)", text)
    return None if m is None else (int(m.group(1), 16), not text.startswith("@"))


def loop_per_element(ins: list[tuple[int, str]], esize: int):
    """(instructions, elements) of a kernel's innermost loop that stores to
    global memory: the instructions from a backward branch's target to the
    branch (no EXIT between), with the blocks the loop branches out to past
    its end and back from, and the output elements of ``esize`` bytes its
    widest stores write (the vector path; narrower stores are the fallback
    for unaligned lanes). Rarely taken paths inside the loop count too. None
    without such a loop."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    best = None
    for i, (addr, text) in enumerate(ins):
        br = _branch(text)
        if br is None or br[0] > addr or br[0] not in index:
            continue
        lo = br[0]
        body = set(range(index[lo], i + 1))
        if any(ins[j][1].startswith("EXIT") for j in body):  # a jump back from an out-of-line block
            continue
        for j in sorted(body):  # out-of-line blocks that jump back into the loop
            out = _branch(ins[j][1])
            if out is None or out[0] <= addr or out[0] not in index:
                continue
            for k in range(index[out[0]], len(ins)):
                back = _branch(ins[k][1])
                if ins[k][1].startswith("EXIT") or (back and back[1] and not lo <= back[0] <= addr):
                    break
                if back and back[1]:
                    body.update(range(index[out[0]], k + 1))
                    break
        widths = [b for b in (_store_bits(ins[j][1]) for j in body) if b]
        elements = widths.count(max(widths)) * max(widths) // (8 * esize) if widths else 0
        if elements and (best is None or len(body) < best[0]):
            best = (len(body), elements)
    return best


def stats(src: Path, work: Path) -> list[tuple[str, int, int, int, tuple | None]]:
    """(kernel, registers, spill store bytes, SASS instructions,
    :func:`loop_per_element`) of each kernel of ``src``, compiled into
    ``work``; a kernel on bf16 rows (``__nv_bfloat16`` in its name) stores
    2-byte elements, the others 4."""
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
    return [(fn, *regs[fn], len(ins), loop_per_element(ins, 2 if "__nv_bfloat16" in fn else 4))
            for fn, ins in parse_sass(listing).items()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="*", type=Path, default=[build.CSRC], help="directories of .cu sources")
    args = ap.parse_args(argv)
    work = build.BUILD_DIR.parent / "kernel_stats"
    work.mkdir(parents=True, exist_ok=True)
    for d in args.csrc:
        for src in sorted(d.glob("*.cu")):
            for fn, regs, spill, n, loop in stats(src, work):
                per = "no storing loop" if loop is None else \
                    f"loop {loop[0]} for {loop[1]} elements, {loop[0] / loop[1]:.1f} per element"
                print(f"{d}/{src.name}: registers {regs}, spill stores {spill} B, sass {n}, {per}: {fn}", flush=True)


if __name__ == "__main__":
    main()
