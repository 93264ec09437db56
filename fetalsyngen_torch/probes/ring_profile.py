"""Probe: where the launches of K3 and K4 spend their time on the card.

    python -m fetalsyngen_torch.probes.ring_profile

On B=4 256^3 operands, the shapes of ``chip_smoke.py``'s phase 10:

1. Builds ``csrc/probes.cu`` once more with ``-DFSG_RING_PROFILE`` (under
   ``build/ring_profile/``): the kernels as they are, with a record per ring
   block of its start and end on the card's global timer and, for one thread
   of its second warp, the cycles it waited on the ring's barriers and the
   cycles of its walk. For each staged mode it checks that build against the
   plain version, then prints its ms per launch queued back to back
   (:func:`timing.chain_ms`), the blocks' end times from the first block's
   start (percentiles 0/10/50/90/100), their mean busy time and the share of
   the walk spent waiting on the barriers (:func:`block_summary`).
2. For every K3 and K4 mode as built, and for its torch yardstick (``mul``
   for copy, else ``clone``, once per operand), the ms of one call four ways:
   ``one``, as phase 10 times it (an event, the call, an event; median of
   20); ``fenced``, the same behind a wait enqueued first
   (``torch.cuda._sleep``), so the card waits for no host work; ``kernels``,
   the device time of the kernels the fenced call launched (``torch.profiler``);
   ``queued``, back to back. Then the host time of one call with the card
   idle (median of 20). ``one - fenced`` is the time the card waited for the
   host; ``fenced - kernels`` the card's own time around the kernels.

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import time

import numpy as np
import torch

from ..kernels import build, probes
from . import timing

B, S = 4, 256
RECORDS = 65536  # ring blocks the profiling build records (kRecords)
FENCE_CYCLES = 1_000_000  # the enqueued wait, ~0.5 ms at the H100's clocks
RUNS = 20
MODES = [(4, "stage"), (4, "ladder"), (4, "tiles"), (4, "sweep12"), (3, "stage"), (3, "taps")]


def _build() -> ctypes.CDLL:
    """``csrc/probes.cu`` with ``FSG_RING_PROFILE`` defined, loaded."""
    d = build.BUILD_DIR.parent / "ring_profile"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / "libprobes_profile.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DFSG_RING_PROFILE", "-o", str(lib), str(build.CSRC / "probes.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the profiling build:\n{r.stderr}")
    return ctypes.CDLL(str(lib))


def _launcher(lib, kernel, mode, xa, xb, oa, ob):
    """A call of the profiling build's K3 (``kernel`` 3, taps with 8 taps) or
    K4 entry point on the current stream, raising on a launch error."""
    B, D, H, S = xa.shape
    stream = torch.cuda.current_stream(xa.device).cuda_stream
    if kernel == 4:
        fn = lib.fsg_probe_f32
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        args = (xa.data_ptr(), oa.data_ptr(), B, D * H, S, probes.SINGLE_MODES.index(mode), stream)
    else:
        fn = lib.fsg_probe2_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        args = (xa.data_ptr(), xb.data_ptr(), oa.data_ptr(), ob.data_ptr(), B, D * H, H, S,
                probes.PAIR_MODES.index(mode), 8, stream)

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"K{kernel} {mode}: cudaError {rc}")

    return call


def block_summary(rec: np.ndarray) -> dict:
    """The records of one launch, (blocks, 4): start ns, end ns, cycles
    waited on the barriers, cycles of the walk. Returns the blocks' end
    times in us from the first start (percentiles 0/10/50/90/100), their
    mean busy time in us and the share of the walk spent waiting."""
    rec = rec.astype(np.float64)
    t0 = rec[:, 0].min()
    return dict(ends_us=np.percentile((rec[:, 1] - t0) / 1e3, [0, 10, 50, 90, 100]).tolist(),
                busy_us=float(((rec[:, 1] - rec[:, 0]) / 1e3).mean()),
                wait=float(rec[:, 2].sum() / rec[:, 3].sum()))


def _one_ms(call, fence: bool) -> float:
    """Median ms over RUNS of one ``call()`` between two CUDA events, with
    the card idle before it or (``fence``) busy with an enqueued wait."""
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if fence:
            torch.cuda._sleep(FENCE_CYCLES)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_ms(call) -> float:
    """Device ms per call of the kernels ``call()`` launches, each call
    behind an enqueued wait, over RUNS calls (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            torch.cuda._sleep(FENCE_CYCLES)
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "spin" not in e.key]
    total = sum(e.self_device_time_total for e in kernels)
    if not total:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3 / RUNS


def _host_us(call) -> float:
    """Median host microseconds over RUNS of one ``call()`` started with the
    card idle."""
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _queued_ms(call, dev) -> float:
    return timing.chain_ms(lambda _: call(), None, 10, dev)[0]


def main():
    dev = timing.start("cuda")
    lib = _build()
    g = torch.Generator(device=dev).manual_seed(31)
    xa, xb = (torch.randn((B, S, S, S), generator=g, device=dev) for _ in range(2))
    oa, ob = torch.empty_like(xa), torch.empty_like(xb)
    for kernel, mode in MODES:
        want = probes.probe_ref(xa, mode) if kernel == 4 else probes.probe2_ref(xa, xb, mode, 8)
        grid = probes.probe_geometry(kernel, (B, S, S, S), mode)["grid"]
        if grid > RECORDS:
            raise RuntimeError(f"K{kernel} {mode}: {grid} blocks, over the {RECORDS} recorded")
        call = _launcher(lib, kernel, mode, xa, xb, oa, ob)
        call()
        torch.cuda.synchronize()
        pairs = [(oa, want)] if kernel == 4 else [(oa, want[0]), (ob, want[1])]
        if not all(torch.equal(k, r) for k, r in pairs):
            raise RuntimeError(f"K{kernel} {mode}: the profiling build differs from plain")
        del want, pairs
        ms = _queued_ms(call, dev)
        call()
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (4 * grid))()
        if lib.fsg_ring_records(raw, grid):
            raise RuntimeError("ring_profile: reading the records failed")
        s = block_summary(np.ctypeslib.as_array(raw).reshape(grid, 4))
        ends = "/".join(f"{v:.1f}" for v in s["ends_us"])
        print(f"K{kernel} {mode} ring: grid {grid}, {ms:.4f} ms per launch queued; block ends p0/10/50/90/100 "
              f"{ends} us, busy mean {s['busy_us']:.1f} us; barrier wait {100 * s['wait']:.1f}% of the walk",
              flush=True)
    for kernel, modes in ((4, probes.SINGLE_MODES), (3, probes.PAIR_MODES)):
        ops = (xa,) if kernel == 4 else (xa, xb)
        for mode in modes:
            if kernel == 4:
                wrapper = lambda m=mode: probes.probe(xa, m)  # noqa: E731
            else:
                wrapper = lambda m=mode: probes.probe2(xa, xb, m, 8 if m == "taps" else 0)  # noqa: E731
            lib_name = "mul" if mode == "copy" else "clone"
            if mode == "copy":
                yard = lambda: [torch.mul(v, 2.0) for v in ops]  # noqa: E731
            else:
                yard = lambda: [torch.clone(v) for v in ops]  # noqa: E731
            for name, call in ((f"K{kernel} {mode}", wrapper), (f"  {lib_name} x{len(ops)}", yard)):
                one, fenced, kern = _one_ms(call, False), _one_ms(call, True), _kernel_ms(call)
                print(f"{name}: one {one:.4f} ms, fenced {fenced:.4f}, kernels {kern:.4f}, queued "
                      f"{_queued_ms(call, dev):.4f}; host time of one call {_host_us(call):.1f} us", flush=True)


if __name__ == "__main__":
    main()
