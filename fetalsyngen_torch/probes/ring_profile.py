"""Probe: where the launches of the ring kernels (K2, K3, K4) and of K5 spend
their time on the card.

    python -m fetalsyngen_torch.probes.ring_profile [--wrappers]

1. Builds ``csrc/probes.cu`` and ``csrc/hat_single.cu`` once more with
   ``-DFSG_RING_PROFILE`` (under ``build/ring_profile/``): the kernels as
   they are, with a record per ring block of its start and end on the card's
   global timer and, for one thread of its second warp, the cycles it waited
   on the ring's barriers and the cycles of its walk. For each staged K3/K4
   mode on B=4 256^3 operands (``chip_smoke.py``'s phase 10), and for each
   K2 form at phase 3's shapes (:data:`K2_FORMS`), it checks that build
   against the plain version, then prints its ms per launch queued back to
   back (:func:`timing.chain_ms`), the blocks' end times from the first
   block's start (percentiles 0/10/50/90/100, and their spread: p100 - p0
   over p100, with its median over five launches), their mean busy time and
   the share of the walk spent waiting on the barriers
   (:func:`block_summary`). K2 runs at the tile size ``csrc/hat_single.cu``
   builds with.
2. Through the public wrappers, for every K3 and K4 mode and its torch
   yardstick (``mul`` for copy, else ``clone``, once per operand), every K2
   form (yardstick: one ``clone`` of its volume) and K5 (two ``clone``\\ s),
   the ms of one call four ways: ``one``, as ``chip_smoke.py`` times it (an
   event, the call, an event; median of 20, :func:`one_ms`); ``fenced``, the
   same behind a wait enqueued first (``torch.cuda._sleep``), so the card
   waits for no host work; ``kernels``, the device time of the kernels the
   fenced call launched (``torch.profiler``, :func:`kernel_ms`); ``queued``,
   back to back. Then the host time of one call with the card idle (median
   of 20, :func:`host_us`). ``one - fenced`` is the time the card waited for
   the host; ``fenced - kernels`` the card's own time around the kernels.
   K2's and K5's lines add the bound (:func:`timing.hat_bound`,
   :func:`timing.bound`) and the fenced time's share of it.

``--wrappers`` runs part 2 for K2 and K5 alone. It uses only the wrappers'
public names, so it times another checkout's kernels when run as a file
with that checkout first on the path:
``PYTHONPATH=<checkout> python <this file> --wrappers``.

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import time

import numpy as np
import torch

from fetalsyngen_torch.kernels import build, hat, probes
from fetalsyngen_torch.ops.warp import FIELD_LIM
from fetalsyngen_torch.probes import profile_kernel_variants, timing

B, S = 4, 256
RECORDS = 65536  # ring blocks the profiling build records (kRecords)
FENCE_CYCLES = 1_000_000  # the enqueued wait, ~0.5 ms at the H100's clocks
RUNS = 20
SPREAD_RUNS = 5  # launches whose block records give the median spread
MODES = [(4, "stage"), (4, "ladder"), (4, "tiles"), (4, "sweep12"), (3, "stage"), (3, "taps")]
# K2's forms at phase 3's shapes: (name, nearest, coefficient kind, disp kind,
# x shape); the inputs come from :func:`k2_inputs`
K2_FORMS = (
    ("per-sample linear B=1 256^3", False, "sample", None, (1, 256, 256, 256)),
    ("per-sample nearest B=1 256^3", True, "sample", None, (1, 256, 256, 256)),
    ("field linear B=1 256^3", False, "sample", "volume", (1, 256, 256, 256)),
    ("field nearest B=1 256^3", True, "sample", "volume", (1, 256, 256, 256)),
    ("per-slice cube 384", False, "slice", None, (1, 128, 384, 384)),
    ("per-slice cube 640", False, "slice", None, (1, 128, 640, 640)),
    ("lane-affine K7 inputs 384^3", False, "sample", "k7", (1, 384, 384, 384)),
    ("lane-affine wide table 256^3", False, "sample", "lane", (1, 256, 256, 256)),
)


def _profile_build(stem: str) -> ctypes.CDLL:
    """``csrc/<stem>.cu`` with ``FSG_RING_PROFILE`` defined, loaded."""
    d = build.BUILD_DIR.parent / "ring_profile"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / f"lib{stem}_profile.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DFSG_RING_PROFILE", "-o", str(lib), str(build.CSRC / f"{stem}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the profiling build of {stem}.cu:\n{r.stderr}")
    return ctypes.CDLL(str(lib))


def _checked(fn, args, name):
    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{name}: cudaError {rc}")

    return call


def _probe_launcher(lib, kernel, mode, xa, xb, oa, ob):
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
    return _checked(fn, args, f"K{kernel} {mode}")


def _hat_launcher(lib, x, coefs, disp, nearest, out):
    """A call of the profiling build's K2 entry point on the current stream,
    raising on a launch error; and the launch's grid."""
    B, D, H, S = x.shape
    coef_mode = int(coefs.dim() == 3)
    disp_mode = 0 if disp is None else (2 if disp.dim() == 3 else 1)
    fn = lib.fsg_hat_pass_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    args = (x.data_ptr(), None if disp is None else disp.data_ptr(), coefs.data_ptr(), out.data_ptr(), B, D * H,
            H, S, int(nearest), coef_mode, disp_mode, torch.cuda.current_stream(x.device).cuda_stream)
    geo = lib.fsg_hat_geometry
    geo.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    g = (ctypes.c_int * 4)()
    if geo(B, D * H, S, int(nearest), coef_mode, disp_mode, g):
        raise RuntimeError("fsg_hat_geometry failed")
    return _checked(fn, args, "K2"), g[2]


def block_summary(rec: np.ndarray) -> dict:
    """The records of one launch, (blocks, 4): start ns, end ns, cycles
    waited on the barriers, cycles of the walk. Returns the blocks' end
    times in us from the first start (percentiles 0/10/50/90/100), their
    spread (p100 - p0 over p100), their mean busy time in us and the share
    of the walk spent waiting."""
    rec = rec.astype(np.float64)
    t0 = rec[:, 0].min()
    ends = np.percentile((rec[:, 1] - t0) / 1e3, [0, 10, 50, 90, 100])
    return dict(ends_us=ends.tolist(), spread=float((ends[-1] - ends[0]) / ends[-1]),
                busy_us=float(((rec[:, 1] - rec[:, 0]) / 1e3).mean()),
                wait=float(rec[:, 2].sum() / rec[:, 3].sum()))


def _ring_line(lib, name, call, grid, dev):
    """Queued ms, then the block records of SPREAD_RUNS more launches, one at
    a time: the last launch's summary and the median spread, printed."""
    if grid > RECORDS:
        raise RuntimeError(f"{name}: {grid} blocks, over the {RECORDS} recorded")
    ms = timing.chain_ms(lambda _: call(), None, 10, dev)[0]
    spreads = []
    for _ in range(SPREAD_RUNS):
        call()
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (4 * grid))()
        if lib.fsg_ring_records(raw, grid):
            raise RuntimeError("ring_profile: reading the records failed")
        s = block_summary(np.ctypeslib.as_array(raw).reshape(grid, 4))
        spreads.append(s["spread"])
    ends = "/".join(f"{v:.1f}" for v in s["ends_us"])
    spread = 100 * statistics.median(spreads)
    print(f"{name} ring: grid {grid}, {ms:.4f} ms per launch queued; block ends p0/10/50/90/100 {ends} us "
          f"(spread {100 * s['spread']:.1f}%, median of {SPREAD_RUNS} launches {spread:.1f}%), busy mean "
          f"{s['busy_us']:.1f} us; barrier wait {100 * s['wait']:.1f}% of the walk", flush=True)


def one_ms(call, fence: bool) -> float:
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


def kernel_ms(call) -> float:
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


def host_us(call) -> float:
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


def _wrapper_line(name, call, dev, bound_ms=None):
    one, fenced, kern = one_ms(call, False), one_ms(call, True), kernel_ms(call)
    queued = timing.chain_ms(lambda _: call(), None, 10, dev)[0]
    share = "" if bound_ms is None else f"; bound {bound_ms:.4f} ms, fenced at {100 * bound_ms / fenced:.1f}% of it"
    print(f"{name}: one {one:.4f} ms, fenced {fenced:.4f}, kernels {kern:.4f}, queued {queued:.4f}; host time of "
          f"one call {host_us(call):.1f} us{share}", flush=True)


def k2_inputs(form, dev, g):
    """(x, coefs, disp, nearest, bound ms) of a :data:`K2_FORMS` entry."""
    _, nearest, coef, disp_kind, (b, d, h, s) = form
    if disp_kind == "k7":
        x, c7, table = profile_kernel_variants.inputs(d, dev)
        x, coefs, disp = x[None], c7[None], table[None]
    else:
        x = torch.rand((b, d, h, s), generator=g, device=dev) * 100.0
        if nearest:
            x = torch.floor(x * 0.5)
        if coef == "slice":
            u = torch.rand((b, d, 4), generator=g, device=dev) - 0.5
            coefs = torch.stack([u[..., 0] * 0, u[..., 1] * 0.1, 1.0 + u[..., 2] * 0.04, u[..., 3] * 6.0], -1)
        else:
            coefs = torch.tensor([[0.05, -0.04, 1.02, -3.1]], device=dev).expand(b, 4)
        coefs = coefs.contiguous()
        disp = None
        if disp_kind == "volume":
            disp = (torch.rand((b, d, h, s), generator=g, device=dev) * 2 - 1) * FIELD_LIM
        elif disp_kind == "lane":
            disp = torch.randn((b, 3, s), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [4.0]]], device=dev)
    _, d, h, s = x.shape
    return x, coefs, disp, nearest, timing.hat_bound(False, 1, d, h, s, s, disp, nearest)[0]


def wrappers(dev):
    """Part 2 for K2's forms and K5, through the public wrappers alone."""
    g = torch.Generator(device=dev).manual_seed(41)
    for form in K2_FORMS:
        x, coefs, disp, nearest, bnd = k2_inputs(form, dev, g)
        if not torch.equal(hat.hat_pass(x, coefs, disp, nearest), hat.hat_pass_ref(x, coefs, disp, nearest)):
            raise RuntimeError(f"K2 {form[0]}: kernel differs from plain")
        _wrapper_line(f"K2 {form[0]}", lambda: hat.hat_pass(x, coefs, disp, nearest), dev, bnd)
        _wrapper_line("  clone x1", lambda: torch.clone(x), dev)
        del x, coefs, disp
    xa, xb = (torch.randn((B, S, S, S), generator=g, device=dev) for _ in range(2))
    if not all(torch.equal(k, r) for k, r in zip(probes.pair_copy(xa, xb), probes.pair_copy_ref(xa, xb))):
        raise RuntimeError("K5: kernel differs from plain")
    _wrapper_line("K5 pair_copy", lambda: probes.pair_copy(xa, xb), dev, timing.bound(16 * xa.numel(), 0)[0])
    _wrapper_line("  clone x2", lambda: (torch.clone(xa), torch.clone(xb)), dev)


def rings(dev):
    """Part 1: the block records of the staged K3/K4 modes and K2's forms."""
    lib = _profile_build("probes")
    g = torch.Generator(device=dev).manual_seed(31)
    xa, xb = (torch.randn((B, S, S, S), generator=g, device=dev) for _ in range(2))
    oa, ob = torch.empty_like(xa), torch.empty_like(xb)
    for kernel, mode in MODES:
        want = probes.probe_ref(xa, mode) if kernel == 4 else probes.probe2_ref(xa, xb, mode, 8)
        call = _probe_launcher(lib, kernel, mode, xa, xb, oa, ob)
        call()
        torch.cuda.synchronize()
        pairs = [(oa, want)] if kernel == 4 else [(oa, want[0]), (ob, want[1])]
        if not all(torch.equal(k, r) for k, r in pairs):
            raise RuntimeError(f"K{kernel} {mode}: the profiling build differs from plain")
        del want, pairs
        _ring_line(lib, f"K{kernel} {mode}", call, probes.probe_geometry(kernel, (B, S, S, S), mode)["grid"], dev)
    del xa, xb, oa, ob
    lib = _profile_build("hat_single")
    for form in K2_FORMS:
        x, coefs, disp, nearest, _ = k2_inputs(form, dev, g)
        out = torch.empty_like(x)
        call, grid = _hat_launcher(lib, x, coefs, disp, nearest, out)
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, hat.hat_pass_ref(x, coefs, disp, nearest)):
            raise RuntimeError(f"K2 {form[0]}: the profiling build differs from plain")
        _ring_line(lib, f"K2 {form[0]}", call, grid, dev)
        del x, coefs, disp, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wrappers", action="store_true", help="only K2's and K5's wrappers, part 2")
    args = ap.parse_args(argv)
    dev = timing.start("cuda")
    if args.wrappers:
        wrappers(dev)
        return
    rings(dev)
    g = torch.Generator(device=dev).manual_seed(31)
    xa, xb = (torch.randn((B, S, S, S), generator=g, device=dev) for _ in range(2))
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
            _wrapper_line(f"K{kernel} {mode}", wrapper, dev)
            _wrapper_line(f"  {lib_name} x{len(ops)}", yard, dev)
    del xa, xb
    wrappers(dev)


if __name__ == "__main__":
    main()
