#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and ``nvcc``; without a device it exits non-zero before printing any
result. Phases, each of which raises on failure:

1. device: TF32 off, f32 matmuls at "highest"; the card's name and power
   limit from ``nvidia-smi``;
2. build: ``fetalsyngen_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a``;
3. kernels against plain: the paired hat pass (K1) at the main path's three
   pass geometries (B=4, 256x256 rows, 256 lanes), and the single-operand
   hat pass (K2) at the pass geometries of the single-volume warps (B=1,
   the affine warp's five passes and the field warp's six, which share the
   three U passes) in both modes, plus crafted coefficients; exact
   half-integer and out-of-range positions mixed in; K1's labels and every
   K2 form bit-identical, K1's image within ``1e-5 * max|x|``; times as the
   median of 20 CUDA-event runs;
4. the slice end to end: ``synth_batch`` at 256^3 x 4 with the benchmark's
   generator config, with host syncs made errors; output checks, three
   kernel launches, then one sample replayed through the port on the CPU
   (the plain paths) with the same parameters and fields: image within
   1e-4, labels differing on at most 1e-5 of voxels;
5. timing: vol/s over 24 batches after 2 warm-up batches, peak device
   memory, and single-volume latency in three rounds of 15 draws (p50 of
   each round, and the host's share: the time until ``synth_sample``
   returns, before the device is waited for);
6. where the time goes: each stage's device time (CUDA events between the
   stages of ``synth_core`` over 10 batches queued back to back, so the
   host runs ahead and the intervals hold device work, not waits for the
   host; median per stage), then the operators and kernels with the most
   device time (``torch.profiler`` over 3 batches);
7. the public API on the real ``data/sub-sta21`` fixture at 256^3, one
   sample per call on the card, with the generator of
   ``configs/dataset/generator/default.yaml`` less its SR artifacts, in
   three configurations: the seed path of ``synth_train.yaml`` (K1), the
   image as intensity plus the co-deformed T2w of ``real_train.yaml`` (K1
   and K2), and that with ``nonlinear_transform=False`` (K2 in both modes).
   For each: the kernels' launch counts, the image in [0, 1], labels a
   subset of the input's, replay from the returned genparams bit-identical,
   the same sample through the port on the CPU (image within 1e-4, labels
   differing on at most 1e-5 of voxels); then samples/s of ``ds[0]`` over 10
   draws after 2 warm-ups, peak device memory, and 10 draws split into the
   steps of ``ds.sample``: host load (NIfTI decode), prepare (seed sum,
   upload, draws), generation (host wall and CUDA events), download plus
   scaling.

Phase 3 also holds the scanner's forms of K1 (linear pair with a
lane-affine table; with per-slice coefficients) and K2 (per-slice) against
their plain versions at cubes 384 and 640 with 128 slice rows, on the pass
tables of a real stack geometry with recorded motion: bit-identical, with
the counts of half-integer and saturated positions. Every kernel check also
times ``torch.nn.functional.grid_sample`` (bilinear, border, corners
aligned) on the same positions as the library yardstick, and computes the
kernel's bound: the larger of its bytes over 3.35 TB/s and its f32
operations over 67 TFLOP/s.

8. the motion artifact (``SimulateMotion`` with ``default.yaml``'s
   parameters, prob 1) on a 256^3 ``synth_train`` sample, its slice
   resolution pinned to 0.5, 0.35 and 0.25 mm (the 384, 512 and 640 cube
   tiers): CUDA-event ms of acquisition and reconstruction, host ms, launch
   counts, stacks, slices, peak memory, replay from the metadata
   bit-identical; then the card against the port's CPU path with device
   noise off, on ``scanner_ab_case`` at cube 128 and on one 256^3 call at
   the 384 tier: within 1e-4 of the data scale, validity flags and metadata
   equal;
9. ``FetalSynthDataset`` on ``synth_train.yaml`` as it is (its generator
   with the four SR artifacts) on ``data/sub-sta21`` at 256^3, once at the
   YAML's probabilities and once with every artifact forced on: samples/s
   over 10 draws after 2 warm-ups, each artifact's device time (CUDA
   events), launch counts, replay bit-identical, peak memory.

10. the kernel probes: the three probe entry points
    (``fetalsyngen_torch.probes.microbench_warp`` for every variant,
    ``probe_blocktp``, ``profile_kernel_variants``) at their own sizes with
    the launch counts read around them, then each probe kernel and mode
    against its plain version at those sizes (K5 and K6 on B=4 256^3
    pairs, K3 taps8 and K4 on B=4 256^3 volumes, K7 V0-V4 on 147,456 rows
    of 384): bit-identical, the median of 20 CUDA-event runs, the bound and,
    where one torch call computes the same function, its time; then, untimed,
    every K3 and K4 mode bit for bit (the sign of zero included) at one shape
    per kernel whose rows end in a partial tile and whose blocks walk their
    ring of tiles more than once, and each mode's launch geometry (tile rows,
    ring stages, grid, dynamic shared memory) there and at B=4 256^3.

Phase 3 also holds K1's form without a displacement (the probes'
``pair_l_nodisp`` and ``pair_u`` coefficients, and crafted half-integers)
and K2's lane-affine form (K7's inputs, and a wide table at 256^3) against
their plain versions. Every K2 check (and K5's in phase 10) also prints the
kernel's time behind an enqueued wait ("fenced": the card's own time, no
host wait) and the host wait, one launch's time less the fenced one. Then,
untimed, every K2 form bit for bit (the sign of zero included) at one shape
whose tiles span two samples and two slices and end partial, with each
form's launch geometry (tile rows, ring stages, grid, shared memory).

Each phase prints its elapsed time. The line before the last is the
kernels' JSON record, one entry per kernel form and probe mode; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from fetalsyngen_torch.data.datasets import FetalSynthDataset
from fetalsyngen_torch.data.transforms import scale_intensity
from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.generator.artifacts import quality as tq
from fetalsyngen_torch.generator.artifacts import scanner as sc
from fetalsyngen_torch.generator.artifacts.motion import sample_motion
from fetalsyngen_torch.generator.artifacts.transforms import interleave_index, random_init_stack_transforms
from fetalsyngen_torch.generator.config import GeneratorCfg, IntensityCfg
from fetalsyngen_torch.generator.model import (
    FetalSynthGen,
    ImageFromSeeds,
    RandBiasField,
    RandGamma,
    RandNoise,
    RandResample,
    SpatialDeformation,
)
from fetalsyngen_torch.generator.params import genparams_to_dict, sample_params
from fetalsyngen_torch.io import nifti
from fetalsyngen_torch.kernels import build, hat, probes
from fetalsyngen_torch.ops.affine import make_affine_matrix
from fetalsyngen_torch.ops.morphology import box_sum
from fetalsyngen_torch.ops.numerics import device_const
from fetalsyngen_torch.ops.warp import FIELD_LIM, ul_decompose
from fetalsyngen_torch.probes import microbench_warp, probe_blocktp, profile_kernel_variants, ring_profile
from fetalsyngen_torch.probes.timing import bound, hat_bound
from fetalsyngen_torch.testing import phantom_seeds_and_seg, run_scanner_ab, scanner_ab_case

REPO = Path(__file__).resolve().parent
DATA = REPO / "data"
SHAPE = (256, 256, 256)
BATCH = 4
LABELS = tuple([0] + list(range(10, 50)))
GEN_CLASSES = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
KERNEL_TOL = 1e-5  # image |kernel - plain| <= KERNEL_TOL * max|x|
IMAGE_TOL = 1e-4  # |GPU - CPU| on the [0, 1] image
LABEL_TOL = 1e-5  # fraction of labels allowed to differ between GPU and CPU
SCANNER_TOL = 1e-4  # |GPU - CPU| of the scanner's outputs over their max |x|
# the kernels' sources and the TPU kernels they replace, by LAUNCHES key
KERNELS = {
    "hat_pass_pair": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_pair_lane": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_pair_slice": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_pair_nodisp": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    "hat_pass_lane": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    "hat_pass_slice": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    "pair_copy": ("fetalsyngen_torch/csrc/probes.cu", "scripts/probe_blocktp.py:30"),
    "pair_transpose": ("fetalsyngen_torch/csrc/probes.cu", "scripts/probe_blocktp.py:35"),
    **{f"probe2_{m}": ("fetalsyngen_torch/csrc/probes.cu", "scripts/microbench_warp.py:198")
       for m in probes.PAIR_MODES},
    **{f"probe_{m}": ("fetalsyngen_torch/csrc/probes.cu", "scripts/microbench_warp.py:272")
       for m in probes.SINGLE_MODES},
    **{f"hat_variant_v{v}": ("fetalsyngen_torch/csrc/hat_single.cu", "scripts/profile_kernel_variants.py:35")
       for v in probes.VARIANTS},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for d in (hat.LAUNCHES, probes.LAUNCHES):
        for k in d:
            d[k] = 0


def counts(**nonzero) -> dict:
    """A full LAUNCHES dict: zero but for ``nonzero``."""
    return {**dict.fromkeys(hat.LAUNCHES, 0), **nonzero}


def cuda_ms(fn, n: int = 20) -> float:
    """Median milliseconds of ``fn()`` over ``n`` CUDA-event timed runs."""
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def grid_sample_ms(vols, pos, n: int = 20) -> float:
    """Library yardstick: ms of one ``grid_sample`` (bilinear, border, corners
    aligned) of the rows of the (B, D, H, S) ``vols`` stacked as channels at
    the (B, D*H, OW) positions ``pos`` (the grid is built beforehand)."""
    B, D, H, S = vols[0].shape
    OW = pos.shape[-1]
    inp = torch.stack(vols, 2).reshape(B * D, len(vols), H, S)
    x = pos.reshape(B * D, H, OW) * (2.0 / (S - 1)) - 1.0
    y = torch.arange(H, dtype=torch.float32, device=pos.device) * (2.0 / max(H - 1, 1)) - 1.0
    grid = torch.stack([x, y[None, :, None].expand(B * D, H, OW)], -1)
    del x
    return cuda_ms(lambda: F.grid_sample(inp, grid, "bilinear", "border", align_corners=True), n)


def bench_cfg():
    return GeneratorCfg(
        shape=SHAPE, resolution=(0.5, 0.5, 0.5), intensity=IntensityCfg(1, 6, LABELS, GEN_CLASSES)
    )


def craft_disp(disp, pos0, S):
    """``disp`` with exact half-integer positions (Sterbenz-exact
    differences) and positions past both edges mixed in, given the
    positions ``pos0`` without displacement."""
    lane = torch.arange(S, device=disp.device)
    half = (torch.round(pos0) + 0.5) - pos0
    disp = torch.where(lane % 7 == 3, half, disp)
    disp = torch.where(lane % 11 == 5, -pos0 - 2.5, disp)
    return torch.where(lane % 13 == 6, (S + 2.0) - pos0, disp)


def count_positions(pos, S):
    """(exact half-integer positions, saturated positions)."""
    return int((pos - torch.floor(pos) == 0.5).sum()), int(((pos <= 0) | (pos >= S - 1)).sum())


def check_kernel(dev, cfg):
    """Phase 3: K1 against its plain version at the three main-path passes."""
    p = sample_params(tpipe.make_generators(range(BATCH), dev), cfg)
    _, L = ul_decompose(make_affine_matrix(p.rotations, p.shears, p.scalings))
    g = torch.Generator(device=dev).manual_seed(1234)
    D = H = S = SHAPE[0]
    R = D * H
    xa = 100.0 * torch.rand((BATCH, D, H, S), generator=g, device=dev)
    xb = torch.randint(0, 50, (BATCH, D, H, S), generator=g, device=dev).to(torch.float32)
    zero = torch.zeros(BATCH, device=dev)
    results = []
    for name, ci in (("L-y", L[:, 1, 0]), ("L-z", L[:, 2, 0]), ("x", zero)):
        coefs = torch.stack([ci, zero, zero + 1, zero], 1).contiguous()
        disp = (torch.rand((BATCH, R, S), generator=g, device=dev) * 2 - 1) * FIELD_LIM
        disp = craft_disp(disp, hat.positions(coefs, R, H, S, None), S)
        disp = disp.reshape(BATCH, D, H, S).contiguous()
        n_half, n_out = count_positions(hat.positions(coefs, R, H, S, disp.reshape(BATCH, R, S)), S)
        ka, kb = hat.hat_pass_pair(xa, xb, coefs, disp)
        ra, rb = hat.hat_pass_pair_ref(xa, xb, coefs, disp)
        torch.cuda.synchronize()
        err = float((ka - ra).abs().max())
        label_diff = int((kb != rb).sum())
        bar = KERNEL_TOL * float(xa.abs().max())
        ms = cuda_ms(lambda: hat.hat_pass_pair(xa, xb, coefs, disp))
        plain_ms = cuda_ms(lambda: hat.hat_pass_pair_ref(xa, xb, coefs, disp))
        lib_ms = grid_sample_ms([xa, xb], hat.positions(coefs, R, H, S, disp.reshape(BATCH, R, S)))
        bound_ms, bound_by = hat_bound(True, BATCH, D, H, S, S, disp, nearest=True)
        log(
            f"kernel hat_pass_pair {name}: B={BATCH} R={R} S=OW={S} half-integer positions={n_half} "
            f"saturated={n_out} image max|kernel-plain|={err:.3e} (bar {bar:.3e}) "
            f"labels differing={label_diff} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"grid_sample {lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})"
        )
        if n_half == 0 or n_out == 0:
            raise RuntimeError(f"{name}: the crafted half-integer/edge positions did not occur")
        if label_diff or not err <= bar:
            raise RuntimeError(f"{name}: kernel disagrees with plain (labels {label_diff}, image {err})")
        results.append(dict(key="hat_pass_pair", err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
    return results


def check_single_kernel(dev, cfg):
    """Phase 3: K2 against its plain version at the pass geometries of
    ``warp_affine_separable`` and ``warp_affine_field_separable`` (B=1, as
    the API runs them), in both modes, and at crafted coefficients."""
    p = sample_params(tpipe.make_generators([0], dev), cfg)
    A = make_affine_matrix(p.rotations, p.shears, p.scalings)
    U, L = ul_decompose(A)
    c = torch.full((1, 3), (SHAPE[0] - 1) / 2.0, device=dev)
    t = c - torch.einsum("bij,bj->bi", A, c)
    z = torch.zeros(1, device=dev)
    one = z + 1
    geometries = [
        ("U-z", (z, z, U[:, 2, 2], t[:, 2]), False),
        ("U-y", (z, U[:, 1, 2], U[:, 1, 1], t[:, 1]), False),
        ("U-x", (U[:, 0, 1], U[:, 0, 2], U[:, 0, 0], t[:, 0]), False),
        ("L-y", (L[:, 1, 0], z, one, z), False),
        ("L-z", (L[:, 2, 0], L[:, 2, 1], one, z), False),
        ("field L-y", (L[:, 1, 0], z, one, z), True),
        ("field L-z", (L[:, 2, 0], L[:, 2, 1], one, z), True),
        ("field x", (z, z, one, z), True),
        # crafted: quarter-voxel rows give exact half-integers, the row
        # terms reach past both edges
        ("crafted", (z + 0.25, z - 0.5, one, z + 0.5), False),
    ]
    g = torch.Generator(device=dev).manual_seed(4321)
    D = H = S = SHAPE[0]
    R = D * H
    volumes = {
        False: 100.0 * torch.rand((1, D, H, S), generator=g, device=dev),
        True: torch.randint(0, 50, (1, D, H, S), generator=g, device=dev).to(torch.float32),
    }
    results = []
    for name, cs, with_disp in geometries:
        coefs = torch.stack(cs, 1).contiguous()
        disp = None
        if with_disp:
            disp = (torch.rand((1, R, S), generator=g, device=dev) * 2 - 1) * FIELD_LIM
            disp = craft_disp(disp, hat.positions(coefs, R, H, S, None), S)
        n_half, n_out = count_positions(hat.positions(coefs, R, H, S, disp), S)
        if disp is not None:
            disp = disp.reshape(1, D, H, S).contiguous()
        if (with_disp or name == "crafted") and (n_half == 0 or n_out == 0):
            raise RuntimeError(f"{name}: the crafted half-integer/edge positions did not occur")
        for nearest in (False, True):
            x = volumes[nearest]
            pos = hat.positions(coefs, R, H, S, None if disp is None else disp.reshape(1, R, S))
            results.append(compare(
                "hat_pass", f"{name} {'nearest' if nearest else 'linear'}",
                lambda: hat.hat_pass(x, coefs, disp, nearest), lambda: hat.hat_pass_ref(x, coefs, disp, nearest),
                hat_bound(False, 1, D, H, S, S, disp, nearest), lib=lambda: grid_sample_ms([x], pos),
                note=f" B=1 R={R} S=OW={S} half-integer positions={n_half} saturated={n_out}", fenced=True,
            ))
            del pos
    return results


# cube tier -> a slice-to-volume resolution ratio that selects it at 256^3
TIER_RS = {384: 1.0, 512: 0.7, 640: 0.5}
# (cube tier, pinned slice resolution in mm) of phase 8's motion calls
MOTION_TIERS = ((384, 0.5), (512, 0.35), (640, 0.25))


def stack_tables(dev, cube: int, rs: float, shape=(256, 256, 256), ns_grid: int = 128, seed: int = 0):
    """The pass tables of one stack of a ``shape`` volume at 0.5 mm, gap 3
    mm, recorded motion with interleaved slices, slice resolution ``rs``
    times the volume's, on a ``cube`` stack frame: (name, pair?, (D, H, S),
    coefs, disp) per hat pass of the acquisition and the reconstruction."""
    res, gap = 0.5, 3.0
    gap_vox = gap / res
    ns = min(int(max(shape) * res / gap) + 2, ns_grid)
    rng = np.random.default_rng(seed)
    t_init = random_init_stack_transforms(ns, gap, False, 3.0, rng)
    t_motion = sample_motion(np.arange(ns) * 1.5, rng)[np.asarray(interleave_index(ns, 3))]
    mats = t_motion.compose(t_init).matrix(True).copy()
    mats[:, :, 3] /= res
    geo = sc._stack_geometry(t_init.matrix(True)[0, :, :3], mats, shape, ns, cube, ns_grid)
    G = device_const(geo["G"], torch.float32, dev)
    c_ss = (cube - 1) / 2.0
    rs, gap_vox = sc._f32(rs), sc._f32(gap_vox)
    z0 = sc._f32(c_ss - (ns - 1) / 2.0 * gap_vox)
    dz, dv, du = sc._slice_coef_tables(G, rs, c_ss, z0, gap_vox, ns_grid)
    idv, idu = sc._inplane_coef_tables(G, rs, c_ss, -1.0)
    unit = sc._unit_coefs(dev)[None]
    dz_tab = sc._dz_lane_table(dz, rs, c_ss, z0, gap_vox, cube, ns_grid)[None].contiguous()
    dzr_tab = sc._dzr_lane_table(G, rs, c_ss, z0, gap_vox, ns_grid)[None].contiguous()
    slab = (ns_grid, cube, cube)
    return [
        ("acquire dz", True, (cube, cube, cube), unit, dz_tab),
        ("acquire dv", True, slab, dv[None].contiguous(), None),
        ("acquire du", True, slab, du[None].contiguous(), None),
        ("recon dz", True, (cube, cube, dzr_tab.shape[-1]), unit, dzr_tab),
        ("recon du", False, slab, idu[None].contiguous(), None),
        ("recon dv", False, slab, idv[None].contiguous(), None),
    ]


def check_scanner_kernels(dev, cubes=(384, 640)):
    """Phase 3: the scanner's K1 and K2 forms against their plain versions,
    bit-identical, at each cube's real pass tables."""
    g = torch.Generator(device=dev).manual_seed(99)
    results = []
    for cube in cubes:
        if sc.slice_grid(SHAPE, TIER_RS[cube]) != cube:
            raise RuntimeError(f"slice resolution ratio {TIER_RS[cube]} does not select the {cube} tier")
        for name, pair, (D, H, S), coefs, disp in stack_tables(dev, cube, TIER_RS[cube], SHAPE):
            xa = 100.0 * torch.rand((1, D, H, S), generator=g, device=dev)
            xb = torch.rand((1, D, H, S), generator=g, device=dev) if pair else None
            if pair:
                key = "hat_pass_pair_lane" if disp is not None else "hat_pass_pair_slice"
                run = lambda: hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b=False)  # noqa: E731
                plain = lambda: hat.hat_pass_pair_ref(xa, xb, coefs, disp, nearest_b=False)  # noqa: E731
            else:
                key = "hat_pass_slice"
                run = lambda: hat.hat_pass(xa, coefs)  # noqa: E731
                plain = lambda: hat.hat_pass_ref(xa, coefs)  # noqa: E731
            pos = hat._positions_of(coefs, 1, D, H, S, disp)
            n_half, n_out = count_positions(pos, S)
            n = 20 if D * H * S <= 2**26 else 5
            results.append(compare(
                key, f"{name} cube {cube}", run, plain, hat_bound(pair, 1, D, H, S, S, disp),
                lib=lambda: grid_sample_ms([xa] + ([xb] if pair else []), pos, n), n=n,
                note=f" R={D * H} S=OW={S} half-integer positions={n_half} saturated={n_out}", fenced=not pair,
            ))
            del pos, xa, xb
    return results


def compare(key, name, run, plain, bnd, lib=None, n=20, note="", fenced=False):
    """One kernel check: ``run()`` (the kernel) against ``plain()``,
    bit-identical or raise; then the median ms of each over ``n`` CUDA-event
    runs, ``lib()`` (the ms of one torch call computing the same function,
    or None) and the bound ``bnd`` = (ms, "bytes" or "operations"). With
    ``fenced``, also the kernel's ms behind an enqueued wait (the card's own
    time, :func:`ring_profile.one_ms`) and the host wait, one launch's ms
    less that."""
    got, want = run(), plain()
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    torch.cuda.synchronize()
    err = max(float((k - r).abs().max()) for k, r in zip(got, want))
    differ = sum(int((k != r).sum()) for k, r in zip(got, want))
    del got, want
    ms, plain_ms = cuda_ms(run, n), cuda_ms(plain, n)
    lib_ms = lib() if lib else None
    bound_ms, bound_by = bnd
    lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    fenced_ms = ring_profile.one_ms(run, True) if fenced else None
    fence_txt = "" if fenced_ms is None else f" (fenced {fenced_ms:.4f} ms, host wait {1e3 * (ms - fenced_ms):.1f} us)"
    log(f"kernel {key} {name}: max|kernel-plain|={err:.3e} elements differing={differ} kernel {ms:.4f} ms"
        f"{fence_txt} plain {plain_ms:.4f} ms library {lib_txt} bound {bound_ms:.4f} ms ({bound_by}){note}")
    if differ or err != 0.0:
        raise RuntimeError(f"{key} {name}: kernel differs from plain ({differ}, {err})")
    return dict(key=key, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, fenced_ms=fenced_ms)


def check_new_hat_forms(dev):
    """Phase 3: K1 without a displacement (the probes' coefficients and
    crafted half-integers, B=4 256^3, labels nearest) and K2's lane-affine
    form (K7's inputs; a wide table at 256^3) against their plain versions."""
    g = torch.Generator(device=dev).manual_seed(2024)
    D = H = S = SHAPE[0]
    R = D * H
    xa = 100.0 * torch.rand((BATCH, D, H, S), generator=g, device=dev)
    xb = torch.randint(0, 50, (BATCH, D, H, S), generator=g, device=dev).to(torch.float32)
    results = []
    for name, c in (("pair_l_nodisp", (0.11, 0.07, 1.0, 0.3)), ("pair_u", (0.05, 0.1, 1.08, -9.0)),
                    ("crafted", (0.25, -0.5, 1.0, 0.5))):
        coefs = torch.tensor([c] * BATCH, device=dev)
        pos = hat.positions(coefs, R, H, S)
        n_half, n_out = count_positions(pos, S)
        results.append(compare(
            "hat_pass_pair_nodisp", name, lambda: hat.hat_pass_pair(xa, xb, coefs, None),
            lambda: hat.hat_pass_pair_ref(xa, xb, coefs, None),
            hat_bound(True, BATCH, D, H, S, S, None, nearest=True),
            lib=lambda: grid_sample_ms([xa, xb], pos),
            note=f" half-integer positions={n_half} saturated={n_out}",
        ))
        del pos
    del xa, xb
    x, c7, table = profile_kernel_variants.inputs(384, dev)
    wide = torch.randn((1, 3, S), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [4.0]]], device=dev)
    cases = (("K7 inputs 384^3", x[None], c7[None], table[None]),
             ("wide table 256^3", 100.0 * torch.rand((1, D, H, S), generator=g, device=dev),
              torch.tensor([[0.0, 0.0, 1.0, 0.0]], device=dev), wide))
    for name, xv, coefs, tab in cases:
        _, d, h, s = xv.shape
        pos = hat.positions(coefs, d * h, h, s, lane=tab)
        n_half, n_out = count_positions(pos, s)
        results.append(compare(
            "hat_pass_lane", name, lambda: hat.hat_pass(xv, coefs, tab), lambda: hat.hat_pass_ref(xv, coefs, tab),
            hat_bound(False, 1, d, h, s, s, tab), lib=lambda: grid_sample_ms([xv], pos),
            note=f" half-integer positions={n_half} saturated={n_out}", fenced=True,
        ))
        del pos
    return results


def check_hat_tiles(dev):
    """Phase 3: every K2 form against its plain version, untimed, at B=3
    (3, 100, 101, 301): rows of 301 lanes start off 16 bytes, 12-row tiles
    span two samples (10,100 rows each) and, per slice, two slices of 101
    rows, the last tile is partial and each block walks its ring more than
    once; -0.0 among the inputs, crafted half-integer and saturated
    positions. Bit for bit (the sign of zero included), or raise. Prints each
    form's launch geometry there and at the phase's B=1 256^3."""
    g = torch.Generator(device=dev).manual_seed(43)
    B, D, H, S = shape = (3, 100, 101, 301)
    R = D * H
    x = 100.0 * torch.randn(shape, generator=g, device=dev)
    x.view(-1)[::7] = -0.0
    labels = torch.randint(-1, 50, shape, generator=g, device=dev).to(torch.float32)
    labels[labels < 0] = -0.0
    per_sample = torch.tensor([[0.25, -0.5, 1.0, 0.5], [0.05, -0.04, 1.02, -3.1], [0.0, 0.0, -1.0, S - 1.0]],
                              device=dev)
    per_slice = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.2, 0.04, 8.0],
                                                                                         device=dev)
    per_slice[..., 2] += 1.0
    field = (torch.rand((B, R, S), generator=g, device=dev) * 2 - 1) * FIELD_LIM
    field = craft_disp(field, hat.positions(per_sample, R, H, S, None), S).reshape(shape).contiguous()
    field.view(-1)[::11] = -0.0
    table = torch.randn((B, 3, S), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [4.0]]], device=dev)
    forms = [("per-sample", False, per_sample, None, "none"), ("per-sample", True, per_sample, None, "none"),
             ("field", False, per_sample, field, "volume"), ("field", True, per_sample, field, "volume"),
             ("lane-affine", False, per_sample, table, "lane"), ("per-slice", False, per_slice, None, "none")]
    for name, nearest, coefs, disp, mode in forms:
        v = labels if nearest else x
        got, want = hat.hat_pass(v, coefs, disp, nearest), hat.hat_pass_ref(v, coefs, disp, nearest)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        pos = hat._positions_of(coefs, B, D, H, S, disp)
        n_half, n_out = count_positions(pos, S)
        geo = {f"{sh}": hat.hat_geometry(sh, nearest, coefs.dim() == 3, mode)
               for sh in (shape, (1, *SHAPE))}
        label = f"{name} {'nearest' if nearest else 'linear'}"
        log(f"kernel hat_pass {label} partial tiles {shape}: bits differing={differ} half-integer positions={n_half} "
            f"saturated={n_out}; launches {json.dumps(geo)}")
        if differ:
            raise RuntimeError(f"hat_pass {label} at {shape}: kernel differs from plain in {differ} elements")
        del got, want, pos


def probe_path():
    """Phase 10's path: the three probe entry points as a user runs them
    (every microbench variant), at their own sizes. Returns the launch
    counts of the run; raises if a probe kernel or the two hat forms it
    uses never launched."""
    torch.cuda.synchronize()
    reset_counts()
    per_vol = {v: microbench_warp.main(["--variant", v]) / BATCH for v in microbench_warp.VARIANTS}
    blocktp = probe_blocktp.main([])
    variants = profile_kernel_variants.main([])
    torch.cuda.synchronize()
    launches = {**hat.LAUNCHES, **probes.LAUNCHES}
    log(json.dumps({"probe_path": {"microbench_ms_per_vol": per_vol, "probe_blocktp_ms_per_vol": blocktp,
                                   "profile_kernel_variants_ms": variants},
                    "launches": {k: v for k, v in launches.items() if v}}))
    missing = [k for k in [*probes.LAUNCHES, "hat_pass_pair_nodisp", "hat_pass_lane"] if not launches[k]]
    if missing:
        raise RuntimeError(f"probe path: kernels never launched: {missing}")
    return launches


def check_probes(dev):
    """Phase 10: every probe kernel and mode against its plain version at the
    entry points' sizes. Bounds: each operand read and written once;
    operations as each function needs them, as :func:`hat_bound` counts:
    copy 1 per element, stage and ladder none, tiles 4 (its zero times the
    position); a hat sample 5 per element with a nonzero tap in this run's
    data (at most two taps are nonzero) after its position (K3 5 per
    element pair, K4 2, K7 11 for the table and 1 for ``rel``), and K7's
    per-block reductions 1 per element each where the variant has them."""
    g = torch.Generator(device=dev).manual_seed(31)
    B, S = BATCH, SHAPE[0]
    xa, xb = (torch.randn((B, S, S, S), generator=g, device=dev) for _ in range(2))
    n = xa.numel()
    tag = f"B={B} {S}^3"
    both = lambda f: lambda: (f(xa), f(xb))  # noqa: E731
    clone_ms = lambda: cuda_ms(both(torch.clone))  # noqa: E731
    results = [
        compare("pair_copy", tag, lambda: probes.pair_copy(xa, xb), lambda: probes.pair_copy_ref(xa, xb),
                bound(16 * n, 0), lib=clone_ms, fenced=True),
        compare("pair_transpose", tag, lambda: probes.pair_transpose(xa, xb),
                lambda: probes.pair_transpose_ref(xa, xb), bound(16 * n, 0),
                lib=lambda: cuda_ms(both(lambda v: v.transpose(-1, -2).contiguous()))),
    ]
    mul_ms = lambda: cuda_ms(both(lambda v: torch.mul(v, 2.0)))  # noqa: E731
    # K3 taps: d0 = rel + 1 depends on the row j and the lane alone; a
    # sample has a nonzero tap in the window where d0 < ntaps
    ntaps = 8
    rj, lane = torch.arange(S, dtype=torch.float32, device=dev)[:, None], torch.arange(S, device=dev)
    d0 = (((0.07 * rj + lane) + 0.3) - lane) + 1.0
    n_lin = int((d0 < ntaps).sum()) * B * S
    del rj, lane, d0
    for mode, ops, lib in (("copy", 2 * n, mul_ms), ("stage", 0, clone_ms), ("taps", 5 * n + 2 * 5 * n_lin, None)):
        k = ntaps if mode == "taps" else 0
        results.append(compare(
            f"probe2_{mode}", f"{tag}" + (f" taps{k}" if k else ""),
            lambda: probes.probe2(xa, xb, mode, k), lambda: probes.probe2_ref(xa, xb, mode, k),
            bound(16 * n, ops), lib=lib,
            note=f"; samples with a nonzero tap {n_lin} of {n}" if k else "",
        ))
    one_mul = lambda: cuda_ms(lambda: torch.mul(xa, 2.0))  # noqa: E731
    one_clone = lambda: cuda_ms(lambda: torch.clone(xa))  # noqa: E731
    # K4 sweep12: the window starts at the lane itself (n0 = 0) and d0 =
    # frac(pos) < 1, so it is (1 - d0) x[l] + d0 x[min(l + 1, S - 1)]: a
    # grid_sample at the positions l + d0
    pos4, _, _ = probes._single_geometry(S * S, S, dev)
    d0 = pos4 - torch.floor(pos4)
    n_lin = int((d0 > 0).sum()) * B
    pos4 = (torch.arange(S, dtype=torch.float32, device=dev) + d0).expand(B, S * S, S)
    del d0
    for mode, ops, lib in (("copy", n, one_mul), ("stage", 0, one_clone), ("ladder", 0, one_clone),
                           ("tiles", 4 * n, one_clone),
                           ("sweep12", 2 * n + 5 * n_lin, lambda: grid_sample_ms([xa], pos4))):
        results.append(compare(f"probe_{mode}", tag, lambda: probes.probe(xa, mode),
                               lambda: probes.probe_ref(xa, mode), bound(8 * n, ops), lib=lib))
    del xa, xb, pos4

    x, c7, table = profile_kernel_variants.inputs(384, dev)
    D, H, S7 = x.shape
    R = D * H
    lane_ms = cuda_ms(lambda: hat.hat_pass(x[None], c7[None], table[None]))
    for v in probes.VARIANTS:
        pos, rel, sat_lo, sat_hi, n0, span = probes.variant_geometry(c7, table, v, D, H, S7)
        valid = ~(sat_lo | sat_hi)
        nb = R // probes.VARIANT_ROWS
        taps = probes.variant_taps(span, v)
        run_taps = int((valid.reshape(nb, -1).sum(1) * taps).sum())
        maxspan = 4 if v == 4 else 48
        d = rel - n0.repeat_interleave(probes.VARIANT_ROWS)[:, None].to(torch.float32)
        clipped = int((valid & ((d > maxspan - 1) | (d < 0))).sum())
        # a valid element's d0 (clipped to [0, maxspan - 1]) has its nonzero
        # taps at floor(d0) and above; they count where the first one runs
        f = torch.floor(torch.clamp(d, 0.0, maxspan - 1.0))
        n_lin = int((valid & (f < taps.repeat_interleave(probes.VARIANT_ROWS)[:, None])).sum())
        ops = R * S7 * (12 + (v in (0, 1, 3)) + (v in (0, 1, 2))) + 5 * n_lin
        del rel, sat_lo, sat_hi, valid, d, f
        # V0 is the hat sample where no valid element passes the span budget
        lib = (lambda: grid_sample_ms([x[None]], pos[None])) if v == 0 and clipped == 0 else None
        results.append(compare(
            f"hat_variant_v{v}", f"R={R} S={S7}", lambda: probes.hat_variant(x, c7, table, v),
            lambda: probes.hat_variant_ref(x, c7, table, v), bound(8 * R * S7 + 4 * (3 * S7 + 4), ops),
            lib=lib, note=f" taps run per element {run_taps / (R * S7):.3f} span-clipped elements {clipped}"
            + (f"; K2 lane-affine hat_pass {lane_ms:.4f} ms" if v == 0 else ""),
        ))
        del pos
    return results


def check_probe_tiles(dev):
    """Phase 10: every K3 and K4 mode against its plain version, untimed, at
    one shape per kernel whose rows end in a partial tile, whose blocks each
    walk their ring more than once and, for K3, whose rows start off 16 bytes
    and whose operands end inside a 16-byte unit; -0.0 among the inputs (the
    tiles mode turns it into +0). Bit for bit, or raise. Prints each launch's
    geometry there and at B=4 256^3."""
    g = torch.Generator(device=dev).manual_seed(37)
    cases = ((3, (3, 101, 101, 301), [("copy", 0), ("stage", 0), ("taps", 8), ("taps", 13)]),
             (4, (3, 100, 101, 384), [(m, 0) for m in probes.SINGLE_MODES]))
    for kernel, shape, modes in cases:
        xa, xb = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
        for x in (xa, xb):
            x.view(-1)[::7] = -0.0
        for mode, ntaps in modes:
            if kernel == 3:
                got, want = probes.probe2(xa, xb, mode, ntaps), probes.probe2_ref(xa, xb, mode, ntaps)
            else:
                got, want = (probes.probe(xa, mode),), (probes.probe_ref(xa, mode),)
            torch.cuda.synchronize()
            differ = sum(int((k.view(torch.int32) != r.view(torch.int32)).sum()) for k, r in zip(got, want))
            name = f"probe{'2' if kernel == 3 else ''}_{mode}" + (f" taps{ntaps}" if ntaps else "")
            geo = {f"{tuple(sh)}": probes.probe_geometry(kernel, sh, mode) for sh in (shape, (BATCH, *SHAPE))}
            log(f"kernel {name} partial tiles {shape}: bits differing={differ}; launches {json.dumps(geo)}")
            if differ:
                raise RuntimeError(f"{name} at {shape}: kernel differs from plain in {differ} elements")
        del xa, xb, got, want


def run_slice(dev, cfg, seeds_np, seg_np):
    """Phase 4: the main path end to end, then one sample again on the CPU."""
    seeds = torch.from_numpy(seeds_np.astype(np.int32)).to(dev).expand(BATCH, *SHAPE).contiguous()
    segs = torch.from_numpy(seg_np.astype(np.int32)).to(dev).expand(BATCH, *SHAPE).contiguous()
    sample_seeds = list(range(BATCH))
    torch.cuda.synchronize()

    # the main path must not synchronise the host with the stream: under
    # "error" mode any synchronising CUDA call raises
    torch.cuda.set_sync_debug_mode("error")
    reset_counts()
    out, seg, p = tpipe.synth_batch(seeds, segs, cfg, sample_seeds, dev)
    launches = dict(hat.LAUNCHES)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"synth_batch: launches {launches}")
    if launches != counts(hat_pass_pair=3):
        raise RuntimeError(f"expected 3 hat_pass_pair launches and no other, got {launches}")

    if tuple(out.shape) != (BATCH, *SHAPE) or tuple(seg.shape) != (BATCH, *SHAPE):
        raise RuntimeError(f"bad output shapes {tuple(out.shape)} {tuple(seg.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite image values")
    in_labels = set(np.unique(seg_np).tolist())
    for b in range(BATCH):
        lo, hi = float(out[b].min()), float(out[b].max())
        gates = {k: bool(getattr(p, k)[b]) for k in
                 ("deform_apply", "gamma_apply", "bf_apply", "resample_apply", "noise_apply")}
        out_labels = set(torch.unique(seg[b]).tolist())
        log(f"sample {b}: image [{lo:.6f}, {hi:.6f}] labels {sorted(out_labels)} gates {gates}")
        # the resize-back stage normalises to [0, 1]; with its gate off the
        # image keeps its intensity scale and is only non-negative
        if lo < 0.0 or (gates["resample_apply"] and hi > 1.0):
            raise RuntimeError(f"sample {b}: image range [{lo}, {hi}]")
        if not out_labels <= in_labels:
            raise RuntimeError(f"sample {b}: labels {out_labels - in_labels} not in the input")

    # replay one sample (same seed -> same parameters and fields), preferably
    # one whose warp and resample gates are on, and run it through the port
    # on the CPU
    on = (p.deform_apply & p.resample_apply).nonzero()
    b = int(on[0, 0]) if len(on) else 0
    gens = tpipe.make_generators(sample_seeds[b : b + 1], dev)
    pb = sample_params(gens, cfg)
    fb = tpipe.draw_fields(gens, cfg, dev)
    for k, v in pb.items():
        if not torch.equal(v, getattr(p, k)[b : b + 1]):
            raise RuntimeError(f"replayed parameter {k} differs")
    t0 = time.perf_counter()
    out_cpu, seg_cpu, _ = tpipe.synth_core(
        pb.to("cpu"), fb.to("cpu"), seeds[b : b + 1].cpu(), segs[b : b + 1].cpu(), cfg
    )
    cpu_s = time.perf_counter() - t0
    diff = (out[b].cpu() - out_cpu[0]).abs()
    img_err = float(diff.max())
    worst = np.unravel_index(int(diff.argmax()), SHAPE)
    mism = (seg[b].cpu() != seg_cpu[0]).nonzero()
    frac = mism.shape[0] / float(np.prod(SHAPE))
    log(
        f"GPU vs CPU port, sample {b} ({cpu_s:.1f} s on the CPU): image max|d|={img_err:.3e} at "
        f"{tuple(int(i) for i in worst)} (bar {IMAGE_TOL}), label mismatch fraction={frac:.3e} "
        f"({mism.shape[0]} voxels, first at {mism[:8].tolist()}) (bar {LABEL_TOL})"
    )
    if not img_err <= IMAGE_TOL or frac > LABEL_TOL:
        raise RuntimeError("GPU and CPU paths of the port disagree beyond the bars")
    return launches, seeds, segs


def time_slice(dev, cfg, seeds, segs):
    """Phase 5: throughput, peak memory, single-volume latency."""
    iters = 24
    for i in range(2):
        tpipe.synth_batch(seeds, segs, cfg, [100 + BATCH * i + b for b in range(BATCH)], dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        tpipe.synth_batch(seeds, segs, cfg, [1000 + BATCH * i + b for b in range(BATCH)], dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    vols = BATCH * iters / dt

    rounds, enqueue = [], []
    for r in range(3):
        lats = []
        for i in range(2 + 15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tpipe.synth_sample(seeds[0], segs[0], cfg, 5000 + 100 * r + i, dev)
            t_host = time.perf_counter() - t0
            torch.cuda.synchronize()
            if i >= 2:
                lats.append(time.perf_counter() - t0)
                enqueue.append(t_host)
        rounds.append(statistics.median(lats))
        log(f"latency round {r}: p50 {rounds[-1] * 1e3:.3f} ms, min {min(lats) * 1e3:.3f} ms, "
            f"max {max(lats) * 1e3:.3f} ms over 15 draws")
    log(json.dumps({
        "metric": "randomized 256^3 volumes/sec",
        "value": vols,
        "unit": "vol/s",
        "batch": BATCH,
        "iters": iters,
        "latency_p50_s": statistics.median(rounds),
        "latency_p50_rounds_s": rounds,
        "latency_host_enqueue_p50_s": statistics.median(enqueue),
        "peak_mem_bytes": peak,
    }))


def where_time_goes(dev, cfg, seeds, segs):
    """Phase 6: device time per stage (CUDA events between the stages of
    ``synth_core``), then the operators and kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("sample_params", "draw_fields", "intensity_stage", "deform_stage", "gamma_stage",
             "bias_stage", "resample_noise_stage")
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)] for _ in range(10)]
    torch.cuda.synchronize()
    for i, ev in enumerate(events):
        ev[0].record()
        gens = tpipe.make_generators([7000 + BATCH * i + b for b in range(BATCH)], dev)
        p = sample_params(gens, cfg)
        ev[1].record()
        f = tpipe.draw_fields(gens, cfg, dev)
        ev[2].record()
        out = tpipe.intensity_stage(seeds, p, f.intensity)
        ev[3].record()
        out, _, _ = tpipe.deform_stage(p, f.nonlin, cfg, out, segs)
        ev[4].record()
        out = tpipe.gamma_stage(out, p)
        ev[5].record()
        out = tpipe.bias_stage(out, p, f.bias, cfg)
        ev[6].record()
        tpipe.resample_noise_stage(out, p, f.noise, cfg)
        ev[7].record()
    torch.cuda.synchronize()
    for k, n in enumerate(names):
        ms = statistics.median(ev[k].elapsed_time(ev[k + 1]) for ev in events)
        log(f"stage {n:<22} {ms:8.3f} ms per batch of {BATCH} (median of 10)")
    spans = [ev[0].elapsed_time(ev[-1]) for ev in events]
    log(f"stages together {statistics.median(spans):.3f} ms per batch (median of 10); "
        f"10 batches {events[0][0].elapsed_time(events[-1][-1]):.3f} ms")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            tpipe.synth_batch(seeds, segs, cfg, [8000 + BATCH * i + b for b in range(BATCH)], dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = prof.key_averages()
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    log(f"profiler, 3 batches: kernel time {total_ms:.3f} ms, wall {wall_ms:.3f} ms (profiler on)")
    # operators by the device time of the kernels they launch themselves,
    # then the kernels
    ops = [e for e in stats if e.device_type != DeviceType.CUDA and e.self_device_time_total > 0]
    for title, rows in (("operator", ops), ("kernel", kernels)):
        for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            ms = e.self_device_time_total / 1e3
            log(f"  {title} {100 * ms / total_ms:5.1f}% {ms / 3:8.3f} ms/batch "
                f"{e.count / 3:6.1f} calls/batch  {e.key[:160]}")


def default_artifacts(forced: bool = False) -> dict:
    """``configs/dataset/generator/default.yaml``'s four SR artifacts, built
    with the port's constructors (a CPU test holds them equal to
    ``instantiate`` of the YAML); ``forced`` turns each always on (the
    boundaries: halo and fuzzy)."""
    perlin = dict(perlin_res_list=[1, 2], perlin_octaves_list=[1, 2, 4], perlin_persistence=0.5,
                  perlin_lacunarity=2)
    on = 1.0 if forced else 0.4
    return {
        "blur_cortex": tq.BlurCortex(
            prob=on, cortex_label=2, nblur_min=50, nblur_max=200, sigma_gamma_loc=3,
            sigma_gamma_scale=1, std_blur_shape=2, std_blur_scale=1,
        ),
        "struct_noise": tq.StructNoise(
            prob=on, wm_label=3, std_min=0.2, std_max=0.4, nstages_min=1, nstages_max=5,
            merge_params=tq.StructNoiseMergeParams(
                merge_type="perlin", gauss_nloc_min=5, gauss_nloc_max=15, gauss_sigma_mu=25,
                gauss_sigma_std=5, perlin_increase_size=0.1, **perlin,
            ),
        ),
        "simulate_motion": sc.SimulateMotion(
            prob=on,
            scanner_params=sc.ScannerParams(
                resolution_slice_fac_min=0.5, resolution_slice_fac_max=2, resolution_slice_max=1.5,
                slice_thickness_min=1.5, slice_thickness_max=3.5, gap_min=1.5, gap_max=5.5,
                min_num_stack=2, max_num_stack=6, max_num_slices=250, noise_sigma_min=0,
                noise_sigma_max=0.1, TR_min=1, TR_max=2, prob_gamma=0.1, gamma_std=0.05,
                prob_void=0.2, slice_size=None, restrict_transform=False, txy=3.0,
            ),
            recon_params=sc.ReconParams(
                prob_misreg_slice=0.1, slices_misreg_ratio=0.1, prob_misreg_stack=0.1, txy=3.0,
                prob_merge=1.0, prob_smooth=0.2, prob_rm_slices=0.3, rm_slices_min=0.1,
                rm_slices_max=0.4,
                merge_params=tq.ReconMergeParams(
                    merge_type="perlin", gauss_ngaussians_min=2, gauss_ngaussians_max=4,
                    perlin_increase_size=0.25, **perlin,
                ),
            ),
        ),
        "boundaries": tq.SimulatedBoundaries(
            prob_no_mask=0.0 if forced else 0.5, prob_if_mask_halo=1.0 if forced else 0.5,
            prob_if_mask_fuzzy=1.0 if forced else 0.5,
        ),
    }


def api_generator(device, nonlinear_transform=True, seed=0, artifacts=None):
    """``configs/dataset/generator/default.yaml``'s generator, built with the
    port's constructors (a CPU test holds it equal to ``instantiate`` of the
    YAML), with the SR artifacts of ``artifacts`` (a dict) or none."""
    return FetalSynthGen(
        shape=SHAPE,
        resolution=(0.5, 0.5, 0.5),
        intensity_generator=ImageFromSeeds(
            min_subclusters=1, max_subclusters=6, seed_labels=LABELS, generation_classes=GEN_CLASSES
        ),
        spatial_deform=SpatialDeformation(
            max_rotation=20, max_shear=0.02, max_scaling=0.1, size=SHAPE, prob=0.9,
            nonlinear_transform=nonlinear_transform, nonlin_scale_min=0.03,
            nonlin_scale_max=0.06, nonlin_std_max=4, flip_prb=0.5,
        ),
        resampler=RandResample(prob=0.9, min_resolution=0.5, max_resolution=1.5),
        bias_field=RandBiasField(prob=0.9, scale_min=0.004, scale_max=0.02, std_min=0.01, std_max=0.3),
        noise=RandNoise(prob=0.9, std_min=5, std_max=15),
        gamma=RandGamma(prob=0.9, gamma_std=0.1),
        device=device,
        seed=seed,
        **(artifacts or {}),
    )


# name -> (dataset keyword arguments, nonlinear_transform, expected launches
# per sample): synth_train.yaml's seed path, real_train.yaml's image as
# intensity with the co-deformed T2w, and that without the nonlinear field
API_CONFIGS = {
    "synth_train": (dict(seed_path=str(DATA / "derivatives" / "seeds")), True, dict(hat_pass_pair=3)),
    "real_train": (dict(load_image=True, image_as_intensity=True), True, dict(hat_pass_pair=3, hat_pass=6)),
    "real_train_affine": (dict(load_image=True, image_as_intensity=True), False, dict(hat_pass=15)),
}


def api_path(dev, name):
    """Phase 7 for one configuration: check, replay, CPU comparison, timing.
    Returns the kernels' launch counts of the checked sample."""
    ds_kwargs, nonlinear, expected = API_CONFIGS[name]
    gen = api_generator(dev, nonlinear)
    ds = FetalSynthDataset(str(DATA), gen, **ds_kwargs)
    seg_in = nifti.load_ras(ds.segm_paths[0]).data
    in_labels = set(np.unique(seg_in).tolist())

    torch.cuda.synchronize()
    reset_counts()
    item = ds.sample_with_meta(0)
    launches = dict(hat.LAUNCHES)
    gp = item["generation_params"]
    img, lab = item["image"], item["label"]
    log(f"api {name}: launches {launches}, seed {gp['seed']}, image {img.shape} {img.dtype} "
        f"[{img.min():.6f}, {img.max():.6f}], labels {sorted(np.unique(lab).tolist())}, "
        f"gates deform={gp['deform_params']['deform_apply']} "
        f"resample={gp['resample_params']['spacing'] is not None}")
    if launches != counts(**expected):
        raise RuntimeError(f"api {name}: expected launches {expected}, got {launches}")
    if img.shape != (1, *SHAPE) or img.dtype != np.float32 or not np.isfinite(img).all():
        raise RuntimeError(f"api {name}: bad image {img.shape} {img.dtype}")
    if img.min() < 0.0 or img.max() > 1.0:
        raise RuntimeError(f"api {name}: image outside [0, 1]")
    if not set(np.unique(lab).tolist()) <= in_labels:
        raise RuntimeError(f"api {name}: labels outside the input's {sorted(in_labels)}")

    again = ds.sample_with_meta(0, genparams=gp)
    if not (np.array_equal(again["image"], img) and np.array_equal(again["label"], lab)):
        raise RuntimeError(f"api {name}: replay from the genparams is not bit-identical")

    # the same sample through the port on the CPU: the card's parameters and
    # fields (torch's CUDA and CPU generators differ), the CPU's plain paths
    image = nifti.load_ras(ds.img_paths[0]).data if ds.load_image else None
    seeds = None if ds.image_as_intensity else ds.seed_paths[ds._sub_ses_idx(0)]
    inputs, _, _ = gen.prepare(image, seg_in, seeds, genparams=gp)
    p_dev = inputs["p"]
    inputs = {k: (v.to("cpu") if v is not None else None) for k, v in inputs.items()}
    t0 = time.perf_counter()
    out_cpu, seg_cpu, _ = tpipe.synth_core(**inputs, cfg=gen.cfg)
    cpu_s = time.perf_counter() - t0
    out_cpu = scale_intensity(out_cpu[0].numpy(), 0.0, 1.0)
    img_err = float(np.abs(out_cpu - img[0]).max())
    mism = np.argwhere(seg_cpu[0].numpy() != lab[0])
    frac = len(mism) / float(np.prod(SHAPE))
    # the affine each device computes from the same parameters
    p_cpu = inputs["p"]
    d_affine = float((make_affine_matrix(p_dev.rotations, p_dev.shears, p_dev.scalings).cpu()
                      - make_affine_matrix(p_cpu.rotations, p_cpu.shears, p_cpu.scalings)).abs().max())
    log(f"api {name}: GPU vs CPU port ({cpu_s:.1f} s on the CPU): image max|d|={img_err:.3e} "
        f"(bar {IMAGE_TOL}), label mismatch fraction={frac:.3e} (bar {LABEL_TOL}), "
        f"first at {mism[:4].tolist()}; max|A_gpu - A_cpu|={d_affine:.3e}")
    if not img_err <= IMAGE_TOL or frac > LABEL_TOL:
        raise RuntimeError(f"api {name}: GPU and CPU paths of the port disagree beyond the bars")

    # samples/s of ds[0], then the same draw split into its steps
    for _ in range(2):
        ds[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    n = 10
    draws = []
    for _ in range(n):
        t0 = time.perf_counter()
        ds[0]
        draws.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    # the steps of ds.sample, each timed: NIfTI decode; prepare (the host
    # seed selection and sum, the uploads, the parameter and field draws);
    # synth_core (host wall and CUDA events); the genparams, download and
    # scaling of the output, the co-deformed image and the labels
    split = {"load_s": [], "prepare_s": [], "core_host_s": [], "core_events_ms": [],
             "download_scale_s": [], "total_s": []}
    for _ in range(n):
        t0 = time.perf_counter()
        seg_np = nifti.load_ras(ds.segm_paths[0]).data
        img_np = nifti.load_ras(ds.img_paths[0]).data if ds.load_image else None
        t1 = time.perf_counter()
        inputs, _, _ = gen.prepare(img_np, seg_np, seeds)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, seg, img_out = tpipe.synth_core(**inputs, cfg=gen.cfg)
        end.record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        genparams_to_dict(inputs["p"])
        for v in (out, img_out):
            if v is not None:
                scale_intensity(v[0].cpu().numpy(), 0.0, 1.0)[None].astype(np.float32)
        seg[0].cpu().numpy()[None].astype(np.int64)
        t4 = time.perf_counter()
        steps = (t1 - t0, t2 - t1, t3 - t2, start.elapsed_time(end), t4 - t3, t4 - t0)
        for k, v in zip(split, steps):
            split[k].append(v)
    log(json.dumps({
        "api": name,
        "samples_per_s": n / sum(draws),
        "draws": n,
        "draw_s_median": statistics.median(draws),
        "draw_s_max": max(draws),
        "peak_mem_bytes": peak,
        **{f"{k}_median": statistics.median(v) for k, v in split.items()},
    }))
    return launches


def synth_train_sample(dev, seed=5):
    """One 256^3 ``synth_train`` sample on the card (generator without the
    artifacts): (image (D, H, W), labels (D, H, W)) tensors."""
    gen = api_generator(dev, seed=seed)
    ds = FetalSynthDataset(str(DATA), gen, seed_path=str(DATA / "derivatives" / "seeds"))
    seg_np = nifti.load_ras(ds.segm_paths[0]).data
    out, seg, _, _ = gen.sample(None, seg_np, ds.seed_paths[ds._sub_ses_idx(0)])
    return out, seg


def motion_parts(motion, out, seg, genparams):
    """``motion``'s scan and reconstruction as ``SimulateMotion`` runs them,
    from ``genparams`` with ``rng_seed`` and ``device_seed``: (volume, the
    accepted stacks' validity flags, the accumulated value and weight before
    the equalization, the reconstructor's draws)."""
    sp = sc.ScannerParams(**{**motion.scanner_args.__dict__, "resolution_recon": 0.5})
    data = {"resolution": 0.5, "volume": out, "mask": (seg > 0).float(), "seg": seg.float()}
    rng = np.random.default_rng(genparams["rng_seed"])
    d = sc.Scanner(sp, motion.tiers, motion.ns_grid).scan(data, genparams, rng=rng,
                                                          device_seed=genparams["device_seed"])
    recon = sc.PSFReconstructor(motion.recon_args)
    acc = {}
    finalize = sc._finalize

    def capture(value, weight, *rest):
        acc.update(value=value, weight=weight)
        return finalize(value, weight, *rest)

    sc._finalize = capture
    try:
        o, _ = recon.recon_psf(d, genparams, rng=rng)
    finally:
        sc._finalize = finalize
    return o, [st["valid"] for st in d["stacks"]], acc["value"], acc["weight"], recon.get_seeds()


@contextlib.contextmanager
def phase_events(events: dict):
    """Record CUDA events around each ``Scanner.scan`` (``events["acquire"]``)
    and ``PSFReconstructor.recon_psf`` (``events["recon"]``) call."""
    originals = {}
    for cls, name, key in ((sc.Scanner, "scan", "acquire"), (sc.PSFReconstructor, "recon_psf", "recon")):
        originals[cls, name] = orig = getattr(cls, name)

        def timed(self, *args, _orig=orig, _key=key, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            result = _orig(self, *args, **kw)
            end.record()
            events[_key] = (start, end)
            return result

        setattr(cls, name, timed)
    try:
        yield
    finally:
        for (cls, name), orig in originals.items():
            setattr(cls, name, orig)


def profile_motion(motion, out, seg):
    """Where the time of one motion call at the first tier goes: the kernels
    with the most device time (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        motion(out, seg, genparams={"resolution_slice": MOTION_TIERS[0][1]}, rng=np.random.default_rng(1), seed=1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    log(f"profiler, one motion call at the {MOTION_TIERS[0][0]} tier: kernel time {busy_ms:.3f} ms, "
        f"wall {wall_ms:.3f} ms (profiler on)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        ms = e.self_device_time_total / 1e3
        log(f"  kernel {100 * ms / busy_ms:5.1f}% {ms:9.3f} ms {e.count:5d} calls  {e.key[:150]}")


def scanner_phase(dev, t_start):
    """Phase 8: the motion artifact at each cube tier, then the card against
    the port's CPU path. Returns the launch counts of the tier calls."""
    out, seg = synth_train_sample(dev)
    motion = default_artifacts(forced=True)["simulate_motion"]
    total = counts()
    for cube, res_s in MOTION_TIERS:
        if sc.slice_grid(SHAPE, res_s / 0.5) != cube:
            raise RuntimeError(f"resolution_slice {res_s} does not select the {cube} tier")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        events = {}
        t0 = time.perf_counter()
        with phase_events(events):
            o, meta = motion(out, seg, genparams={"resolution_slice": res_s}, rng=np.random.default_rng(cube),
                             seed=cube)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = dict(hat.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        (a0, a1), (r0, r1) = events["acquire"], events["recon"]
        row = {
            "motion_tier": cube, "resolution_slice": res_s, "acquire_events_ms": a0.elapsed_time(a1),
            "recon_events_ms": r0.elapsed_time(r1), "host_ms": 1e3 * host_s,
            "launches": {k: v for k, v in launches.items() if v}, "nstacks": meta["nstacks"],
            "total_slices": meta["total_slices"], "peak_mem_bytes": peak,
        }
        if tuple(o.shape) != SHAPE or not bool(torch.isfinite(o).all()) or meta["nstacks"] < 1:
            raise RuntimeError(f"motion tier {cube}: bad output {tuple(o.shape)} or no stack ({meta})")
        if not (launches["hat_pass_pair_lane"] and launches["hat_pass_pair_slice"] and launches["hat_pass_slice"]):
            raise RuntimeError(f"motion tier {cube}: a scanner kernel form was not launched: {launches}")
        for k, v in launches.items():
            total[k] += v
        again, _ = motion(out, seg, genparams=meta)
        row["replay_bit_identical"] = bool(torch.equal(again, o))
        log(json.dumps(row))
        if not row["replay_bit_identical"]:
            raise RuntimeError(f"motion tier {cube}: replay from the metadata differs")
        del o, again
    log(f"phase 8 tiers done at {time.perf_counter() - t_start:.1f} s")
    profile_motion(motion, out, seg)

    # the card against the port's CPU path, device noise off
    case = scanner_ab_case(128, 32)
    gpu, cpu = run_scanner_ab(case, 128, 32, device=dev), run_scanner_ab(case, 128, 32, device="cpu")
    errs = [float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30)) for g, c in zip(gpu, cpu)]
    flags = bool(np.array_equal(gpu[1], cpu[1]))
    log(f"scanner_ab_case cube 128 GPU vs CPU: relative max|d| slices {errs[0]:.3e} value {errs[2]:.3e} "
        f"weight {errs[3]:.3e} (bar {SCANNER_TOL}), validity flags equal {flags}")
    if not flags or max(errs) > SCANNER_TOL:
        raise RuntimeError("scanner_ab_case: GPU and CPU paths disagree")
    quiet = default_artifacts(forced=True)["simulate_motion"]
    quiet.scanner_args = sc.ScannerParams(**{**quiet.scanner_args.__dict__, "noise_sigma_max": 0.0,
                                             "prob_void": 0.0, "min_num_stack": 2, "max_num_stack": 2})
    quiet.recon_args = sc.ReconParams(**{**quiet.recon_args.__dict__, "prob_merge": 0.0})
    gp = {"rng_seed": 11, "device_seed": 11, "resolution_slice": MOTION_TIERS[0][1]}
    g_out, g_valid, g_val, g_w, g_seeds = motion_parts(quiet, out, seg, gp)
    t0 = time.perf_counter()
    c_out, c_valid, c_val, c_w, c_seeds = motion_parts(quiet, out.cpu(), seg.cpu(), gp)
    cpu_s = time.perf_counter() - t0
    flags = len(g_valid) == len(c_valid) and all(np.array_equal(a, b) for a, b in zip(g_valid, c_valid))
    errs = {k: float((g.cpu() - c).abs().max() / c.abs().max())
            for k, g, c in (("value", g_val, c_val), ("weight", g_w, c_w), ("volume", g_out, c_out))}
    # the equalization divides by the weight where it exceeds 1e-2: a voxel
    # whose weight lies within rounding of that threshold flips between the
    # devices; the comparison of the volume leaves those voxels (and, with the
    # box smooth on, their 3^3 neighbourhoods) out and counts them
    g_w, g_out = g_w.cpu(), g_out.cpu()
    flips = (g_w > 1e-2) != (c_w > 1e-2)
    if c_seeds["smooth_volume_on"]:
        flips = box_sum(flips, 3) > 0
    rest = float(torch.where(flips, 0.0, (g_out - c_out).abs()).max() / c_out.abs().max())
    worst = np.unravel_index(int((g_out - c_out).abs().argmax()), g_out.shape)
    log(f"motion at the {MOTION_TIERS[0][0]} tier GPU vs CPU ({cpu_s:.1f} s on the CPU): {len(g_valid)} stacks, "
        f"validity flags equal {flags}, relative max|d| value {errs['value']:.3e} weight {errs['weight']:.3e} "
        f"volume {errs['volume']:.3e} (at {tuple(int(i) for i in worst)}, weight there GPU "
        f"{float(g_w[worst]):.9g} CPU {float(c_w[worst]):.9g}); threshold flips "
        f"{int(((g_w > 1e-2) != (c_w > 1e-2)).sum())} voxels, volume elsewhere {rest:.3e} (bar {SCANNER_TOL}); "
        f"reconstructor draws {json.dumps(c_seeds)}")
    if not flags or g_seeds != c_seeds or not max(errs["value"], errs["weight"], rest) <= SCANNER_TOL:
        raise RuntimeError("motion: GPU and CPU paths disagree")
    return total


class Timed:
    """An artifact whose calls are timed with CUDA events; each span records
    whether the artifact changed the volume (its gate fired)."""

    def __init__(self, artifact):
        self.artifact = artifact
        self.spans = []

    def __call__(self, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, meta = self.artifact(*args, **kw)
        end.record()
        fired = bool(meta) and meta.get("nblur", 0) is not None and not meta.get("no_mask_on", False)
        self.spans.append((start, end, fired))
        return out, meta


def api_artifacts_phase(dev, forced: bool):
    """Phase 9: ``synth_train.yaml`` as it is (or with every artifact forced
    on) through ``FetalSynthDataset``. Returns the checked sample's launches."""
    name = "synth_train_artifacts_forced" if forced else "synth_train_artifacts"
    timed = {k: Timed(a) for k, a in default_artifacts(forced).items()}
    gen = api_generator(dev, seed=9, artifacts=timed)
    ds = FetalSynthDataset(str(DATA), gen, seed_path=str(DATA / "derivatives" / "seeds"))
    torch.cuda.synchronize()
    reset_counts()
    item = ds.sample_with_meta(0)
    launches = dict(hat.LAUNCHES)
    gp = item["generation_params"]
    img = item["image"]
    log(f"api {name}: launches {launches}, artifacts {json.dumps(gp['artifacts'])[:600]}")
    if img.shape != (1, *SHAPE) or not np.isfinite(img).all() or img.min() < 0.0 or img.max() > 1.0:
        raise RuntimeError(f"api {name}: bad image {img.shape} [{img.min()}, {img.max()}]")
    if forced and not (launches["hat_pass_pair_lane"] and launches["hat_pass_slice"]):
        raise RuntimeError(f"api {name}: the motion artifact's kernels were not launched: {launches}")
    again = ds.sample_with_meta(0, genparams=gp)
    if not (np.array_equal(again["image"], img) and np.array_equal(again["label"], item["label"])):
        raise RuntimeError(f"api {name}: replay from the genparams is not bit-identical")
    for _ in range(2):
        ds[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for t in timed.values():
        t.spans.clear()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        ds[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_artifact = {}
    for k, t in timed.items():
        fired = [a.elapsed_time(b) for a, b, f in t.spans if f]
        per_artifact[k] = {"fired": len(fired), "events_ms_median": statistics.median(fired) if fired else None,
                           "events_ms_max": max(fired) if fired else None}
    log(json.dumps({"api": name, "samples_per_s": n / dt, "draws": n, "replay_bit_identical": True,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "artifacts": per_artifact}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    libs = build.build()
    log(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t_start:.2f} s")

    cfg = bench_cfg()
    checks = check_kernel(dev, cfg) + check_single_kernel(dev, cfg)
    checks += check_scanner_kernels(dev)
    checks += check_new_hat_forms(dev)
    check_hat_tiles(dev)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    seeds_np, seg_np = phantom_seeds_and_seg(SHAPE)
    launches, seeds, segs = run_slice(dev, cfg, seeds_np, seg_np)
    time_slice(dev, cfg, seeds, segs)
    where_time_goes(dev, cfg, seeds, segs)
    del seeds, segs
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    for name in API_CONFIGS:
        for k, v in api_path(dev, name).items():
            launches[k] += v
        log(f"api {name} done at {time.perf_counter() - t_start:.1f} s")
    for k, v in scanner_phase(dev, t_start).items():
        launches[k] += v
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
    for forced in (False, True):
        for k, v in api_artifacts_phase(dev, forced).items():
            launches[k] += v
        log(f"phase 9 ({'forced' if forced else 'yaml'}) done at {time.perf_counter() - t_start:.1f} s")
    for k, v in probe_path().items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 10 path done at {time.perf_counter() - t_start:.1f} s")
    checks += check_probes(dev)
    check_probe_tiles(dev)
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
    missing = [k for k in KERNELS if not launches.get(k)]
    if missing:
        raise RuntimeError(f"kernel forms never launched on the main paths: {missing}")

    entries = []
    for key, (source, replaces) in KERNELS.items():
        rs = [r for r in checks if r["key"] == key]
        # the times and bound of one check, the median by kernel time: the
        # checks of a form may differ in shape
        mid = sorted(rs, key=lambda r: r["ms"])[len(rs) // 2]
        entries.append({
            "name": key,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": mid["ms"],
            "plain_ms": mid["plain_ms"],
            "bound_ms": mid["bound_ms"],
            "bound_by": mid["bound_by"],
            "library_ms": mid["library_ms"],
        })
    log(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
