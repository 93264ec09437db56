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
   half-integer and out-of-range positions mixed in; every K1 and K2 form
   bit-identical; times as the median of 20 CUDA-event runs;
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

11. the artifact-free input stream (``SyntheticStream``, B=4 256^3) on two
    trees: A, two phantom subjects written as ``bench.py --stream`` writes
    them, with phase 5's generator config; B, ``data/sub-sta21`` with phase
    7's ``synth_train`` generator. Each with prefetch on and off: vol/s over
    24 batches after 2 warm-ups (the host clock around a read of each
    batch) beside phase 5's core vol/s, the first seed bank's build (its
    ``bank.*`` spans: native decode, ``to_ras``, pinning, the copy's card
    time) and reader, peak
    memory, K1's launches (3 a batch generated); prefetch on and off
    bit-identical (every batch's digests), a recorded batch replayed bit for
    bit on the same stream and a fresh one, ``compose_seeds`` on the card
    against a host sum, one B=1 batch of tree B against the port's CPU path
    (image within 1e-4, labels 1e-5 of voxels); on tree A, each batch's host
    enqueue against its CUDA-event time and a profiler trace with prefetch
    on (kernel time against the host clock).

12. the input stream with the SR artifacts (``SyntheticStream``, B=4
    256^3) on ``data/sub-sta21`` with ``synth_train.yaml``'s generator, its
    four artifacts at the YAML's probabilities: vol/s with prefetch on and
    off over 24 batches after 2 warm-ups, beside phase 9's API samples/s
    with the artifacts and phase 11's artifact-free stream, the host's
    ``pack_motion`` ms a batch, the share of samples per motion engine
    (small / 384 / 512 / 640 / off) and the stacks accepted; prefetch on and
    off bit-identical, replay bit-identical on the same and a fresh stream.
    Then one B=4 batch with every artifact forced on, and one B=1 batch per
    engine through ``resolution_slice`` pins (0.7 / 0.5 / 0.35 / 0.25 mm),
    each with the dz-split and the coarse weight as they default, and with
    each turned off: per-artifact card time (``chain.*`` spans), K1/K2
    launches per form, peak
    memory; each replayed with every K1/K2 launch held against its plain
    version on the same inputs (bit-identical). One forced batch under sync
    debug mode "error" (the chain lifts it around its one planned read of the
    validity flags); one B=1 forced batch on the card against the port's CPU
    path (the core's labels within phase 11's bar; the chain on the CPU from
    the card's core output with the card's recorded draws: the same validity
    flags, within 1e-4 of its scale outside the voxels whose recon weight
    crosses 1e-2 or whose boundaries mask differs between the two, their
    share at most 1e-3). Each K1/K2 form at each
    shape the stream gave it is then timed against its plain version, its
    bound and ``grid_sample``: the kernel entries ``stream:<form>``.

13. the segmentation trainer (``fetalsyngen_torch.train``): the default
    ``UNet3D`` (channels 16, 32, 64; 8 classes; bf16 compute) on phase 5's
    generator config at 256^3, B=1: 2 warm-up and 20 timed
    ``generate_and_train_step``s, steps/s and vol/s from the host clock
    around a read of each loss, each step's generation against the UNet's
    forward + backward + update (CUDA events), peak memory, K1's launches
    (3 a step); every loss finite and the last third's mean below the
    first's; each timed step's generation replayed bit for bit; one step's
    generation replayed with every K1 launch held against its plain
    version, then K1 at that shape timed (the kernel entry
    ``train:hat_pass_pair``); one step through ``make_sharded_train_step``
    under an NCCL group of world size 1 against the plain step (loss within
    1e-5 relative, gradients within 1e-5 of each leaf's max |g|, each
    weight AdamW's step of its gradient within 1e-6); one step at 64^3 of the f32 model on the card and on the
    CPU from the same weights and batch, TF32 off (loss within 1e-4
    relative, each gradient within 1e-3 of its leaf's max |g|); the kernels
    of two steps by device time (``torch.profiler``).

14. the seed-preparation path (``fetalsyngen_torch.scripts``) on a copy of
    ``data/sub-sta21`` (256^3 at 0.5 mm) in a temporary directory:
    ``resample`` (host seconds; its output at 256^3 with a 0.5 mm diagonal
    affine); ``generate_seeds --annotation feta --max_subclasses 6`` with
    its mixtures' EM on the card (wall seconds, each fit's CUDA-event ms and
    EM iterations per init, the host seconds of the k-means++ picks, peak
    device memory), its 24 int8 files each within its meta-label's labels,
    ``subclasses_1`` against the committed tree (meta-labels 2 and 3 equal;
    1 and 4 differing on exactly segmentation label 4's voxels, which the
    committed tree puts in the skull class), subclasses 2-6's agreement with
    the committed (unseeded) fits after ranking components by mean (a
    report); meta-label 2 at k = 6 from one ``random_state`` on the card
    against the port's CPU path (the same k-means++ indices and winning
    init, means within 1e-4 relative, labels differing on at most 1e-4 of
    the values); ``resize_seeds`` over the tree (voxels and headers
    unchanged); ``FetalSynthDataset`` from ``synth_train.yaml`` (PyYAML)
    less its SR artifacts on the fresh tree (3 K1 launches a draw, the image
    in [0, 1], replay bit-identical); the walkthrough
    (``fetalsyngen_torch.examples.generator``) at 64^3 on the card.

15. the separable-warp surface (``ops.warp``): at B=4 256^3 in f32 and
    under ``storage_scope(bf16)``, ``warp_affine_separable`` of an image and
    its labels onto a (240, 256, 272) grid (its U passes write fewer and more
    lanes than they read), ``warp_affine_separable_pair`` in the four pairs
    of modes onto that grid, ``warp_displacement_separable`` of each on a
    smooth field whose peaks pass +-FIELD_LIM, and ``ops.warp.hat_pass_pair``
    with a 384-cube stack's per-slice table on bf16 rows: every launch count
    exact, outputs finite and of their shapes; each op on a 64^3 crop on the
    card against the port's CPU path (images within IMAGE_TOL of their scale,
    bf16 BF16_ULPS ulps; labels within LABEL_TOL); then each K1/K2 form it
    launched at its 256^3 passes against its plain version (bit-identical,
    distinct operands for a pair), timed with its bound and ``grid_sample``:
    the kernel entries ``separable:<form>``.

16. the row-affine pair pass (``kernels.row_affine``, the pair warp's U
    passes and L21 peel): at B=16 256^3 in the production mode, each of the
    five passes on its own inputs (the chain's outputs; the L-z peel on a
    transposed view as it reads the hat pass's output) against its plain
    version, the banded-operator einsum the pass ran before: labels
    bit-identical, the image within one bf16 ulp; kernel, fenced, bound
    and plain ms; one ``warp_affine_field_pair_pre`` call's launches (5);
    then the f32 and the precision scope's forms at B=2 against theirs.
    Its launches are counted where the main paths run it, five a pair warp
    in the mode's form (phases 4, 7, 11–14); the ``kernels`` line sums
    those, its ``max_abs_err`` is the image's absolute difference and
    ``max_bf16_ulps`` the same in bf16 ulps. Then the small-field pair
    warp's mask kernels (``kernels.deform_mask``) at B=16 256^3 on the
    generator's draws against the zoom-based composition (shift identical,
    mask on all but 1e-6 of the voxels, image equal where the masks agree),
    each timed (one call, fenced) against its bound and the composition;
    the ``kernels`` line gives each its output's largest absolute difference
    from the composition's over every voxel, and ``mask_apply`` the count
    of mask decisions apart;
    one launch of each a small-field pair warp on the main paths (phases 4,
    7's ``synth_train``, 11–14), counted with the row-affine pass.

Phase 3 also holds K1's form without a displacement (the probes'
``pair_l_nodisp`` and ``pair_u`` coefficients, and crafted half-integers)
and K2's lane-affine form (K7's inputs, and a wide table at 256^3) against
their plain versions. Every kernel check (phases 3 and 10) also prints the
kernel's time behind an enqueued wait ("fenced": the card's own time, no
host wait), its share of the bound, and the host wait, one launch's time
less the fenced one. Then, untimed, every K2 form bit for bit (the sign of
zero included) at one shape whose tiles span two samples and two slices and
end partial, and every K1 form there, at an odd S above 3630, at OW != S,
on operands 4 and 12 bytes off 16 and (its main form) at B=1 256^3, with
each form's launch geometry (tile rows, ring stages, grid, shared memory).

The stream's bf16 production mode (its default) and the f32
mode (``FSG_STREAM_BF16=0``) both run in one call: phase 3 also holds the
bf16 forms of K1 (main form, B=4 256^3) and K2 (per-sample without a
displacement) bit for bit, with bounds for bf16 rows and ``grid_sample`` on
bf16 inputs; phase 4b runs ``synth_batch`` in the production mode (three
K1 bf16 launches, host syncs made errors, replay bit-identical) against the
f32 mode at the JAX package's bars (labels within LABEL_TOL, correlation >
0.995, relative L2 < 3e-2) and the production mode at 64^3 on the card
against the CPU (labels within LABEL_TOL; the image within BF16_ULPS bf16
ulps of its scale, at most BF16_SHARE_MAX of the voxels beyond IMAGE_TOL);
phases 5 and 6 time and trace the core in each mode; phases 11 and 12 drive
the streams in the production mode (every check as before) and again in
the f32 mode (24 batches, prefetch on), phase 11 also without the nonlinear
field (K2's bf16 per-sample forms), phase 12 its forced and per-engine
batches in both modes (every K1/K2 launch of either dtype held against its
plain version, the stream's bf16 forms timed as ``stream:<form>_bf16``),
its profile in both, and one motion call in the production mode against
the f32 mode (relative L2 < 2e-2, correlation > 0.999); the card-against-CPU
checks of phases 11 and 12 run in the f32 mode, whose bars they are.

Each phase prints its elapsed time. The line before the last is the
kernels' JSON record, one entry per kernel form and probe mode; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from fetalsyngen_torch import trace
from fetalsyngen_torch.data.datasets import FetalSynthDataset
from fetalsyngen_torch.data.transforms import scale_intensity
from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.generator.artifacts import batched as tba
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
from fetalsyngen_torch.io import native, nifti
from fetalsyngen_torch.kernels import build, deform_mask, hat, probes, row_affine
from fetalsyngen_torch.ops.affine import make_affine_matrix
from fetalsyngen_torch.ops.morphology import box_sum
from fetalsyngen_torch.ops.numerics import device_const
from fetalsyngen_torch.ops import linops, warp
from fetalsyngen_torch.ops.warp import FIELD_LIM, ul_decompose
from fetalsyngen_torch.parallel.input_pipeline import (
    BANK_COUNTS, SyntheticStream, _production_scopes, batch_program, compose_seeds,
)
from fetalsyngen_torch.probes import microbench_warp, probe_blocktp, profile_kernel_variants, ring_profile
from fetalsyngen_torch.probes.timing import bound, hat_bound
from fetalsyngen_torch.scripts import generate_seeds, gmm, resample, resize_seeds
from fetalsyngen_torch.testing import phantom_seeds_and_seg, run_scanner_ab, scanner_ab_case
from fetalsyngen_torch.train import step as tstep
from fetalsyngen_torch.train.unet import UNet3D

REPO = Path(__file__).resolve().parent
DATA = REPO / "data"
SHAPE = (256, 256, 256)
BATCH = 4
LABELS = tuple([0] + list(range(10, 50)))
GEN_CLASSES = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
IMAGE_TOL = 1e-4  # |GPU - CPU| on the [0, 1] image
LABEL_TOL = 1e-5  # fraction of labels allowed to differ between GPU and CPU
SCANNER_TOL = 1e-4  # |GPU - CPU| of the scanner's outputs over their max |x|
# phase 5's core vol/s and phase 7's samples/s, printed beside phase 11's
MEASURED: dict[str, float] = {}
# the kernels' sources and the TPU kernels they replace, by LAUNCHES key
KERNELS = {
    "hat_pass_pair": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_pair_lane": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_pair_slice": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_pair_nodisp": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    "hat_pass_lane": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    "hat_pass_slice": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    # the bf16 forms (the stream's production mode); the scanner's are
    # checked and counted at the stream's shapes ("stream:<form>", phase 12)
    "hat_pass_pair_bf16": ("fetalsyngen_torch/csrc/hat_pass.cu", "fetalsyngen_tpu/ops/warp.py:1217"),
    "hat_pass_bf16": ("fetalsyngen_torch/csrc/hat_single.cu", "fetalsyngen_tpu/ops/warp.py:150"),
    "pair_copy": ("fetalsyngen_torch/csrc/probes.cu", "scripts/probe_blocktp.py:30"),
    "pair_transpose": ("fetalsyngen_torch/csrc/probes.cu", "scripts/probe_blocktp.py:35"),
    **{f"probe2_{m}": ("fetalsyngen_torch/csrc/probes.cu", "scripts/microbench_warp.py:198")
       for m in probes.PAIR_MODES},
    **{f"probe_{m}": ("fetalsyngen_torch/csrc/probes.cu", "scripts/microbench_warp.py:272")
       for m in probes.SINGLE_MODES},
    **{f"hat_variant_v{v}": ("fetalsyngen_torch/csrc/hat_single.cu", "scripts/profile_kernel_variants.py:35")
       for v in probes.VARIANTS},
    # no Pallas kernel: the JAX package's banded-operator einsum; the f32
    # contract's form and the storage scope's (the precision scope's alone
    # runs on no main path: phase 16 checks it)
    "row_affine_pair_f32": ("fetalsyngen_torch/csrc/row_affine.cu", "none (einsum, fetalsyngen_tpu/ops/warp.py:854)"),
    "row_affine_pair_bf16": ("fetalsyngen_torch/csrc/row_affine.cu", "none (einsum, fetalsyngen_tpu/ops/warp.py:854)"),
    # no Pallas kernel: the JAX package's zooms and elementwise composition
    # of the small-field pair warp's mask and margin shift
    "mask_shift": ("fetalsyngen_torch/csrc/deform_mask.cu",
                   "none (zooms + composition, fetalsyngen_tpu/generator/pipeline.py:199-215)"),
    "mask_apply": ("fetalsyngen_torch/csrc/deform_mask.cu",
                   "none (zooms + composition, fetalsyngen_tpu/generator/pipeline.py:199-230)"),
}


# phase 12: the stream's K1/K2 forms, held and timed at the stream's own
# shapes; their kernel entries are named "stream:<form>"
STREAM_FORMS = ("hat_pass_lane", "hat_pass_slice", "hat_pass_pair_lane", "hat_pass_lane_bf16", "hat_pass_slice_bf16",
                "hat_pass_pair_lane_bf16")
for _form in STREAM_FORMS:
    KERNELS[f"stream:{_form}"] = KERNELS[_form.removesuffix("_bf16")]
# phase 13: K1's main form at the trainer's shape (B=1 256^3)
KERNELS["train:hat_pass_pair"] = KERNELS["hat_pass_pair"]
# (engine, pinned slice resolution in mm) of phase 12's per-engine batches
STREAM_ENGINES = (("small", 0.7), ("384", 0.5), ("512", 0.35), ("640", 0.25))
# every artifact's gate forced on (the motion artifact's by any pin)
FORCED_GATES = {"blur_cortex": {"apply": True}, "struct_noise": {"apply": True}, "boundaries": {"apply": True}}
FLIP_SHARE_MAX = 1e-3  # GPU vs CPU: the share of voxels whose recon weight crosses 1e-2
BF16 = torch.bfloat16
# the stream's two modes: "production" (its default, FSG_STREAM_BF16 unset)
# and "f32" (FSG_STREAM_BF16=0, the rollback); K1's form in each
MODES = ("production", "f32")
K1_FORM = {"production": "hat_pass_pair_bf16", "f32": "hat_pass_pair"}
# the row-affine form the pair warp launches beside each of K1's volume forms
RA_FORM = {"hat_pass_pair": "row_affine_pair_f32", "hat_pass_pair_bf16": "row_affine_pair_bf16"}
# the production mode against the f32 mode on the card: JAX's own bars, the
# core's (tests/test_pipeline.py:108-128) and one motion call's
# (tests/test_batched_artifacts.py:341-371)
CORE_CORR_MIN, CORE_REL_MAX = 0.995, 3e-2
MOTION_CORR_MIN, MOTION_REL_MAX = 0.999, 2e-2
# the production mode on the card against the CPU at 64^3: phase 11's label
# bar; the image's bf16 roundings fall the other way where the card sums in
# another order, so at most BF16_SHARE_MAX of the voxels may differ by more
# than IMAGE_TOL of the scale, none by more than BF16_ULPS bf16 ulps of it
BF16_CPU_SHAPE = (64, 64, 64)
BF16_SHARE_MAX = 1e-3
BF16_ULPS = 2


@contextlib.contextmanager
def stream_mode(mode: str):
    """The stream's ``mode`` for the block: ``FSG_STREAM_BF16`` unset
    (production) or ``0`` (f32); restored after."""
    saved = os.environ.pop("FSG_STREAM_BF16", None)
    if mode == "f32":
        os.environ["FSG_STREAM_BF16"] = "0"
    try:
        yield
    finally:
        os.environ.pop("FSG_STREAM_BF16", None)
        if saved is not None:
            os.environ["FSG_STREAM_BF16"] = saved


@contextlib.contextmanager
def core_mode(mode: str):
    """``synth_core`` in ``mode``: the stream's scopes (``_production_scopes``)
    under :func:`stream_mode`."""
    with stream_mode(mode), _production_scopes():
        yield


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def traced(into: list):
    """The port's spans (``fetalsyngen_torch.trace``) recorded while the
    block runs, drained into ``into`` once the card is done."""
    trace.drain()
    trace.enable()
    try:
        yield into
    finally:
        trace.disable()
        torch.cuda.synchronize()
        into.extend(trace.drain())


def first_bank(spans: list, nbytes: int) -> dict:
    """The first seed bank's build from its ``bank.*`` spans: host seconds of
    its staging set's making or wait (``bank.pin``), decode and ``to_ras``, and its
    upload's card milliseconds (the pin and upload are those of ``nbytes``;
    the decode and ``to_ras`` spans between them on their thread are its
    own, its segmentation's included: a fill builds banks on threads of its
    own at once)."""
    pin = next(r for r in spans if r["name"] == "bank.pin" and r["attrs"]["bytes"] == nbytes)
    upload = next(r for r in spans if r["name"] == "bank.upload" and r["attrs"]["bytes"] == nbytes
                  and r["thread"] == pin["thread"] and r["t0"] >= pin["t1"])

    def host_s(name):
        return sum(r["t1"] - r["t0"] for r in spans if r["name"] == name and r["thread"] == pin["thread"]
                   and pin["t1"] <= r["t0"] and r["t1"] <= upload["t0"])

    return {"decode_s": host_s("bank.decode"), "to_ras_s": host_s("bank.to_ras"), "pin_s": pin["t1"] - pin["t0"],
            "upload_ms": upload["ms"]}


def reset_counts() -> None:
    for d in (hat.LAUNCHES, probes.LAUNCHES, row_affine.LAUNCHES, deform_mask.LAUNCHES):
        for k in d:
            d[k] = 0


def launched() -> dict:
    """The hat kernels', the row-affine pass's and the mask kernels'
    launches by form since :func:`reset_counts`."""
    return {**hat.LAUNCHES, **row_affine.LAUNCHES, **deform_mask.LAUNCHES}


def counts(**nonzero) -> dict:
    """A full :func:`launched` dict: zero but for ``nonzero``."""
    return {**dict.fromkeys(hat.LAUNCHES, 0), **dict.fromkeys(row_affine.LAUNCHES, 0),
            **dict.fromkeys(deform_mask.LAUNCHES, 0), **nonzero}


def pair_warps_per_batch(launches: dict, batches: range, where: str) -> None:
    """Raise unless each batch made one small-field pair warp, for one of
    the batch counts ``batches``: five row-affine launches, all in one
    form, and one ``mask_shift`` and one ``mask_apply``."""
    ra = {k: v for k, v in launches.items() if k in row_affine.LAUNCHES and v}
    warps = sum(ra.values()) // 5
    if len(ra) != 1 or sum(ra.values()) not in [5 * n for n in batches] or any(
            launches[k] != warps for k in deform_mask.LAUNCHES):
        raise RuntimeError(f"{where}: expected {[5 * n for n in batches]} row-affine launches of one form and a fifth "
                           f"of that of each mask kernel, got {ra}, {[launches[k] for k in deform_mask.LAUNCHES]}")


def pair_warps(n: int, k1: str = "hat_pass_pair", mask: bool = True) -> dict:
    """The launches of ``n`` pair warps (``warp_affine_field_pair_pre``)
    whose K1 passes take the form ``k1``: three K1 passes and five
    row-affine passes each, and where ``mask`` (the small-field pair warp
    of the generator's image and labels, margin shift on) one launch of
    each mask kernel."""
    return {k1: 3 * n, RA_FORM[k1]: 5 * n, **({"mask_shift": n, "mask_apply": n} if mask else {})}


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
    grid = torch.stack([x, y[None, :, None].expand(B * D, H, OW)], -1).to(inp.dtype)
    del x
    if inp.dtype == torch.float32:
        return cuda_ms(lambda: F.grid_sample(inp, grid, "bilinear", "border", align_corners=True), n)
    # bf16 rows (grid in bf16 too, as grid_sample wants): the yardstick is
    # "none" where the card's torch does not take them
    try:
        return cuda_ms(lambda: F.grid_sample(inp, grid, "bilinear", "border", align_corners=True), n)
    except (RuntimeError, NotImplementedError) as e:
        log(f"grid_sample on {inp.dtype}: none ({str(e).splitlines()[0][:160]})")
        return None


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
        pos = hat.positions(coefs, R, H, S, disp.reshape(BATCH, R, S))
        n_half, n_out = count_positions(pos, S)
        if n_half == 0 or n_out == 0:
            raise RuntimeError(f"{name}: the crafted half-integer/edge positions did not occur")
        results.append(compare(
            "hat_pass_pair", name, lambda: hat.hat_pass_pair(xa, xb, coefs, disp),
            lambda: hat.hat_pass_pair_ref(xa, xb, coefs, disp), hat_bound(True, BATCH, D, H, S, S, disp, nearest=True),
            lib=lambda: grid_sample_ms([xa, xb], pos),
            note=f" B={BATCH} R={R} S=OW={S} half-integer positions={n_half} saturated={n_out}",
        ))
        del pos
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
                note=f" B=1 R={R} S=OW={S} half-integer positions={n_half} saturated={n_out}",
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
                note=f" R={D * H} S=OW={S} half-integer positions={n_half} saturated={n_out}",
            ))
            del pos, xa, xb
    return results


def compare(key, name, run, plain, bnd, lib=None, n=20, note=""):
    """One kernel check: ``run()`` (the kernel) against ``plain()``,
    bit-identical or raise; then the median ms of each over ``n`` CUDA-event
    runs, ``lib()`` (the ms of one torch call computing the same function,
    or None) and the bound ``bnd`` = (ms, "bytes" or "operations"); also the
    kernel's ms behind an enqueued wait (fenced: the card's own time,
    :func:`ring_profile.one_ms`), its share of the bound, and the host wait,
    one launch's ms less the fenced."""
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
    fenced_ms = ring_profile.one_ms(run, True)
    fence_txt = (f" (fenced {fenced_ms:.4f} ms, {100 * bnd[0] / fenced_ms:.1f}% of bound {bnd[0]:.4f} ms, host wait "
                 f"{1e3 * (ms - fenced_ms):.1f} us)")
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
            note=f" half-integer positions={n_half} saturated={n_out}",
        ))
        del pos
    return results


def check_bf16_kernels(dev, cfg):
    """Phase 3: the bf16 forms against their plain versions on bf16 rows,
    bit-identical: K1's main form at the main path's three passes (B=4
    256^3, crafted half-integer and edge positions), K2's per-sample forms
    without a displacement (the affine warp's, under the production mode
    when the generator has no nonlinear field) at the stream's B=4 256^3
    in both modes; each with its bound (bf16 rows and outputs) and
    ``grid_sample`` on bf16 inputs."""
    p = sample_params(tpipe.make_generators(range(BATCH), dev), cfg)
    A = make_affine_matrix(p.rotations, p.shears, p.scalings)
    U, L = ul_decompose(A)
    g = torch.Generator(device=dev).manual_seed(5678)
    D = H = S = SHAPE[0]
    R = D * H
    xa = (100.0 * torch.rand((BATCH, D, H, S), generator=g, device=dev)).to(BF16)
    xb = torch.randint(0, 50, (BATCH, D, H, S), generator=g, device=dev).to(BF16)
    zero = torch.zeros(BATCH, device=dev)
    results = []
    for name, ci in (("L-y", L[:, 1, 0]), ("L-z", L[:, 2, 0]), ("x", zero)):
        coefs = torch.stack([ci, zero, zero + 1, zero], 1).contiguous()
        disp = (torch.rand((BATCH, R, S), generator=g, device=dev) * 2 - 1) * FIELD_LIM
        disp = craft_disp(disp, hat.positions(coefs, R, H, S, None), S).reshape(BATCH, D, H, S).contiguous()
        pos = hat.positions(coefs, R, H, S, disp.reshape(BATCH, R, S))
        n_half, n_out = count_positions(pos, S)
        if n_half == 0 or n_out == 0:
            raise RuntimeError(f"bf16 {name}: the crafted half-integer/edge positions did not occur")
        results.append(compare(
            "hat_pass_pair_bf16", name, lambda: hat.hat_pass_pair(xa, xb, coefs, disp),
            lambda: hat.hat_pass_pair_ref(xa, xb, coefs, disp),
            hat_bound(True, BATCH, D, H, S, S, disp, nearest=True, esize=2), lib=lambda: grid_sample_ms([xa, xb], pos),
            note=f" B={BATCH} R={R} S=OW={S} bf16 half-integer positions={n_half} saturated={n_out}",
        ))
        del pos
    del xa, xb
    c = torch.full((BATCH, 3), (S - 1) / 2.0, device=dev)
    t = c - torch.einsum("bij,bj->bi", A, c)
    z = zero
    one = z + 1
    volumes = {
        False: (100.0 * torch.rand((BATCH, D, H, S), generator=g, device=dev)).to(BF16),
        True: torch.randint(0, 50, (BATCH, D, H, S), generator=g, device=dev).to(BF16),
    }
    for name, cs in (("U-z", (z, z, U[:, 2, 2], t[:, 2])), ("U-x", (U[:, 0, 1], U[:, 0, 2], U[:, 0, 0], t[:, 0])),
                     ("L-z", (L[:, 2, 0], L[:, 2, 1], one, z)), ("crafted", (z + 0.25, z - 0.5, one, z + 0.5))):
        coefs = torch.stack(cs, 1).contiguous()
        pos = hat.positions(coefs, R, H, S, None)
        n_half, n_out = count_positions(pos, S)
        for nearest in (False, True):
            x = volumes[nearest]
            results.append(compare(
                "hat_pass_bf16", f"{name} {'nearest' if nearest else 'linear'}",
                lambda: hat.hat_pass(x, coefs, None, nearest), lambda: hat.hat_pass_ref(x, coefs, None, nearest),
                hat_bound(False, BATCH, D, H, S, S, None, nearest, esize=2), lib=lambda: grid_sample_ms([x], pos),
                note=f" B={BATCH} R={R} S=OW={S} bf16 half-integer positions={n_half} saturated={n_out}",
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


def pair_inputs(dev, g, disp_kind, nearest_b, shape, OW, offsets):
    """K1's operands for :func:`check_pair_tiles`: -0.0 among them (labels in
    0..49 when nearest), each a view ``offsets`` floats into a larger tensor;
    per-sample coefficients with quarter-voxel rows, general slopes and a
    reversed row, or per-slice ones; a displacement volume with exact
    half-integer positions and -0.0, or a lane-affine table."""
    B, D, H, S = shape
    n = B * D * H * S

    def operand(off, nearest):
        if nearest:
            base = torch.randint(-1, 50, (off + n,), generator=g, device=dev).to(torch.float32)
            base[base < 0] = -0.0
        else:
            base = 100.0 * torch.randn(off + n, generator=g, device=dev)
            base[::7] = -0.0
        return base[off:].view(shape)

    xa, xb = operand(offsets[0], False), operand(offsets[1], nearest_b)
    if disp_kind == "slice":
        coefs = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.2, 0.04, 8.0], device=dev)
        coefs[..., 2] += 1.0
        return xa, xb, coefs, None
    r = S / OW
    coefs = torch.tensor([[0.25, -0.5, r, 0.5], [0.05, -0.04, 1.02 * r, -0.3 * S], [0.0, 0.0, -r, S - 1.0]],
                         device=dev)[:B].contiguous()
    disp = None
    if disp_kind == "volume":
        disp = (torch.rand((B, D, H, OW), generator=g, device=dev) - 0.5) * (S / 2)
        disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5
        disp[..., 1::7] = -0.0
    elif disp_kind == "lane":
        disp = torch.randn((B, 3, OW), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [S / 8]]], device=dev)
    return xa, xb, coefs, disp


def check_pair_tiles(dev):
    """Phase 3: every K1 form against its plain version, untimed, bit for bit
    (the sign of zero included): at B=3 (3, 100, 101, 301), whose 13-row
    tiles span two samples (10,100 rows each) and slices and end partial;
    at S = 4095 (odd, above 3630: one-row tiles); at OW = 64 from S = 513
    (the forms with a displacement); on xa and xb 4 and 12 bytes into larger
    tensors; and at B=1 256^3 (the API's draws). Prints each form's launch
    geometry there and at B=4 256^3."""
    g = torch.Generator(device=dev).manual_seed(47)
    forms = (("main", True, "volume"), ("no displacement", True, None), ("lane-affine", False, "lane"),
             ("per-slice", False, "slice"))
    cases = (("partial tiles", (3, 100, 101, 301), 301, (0, 0)), ("odd S", (2, 2, 3, 4095), 4095, (0, 0)),
             ("OW != S", (2, 4, 4, 513), 64, (0, 0)), ("off 16 bytes", (2, 7, 9, 301), 301, (1, 3)),
             ("B=1", (1, *SHAPE), SHAPE[0], (0, 0)))
    for name, nearest_b, disp_kind in forms:
        for case, shape, OW, offsets in cases:
            xa, xb, coefs, disp = pair_inputs(dev, g, disp_kind, nearest_b, shape, OW, offsets)
            got = hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b)
            want = hat.hat_pass_pair_ref(xa, xb, coefs, disp, nearest_b)
            torch.cuda.synchronize()
            differ = sum(int((k.view(torch.int32) != r.view(torch.int32)).sum()) for k, r in zip(got, want))
            mode = {"volume": "volume", "lane": "lane"}.get(disp_kind, "none")
            geo = {f"{sh}": hat.hat_pair_geometry(sh, nearest_b, disp_kind == "slice", mode)
                   for sh in (shape, (BATCH, *SHAPE))}
            log(f"kernel hat_pass_pair {name} {case} {shape} OW={got[0].shape[-1]} offsets {offsets}: "
                f"bits differing={differ}; launches {json.dumps(geo)}")
            if differ:
                raise RuntimeError(f"hat_pass_pair {name} {case}: kernel differs from plain in {differ} elements")
            del xa, xb, coefs, disp, got, want


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
    missing = [k for k in [*probes.LAUNCHES, "hat_pass_pair_nodisp", "hat_pass_lane", "hat_pass_pair_bf16"]
               if not launches[k]]
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
                bound(16 * n, 0), lib=clone_ms),
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
            lib=lib, note=f" taps of the span budget per element {run_taps / (R * S7):.3f} (the kernel reads two)"
            f" span-clipped elements {clipped}"
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
    launches = launched()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"synth_batch: launches {launches}")
    if launches != counts(**pair_warps(1)):
        raise RuntimeError(f"expected {pair_warps(1)} launches and no other, got {launches}")

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


def _corr_rel(got: torch.Tensor, ref: torch.Tensor):
    """(correlation, relative L2) of ``got`` against ``ref``, in f64."""
    a, b = got.double().flatten(), ref.double().flatten()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    return corr, float((a - b).norm() / b.norm())


def production_core(dev, cfg, seeds, segs):
    """Phase 4b: ``synth_batch`` (B=4 256^3) in the production mode with
    host syncs made errors: K1's bf16 form three times and no other kernel;
    replayed bit for bit; against the f32 mode on the same seeds at JAX's
    bars (labels equal but for the card's ties, LABEL_TOL; correlation and
    relative L2); then the production mode at 64^3 on the card against the
    port's production mode on the CPU with the card's parameters and
    fields. Returns the launches."""
    sps = list(range(BATCH))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    reset_counts()
    with core_mode("production"):
        out, seg, _ = tpipe.synth_batch(seeds, segs, cfg, sps, dev)
    launches = launched()
    torch.cuda.set_sync_debug_mode(0)
    want = pair_warps(1, "hat_pass_pair_bf16")
    if launches != counts(**want):
        raise RuntimeError(f"production core: expected {want} launches and no other, got {launches}")
    with core_mode("production"):
        again, seg_again, _ = tpipe.synth_batch(seeds, segs, cfg, sps, dev)
    if not (torch.equal(again, out) and torch.equal(seg_again, seg)):
        raise RuntimeError("production core: the replay is not bit-identical")
    del again, seg_again
    ref, ref_seg, _ = tpipe.synth_batch(seeds, segs, cfg, sps, dev)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"production core: output {out.dtype}, finite {bool(torch.isfinite(out).all())}")
    rows = []
    for b in range(BATCH):
        corr, rel = _corr_rel(out[b], ref[b])
        frac = float((seg[b] != ref_seg[b]).float().mean())
        rows.append({"sample": b, "corr": corr, "rel_l2": rel, "labels_differing": frac})
    log(json.dumps({"production_vs_f32_core": rows, "bars": {"corr_min": CORE_CORR_MIN, "rel_max": CORE_REL_MAX,
                                                             "labels_differing_max": LABEL_TOL}}))
    if any(r["corr"] <= CORE_CORR_MIN or r["rel_l2"] >= CORE_REL_MAX or r["labels_differing"] > LABEL_TOL
           for r in rows):
        raise RuntimeError("production core: beyond JAX's bf16-against-f32 bars")
    del out, seg, ref, ref_seg

    small = dataclasses.replace(cfg, shape=BF16_CPU_SHAPE, deform=dataclasses.replace(cfg.deform, size=BF16_CPU_SHAPE))
    s_np, g_np = phantom_seeds_and_seg(BF16_CPU_SHAPE, seed=1)
    sd = torch.from_numpy(np.stack([s_np, s_np]).astype(np.int32))
    sg = torch.from_numpy(np.stack([g_np, g_np]).astype(np.int32))
    gens = tpipe.make_generators([11, 12], dev)
    p = sample_params(gens, small)
    f = tpipe.draw_fields(gens, small, dev)
    with core_mode("production"):
        o_gpu, l_gpu, _ = tpipe.synth_core(p, f, sd.to(dev), sg.to(dev), small)
        o_cpu, l_cpu, _ = tpipe.synth_core(p.to("cpu"), f.to("cpu"), sd, sg, small)
    o_gpu, l_gpu = o_gpu.cpu(), l_gpu.cpu()
    scale = float(o_cpu.abs().max())
    d = (o_gpu - o_cpu).abs() / scale
    frac = float((l_gpu != l_cpu).float().mean())
    share = float((d > IMAGE_TOL).float().mean())
    log(f"production core GPU vs CPU port, B=2 {BF16_CPU_SHAPE}: image max|d|/scale={float(d.max()):.3e} (bar "
        f"{BF16_ULPS} bf16 ulps = {BF16_ULPS * 2.0 ** -8:.3e}), share above {IMAGE_TOL}={share:.3e} (bar "
        f"{BF16_SHARE_MAX}), label mismatch fraction={frac:.3e} (bar {LABEL_TOL})")
    if float(d.max()) > BF16_ULPS * 2.0**-8 or share > BF16_SHARE_MAX or frac > LABEL_TOL:
        raise RuntimeError("production core: GPU and CPU paths of the port disagree beyond the bars")
    return launches


def time_slice(dev, cfg, seeds, segs, mode="f32"):
    """Phase 5: throughput, peak memory, single-volume latency, in ``mode``
    (the core under the stream's scopes: "production" or "f32")."""
    iters = 24
    with core_mode(mode):
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
        MEASURED["core" if mode == "f32" else f"core_{mode}"] = vols

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
            log(f"latency round {r} ({mode}): p50 {rounds[-1] * 1e3:.3f} ms, min {min(lats) * 1e3:.3f} ms, "
                f"max {max(lats) * 1e3:.3f} ms over 15 draws")
    log(json.dumps({
        "metric": "randomized 256^3 volumes/sec",
        "mode": mode,
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
    ``synth_core``, f32), then the operators and kernels with the most device
    time in each mode (:func:`core_profile`)."""
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
    for mode in MODES:
        core_profile(dev, cfg, seeds, segs, mode)


def core_profile(dev, cfg, seeds, segs, mode):
    """Phase 6's trace of the core in ``mode``: ``torch.profiler`` over 3
    batches: the kernel time against the host clock, then the operators and
    kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with core_mode(mode), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    log(f"profiler ({mode}), 3 batches: kernel time {total_ms:.3f} ms, wall {wall_ms:.3f} ms, kernel time / host "
        f"clock {total_ms / wall_ms:.3f} (profiler on)")
    # operators by the device time of the kernels they launch themselves,
    # then the kernels
    ops = [e for e in stats if e.device_type != DeviceType.CUDA and e.self_device_time_total > 0]
    hats = [e for e in kernels if "hat_ring_kernel" in e.key]  # K1 on the main path, below the top eight
    if not hats:
        raise RuntimeError("the profiler saw no hat kernel in synth_batch")
    for title, rows in (("operator", ops), ("kernel", kernels), ("hat kernel", hats)):
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
    "synth_train": (dict(seed_path=str(DATA / "derivatives" / "seeds")), True, pair_warps(1)),
    "real_train": (dict(load_image=True, image_as_intensity=True), True, dict(**pair_warps(1, mask=False), hat_pass=6)),
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
    launches = launched()
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
    MEASURED[name] = n / sum(draws)
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
    launches = launched()
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
    MEASURED[name] = n / dt
    log(json.dumps({"api": name, "samples_per_s": n / dt, "draws": n, "replay_bit_identical": True,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "artifacts": per_artifact}))
    return launches


def write_tree_a(root: Path) -> Path:
    """Phase 11's tree A: two phantom subjects at SHAPE with subclasses 1 and
    2, written as ``bench.py --stream`` writes them (the seeds split into
    four meta-label files by ``seeds % 4``)."""
    for si, sub in enumerate(["sub-b01", "sub-b02"]):
        seeds_np, seg_np = phantom_seeds_and_seg(SHAPE, seed=si)
        anat = root / sub / "anat"
        anat.mkdir(parents=True)
        nifti.save(anat / f"{sub}_dseg.nii.gz", seg_np.astype(np.int16))
        nifti.save(anat / f"{sub}_T2w.nii.gz", (seg_np > 0).astype(np.float32))
        for n in (1, 2):
            sd = root / "derivatives" / "seeds" / f"subclasses_{n}" / sub / "anat"
            sd.mkdir(parents=True)
            for m in range(1, 5):
                part = np.where(seeds_np % 4 == (m - 1), seeds_np, 0).astype(np.int8)
                nifti.save(sd / f"{sub}_mlabel_{m}.nii.gz", part)
    return root


def digest(x: torch.Tensor) -> torch.Tensor:
    """(B, D) int64 sums of ``x``'s 32-bit patterns over each sample's
    slices, on the device (no host sync)."""
    return x.view(torch.int32).sum(dim=(2, 3), dtype=torch.int64)


def drive_stream(dev, ds, prefetch: bool, iters: int = 24, mode: str = "production"):
    """Phase 11's drive of one stream in ``mode``: 2 warm-up batches, then
    ``iters`` timed, the host clock around a read of each batch (as
    ``bench.py --stream``). Returns the stream, its numbers, every batch's
    digests and the last batch."""
    with stream_mode(mode):
        return _drive_stream(dev, ds, prefetch, iters, mode)


def _drive_stream(dev, ds, prefetch, iters, mode):
    stream = SyntheticStream(ds, batch_size=BATCH, seed=0, prefetch=prefetch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    it = iter(stream)
    digests, spans = [], []
    t0 = time.perf_counter()
    with traced(spans):  # the first bank's build
        for _ in range(2):
            b = next(it)
            float(b["image"][..., ::64, ::64, ::64].sum())
            digests.append(torch.stack([digest(b["image"]), digest(b["label"])]))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        b = next(it)
        float(b["image"][..., ::64, ::64, ::64].sum())
        digests.append(torch.stack([digest(b["image"]), digest(b["label"])]))
    dt = time.perf_counter() - t0
    it.close()  # joins the producer of the batch in flight
    torch.cuda.synchronize()
    launches = launched()
    peak = torch.cuda.max_memory_allocated(dev)
    generated = 2 + iters + (1 if prefetch else 0)
    k1 = K1_FORM[mode]
    if launches != counts(**pair_warps(generated, k1)):
        raise RuntimeError(f"stream ({mode}): expected {pair_warps(generated, k1)} launches and no other, "
                           f"got {launches}")
    name = next(iter(stream.banks.records))  # the first bank built
    rec = stream.banks.records[name]
    numbers = {
        "mode": mode,
        "prefetch": prefetch,
        "vol_per_s": BATCH * iters / dt,
        "batches": iters,
        "warmup_s": warm_s,
        "first_bank": {"name": name, "reader": rec["reader"], **first_bank(spans, rec["bytes"]), "bytes": rec["bytes"]},
        "peak_mem_bytes": peak,
        "bank_counts": dict(BANK_COUNTS),
        "k1_launches": launches[k1],
        "row_affine_launches": launches[RA_FORM[k1]],
        "mask_launches": launches["mask_apply"],
    }
    return stream, numbers, torch.stack(digests).cpu(), b


def stream_phase(dev, tree: str, ds) -> collections.Counter:
    """Phase 11 for one tree, in the production mode (the stream's default):
    the stream with prefetch on, a recorded batch replayed bit for bit on
    the same stream and on a fresh one, ``compose_seeds`` on the card
    against a host sum; then the stream with prefetch off, bit-identical to
    prefetch on (every batch's digests); then the f32 mode with prefetch on
    over the same 24 batches' draws. For each run: vol/s beside phase 5's
    core vol/s in its mode, the first bank's build split, the reader, peak
    memory, K1 launches. Returns the launches by form."""
    stream, n_on, d_on, last = drive_stream(dev, ds, True)
    for where, st in (("same", stream), ("fresh", SyntheticStream(ds, batch_size=BATCH, seed=123, prefetch=False))):
        again = st.replay_batch(last["meta"])
        if not (torch.equal(again["image"], last["image"]) and torch.equal(again["label"], last["label"])
                and again["name"] == last["name"]):
            raise RuntimeError(f"stream {tree}: replay on the {where} stream is not bit-identical")
    del again, st
    name = last["meta"]["resident"][0]
    bank = stream.banks.bank(name)
    choices = torch.arange(4, device=dev, dtype=torch.int32) % bank.shape[0]
    got = compose_seeds(bank, choices).cpu().numpy()
    host = bank.cpu().numpy()
    want = sum(host[int(c), m].astype(np.int32) for m, c in enumerate(choices.tolist()))
    if not np.array_equal(got, want):
        raise RuntimeError(f"stream {tree}: compose_seeds on the card differs from the host sum")
    del stream, last, bank
    _, n_off, d_off, _ = drive_stream(dev, ds, False)
    if not torch.equal(d_on, d_off):
        differ = (d_on != d_off).flatten(1).any(1).nonzero().flatten().tolist()
        raise RuntimeError(f"stream {tree}: prefetch on and off differ in batches {differ}")
    _, n_f32, _, _ = drive_stream(dev, ds, True, mode="f32")
    MEASURED[f"stream_{tree}"] = n_on["vol_per_s"]
    MEASURED[f"stream_{tree}_f32"] = n_f32["vol_per_s"]
    for n in (n_on, n_off, n_f32):
        core = MEASURED.get("core" if n["mode"] == "f32" else f"core_{n['mode']}")
        n["core_vol_per_s"] = core
        n["of_core"] = n["vol_per_s"] / core if core else None
        if tree == "tree_b" and MEASURED.get("synth_train"):
            n["of_api_synth_train"] = n["vol_per_s"] / MEASURED["synth_train"]
        checked = {} if n is n_f32 else {"prefetch_bit_identical": True, "replay_bit_identical": True,
                                          "compose_seeds_equal_host": True}
        log(json.dumps({"stream": tree, **n, **checked}))
    masks = sum(n["mask_launches"] for n in (n_on, n_off, n_f32))
    return collections.Counter({"hat_pass_pair_bf16": n_on["k1_launches"] + n_off["k1_launches"],
                                "hat_pass_pair": n_f32["k1_launches"],
                                "row_affine_pair_bf16": n_on["row_affine_launches"] + n_off["row_affine_launches"],
                                "row_affine_pair_f32": n_f32["row_affine_launches"],
                                **dict.fromkeys(deform_mask.LAUNCHES, masks)})


def stream_affine_drive(dev, root) -> collections.Counter:
    """Phase 11: tree A's stream in the production mode with a generator
    without the nonlinear field, prefetch off, 1 + 3 batches: the affine
    warp's ten K2 passes a batch (five linear, five nearest) in their bf16
    forms and no other kernel; then one more batch with every K2 launch also
    run through its plain version on the same inputs (:class:`StreamHatCheck`
    on ``ops.warp``), bit for bit; finite images, labels among the input's."""
    cfg = bench_cfg()
    cfg = dataclasses.replace(cfg, deform=dataclasses.replace(cfg.deform, nonlinear_transform=False))
    gen = types.SimpleNamespace(cfg=cfg, device=dev, artifacts={})
    ds = FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))
    stream = SyntheticStream(ds, batch_size=BATCH, seed=2, prefetch=False)
    with stream_mode("production"):
        it = iter(stream)
        next(it)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        batches = [next(it) for _ in range(3)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check = StreamHatCheck()
        with check.on(warp):
            batches.append(next(it))
        it.close()
    launches = launched()
    if launches != counts(hat_pass_bf16=40):
        raise RuntimeError(f"stream without the field: expected 40 hat_pass_bf16 launches and no other, got {launches}")
    if set(check.calls) != {"hat_pass_bf16"} or check.calls["hat_pass_bf16"] != 10:
        raise RuntimeError(f"stream without the field: the checked batch made {dict(check.calls)}")
    if check.differ["hat_pass_bf16"] or check.err["hat_pass_bf16"]:
        raise RuntimeError(f"stream without the field: a K2 launch differs from its plain version "
                           f"({check.differ['hat_pass_bf16']}, {check.err['hat_pass_bf16']})")
    shapes = sorted({shape for _, shape in check.kept})
    stream.banks.fill(stream._names)
    in_labels = set(torch.unique(stream.banks.segs[stream.banks.slots(stream._names)]).tolist())
    for b in batches:
        if not bool(torch.isfinite(b["image"]).all()) or not set(torch.unique(b["label"]).tolist()) <= in_labels:
            raise RuntimeError("stream without the field: non-finite image or labels not in the input")
    log(json.dumps({"stream": "tree_a affine (no nonlinear field)", "mode": "production", "batches": 3,
                    "vol_per_s": 3 * BATCH / dt, "launches": {k: v for k, v in launches.items() if v},
                    "checked_batch": {"launches": 10, "max_abs_err": 0.0, "shapes": shapes}}))
    return collections.Counter({"hat_pass_bf16": launches["hat_pass_bf16"]})


def stream_profile(dev, ds, n: int = 12, mode: str = "production"):
    """Phase 11's trace of the stream (tree A) in ``mode``. Prefetch off: each batch's
    host time until ``next`` returns (the enqueue) against its CUDA-event
    time (median of 3 after a warm-up). Prefetch on: ``torch.profiler`` over
    ``n`` batches read after 2 warm-ups: the device's kernel time against the
    host clock (batches generated in the window counted by K1's launches,
    3 a batch), and the kernels with the most device time (the producer
    thread's operators are not traced)."""
    with stream_mode(mode):
        _stream_profile(dev, ds, n, mode)


def _stream_profile(dev, ds, n, mode):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    it = iter(SyntheticStream(ds, batch_size=BATCH, seed=5, prefetch=False))
    host, card = [], []
    for i in range(4):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        next(it)
        t_host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if i:
            host.append(t_host * 1e3)
            card.append(start.elapsed_time(end))
    it.close()
    log(f"stream ({mode}), prefetch off: host enqueue {statistics.median(host):.3f} ms, card "
        f"{statistics.median(card):.3f} ms per batch (medians of 3)")

    it = iter(SyntheticStream(ds, batch_size=BATCH, seed=5, prefetch=True))
    for _ in range(2):
        float(next(it)["image"][..., ::64, ::64, ::64].sum())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            float(next(it)["image"][..., ::64, ::64, ::64].sum())
        wall_ms = (time.perf_counter() - t0) * 1e3
        it.close()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    batches = sum(e.count for e in kernels if "hat_ring_kernel" in e.key) / 3
    if total_ms <= 0 or not batches:
        raise RuntimeError("torch.profiler recorded no device time or no K1 launch in the stream")
    log(f"stream profile ({mode}), prefetch on, {n} batches read, {batches:g} generated in the window: kernel time "
        f"{total_ms / batches:.3f} ms per batch generated, host clock {wall_ms / n:.3f} ms per batch read, "
        f"kernel time / host clock {total_ms / wall_ms:.3f} (profiler on)")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    # then the gathers (the banks' and segmentations' rows) and reductions
    # (the seed sums, the peaks), which the core runs fewer of or none
    for e in top[:10] + [e for e in top[10:] if "index_elementwise" in e.key or "reduce_kernel" in e.key]:
        ms = e.self_device_time_total / 1e3
        log(f"  kernel {100 * ms / total_ms:5.1f}% {ms / batches:8.3f} ms/batch "
            f"{e.count / batches:6.1f} calls/batch  {e.key[:160]}")


def stream_cpu_check(dev, ds):
    """Phase 11's GPU-vs-CPU check, in the f32 mode (its bars are f32 bars;
    phase 4b holds the production mode's): one B=1 batch on the card, then
    the same batch through the port's batch program on the CPU, with the
    card's parameters and fields (torch's CUDA and CPU generators differ)."""
    with stream_mode("f32"):
        _stream_cpu_check(dev, ds)


def _stream_cpu_check(dev, ds):
    stream = SyntheticStream(ds, batch_size=1, seed=7, prefetch=False)
    it = iter(stream)
    batch = next(it)
    it.close()
    meta = batch["meta"]
    gens = tpipe.make_generators(meta["seeds"], dev)
    p = sample_params(gens, stream.cfg)
    f = tpipe.draw_fields(gens, stream.cfg, dev)
    banks = stream._banks_for(meta["resident"])
    t0 = time.perf_counter()
    out_cpu, seg_cpu = batch_program(
        *(t.cpu() for t in banks), torch.from_numpy(meta["subj"]), torch.from_numpy(meta["u"]),
        p.to("cpu"), f.to("cpu"), stream.cfg, stream._lo,
    )
    cpu_s = time.perf_counter() - t0
    img_err = float((batch["image"].cpu() - out_cpu).abs().max())
    mism = (batch["label"].cpu() != seg_cpu).nonzero()
    frac = mism.shape[0] / float(np.prod(SHAPE))
    log(f"stream tree_b: GPU vs CPU port, B=1 ({cpu_s:.1f} s on the CPU): image max|d|={img_err:.3e} "
        f"(bar {IMAGE_TOL}), label mismatch fraction={frac:.3e} (bar {LABEL_TOL}), first at {mism[:4].tolist()}")
    if not img_err <= IMAGE_TOL or frac > LABEL_TOL:
        raise RuntimeError("stream: GPU and CPU paths of the port disagree beyond the bars")


def stream_path(dev, t_start) -> collections.Counter:
    """Phase 11: the artifact-free stream on tree A (two 256^3 phantom
    subjects, phase 5's generator config; and without the nonlinear field)
    and tree B (``data/sub-sta21``, phase 7's ``synth_train`` generator), in
    both modes. Returns the launches by form."""
    t0 = time.perf_counter()
    reader = "native" if native.available() else "python"
    log(f"phase 11 native loader: {reader} (built and loaded in {time.perf_counter() - t0:.2f} s), "
        f"build error: {native.build_error()}")
    launches = collections.Counter()
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = write_tree_a(Path(tmp))
        log(f"phase 11 tree A written at {time.perf_counter() - t_start:.1f} s")
        gen = types.SimpleNamespace(cfg=bench_cfg(), device=dev, artifacts={})
        ds = FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))
        launches += stream_phase(dev, "tree_a", ds)
        for mode in MODES:
            stream_profile(dev, ds, mode=mode)
        del ds
        launches += stream_affine_drive(dev, root)
    log(f"phase 11 tree A done at {time.perf_counter() - t_start:.1f} s")
    ds = FetalSynthDataset(str(DATA), api_generator(dev), seed_path=str(DATA / "derivatives" / "seeds"))
    launches += stream_phase(dev, "tree_b", ds)
    stream_cpu_check(dev, ds)
    return launches


class StreamHatCheck:
    """Phase 12: the scanner's K1 and K2 entry points, wrapped so that every
    launch is also run through its plain version on the same inputs and held
    bit for bit; the first inputs of each (form, shape) are kept for timing."""

    def __init__(self):
        self.err = collections.defaultdict(float)
        self.differ = collections.Counter()
        self.calls = collections.Counter()
        self.kept = {}

    def single(self, x, coefs, disp=None, nearest=False, out_len=None):
        out = hat.hat_pass(x, coefs, disp, nearest, out_len)
        key = hat.launch_key(False, nearest, coefs, disp, x.dtype)
        self._note(key, (out,), (hat.hat_pass_ref(x, coefs, disp, nearest, out_len),), (x, None, coefs, disp))
        return out

    def pair(self, va, vb, coefs, disp, nearest_b=True, out_len=None, nearest_a=False):
        got = hat.hat_pass_pair(va, vb, coefs, disp, nearest_b, out_len, nearest_a)
        key = hat.launch_key(True, nearest_b, coefs, disp, va.dtype, nearest_a=nearest_a)
        want = hat.hat_pass_pair_ref(va, vb, coefs, disp, nearest_b, out_len, nearest_a)
        self._note(key, got, want, (va, vb, coefs, disp))
        return got

    def _note(self, key, got, want, inputs):
        self.calls[key] += 1
        self.err[key] = max(self.err[key], max(float((g - w).abs().max()) for g, w in zip(got, want)))
        self.differ[key] += sum(int((g != w).sum()) for g, w in zip(got, want))
        shape = tuple(inputs[0].shape)
        if (key, shape) not in self.kept:
            self.kept[key, shape] = tuple(None if t is None else t.clone() for t in inputs)

    @contextlib.contextmanager
    def on(self, module=sc):
        """The check in place of ``module``'s entry points (the scanner's,
        or ``ops.warp``'s for the core's passes)."""
        saved = module.hat_pass, module.hat_pass_pair
        module.hat_pass, module.hat_pass_pair = self.single, self.pair
        try:
            yield self
        finally:
            module.hat_pass, module.hat_pass_pair = saved


def stream_ds(dev):
    """Phase 12's dataset: ``data/sub-sta21`` with ``synth_train.yaml``'s
    generator, its four SR artifacts at the YAML's probabilities."""
    gen = api_generator(dev, seed=3, artifacts=default_artifacts())
    return FetalSynthDataset(str(DATA), gen, seed_path=str(DATA / "derivatives" / "seeds"))


def engine_of(pack, b, stream) -> str:
    """The motion engine sample ``b`` of ``pack`` runs: "off", "small" or
    its cube tier."""
    if not pack["motion_on"][b]:
        return "off"
    cube, small = tba.engine_cube(tba.row_of(pack, b), stream.cube, stream.small_cube)
    return "small" if small else str(cube)


def drive_artifact_stream(dev, ds, prefetch: bool, iters: int = 24, mode: str = "production"):
    """Phase 12's drive in ``mode``: ``SyntheticStream`` with the artifacts,
    2 warm-up batches then ``iters`` read, the host clock around a read of
    each batch. Returns the stream, its numbers, every batch's digests and
    its launches."""
    with stream_mode(mode):
        stream, numbers, digests, launches = _drive_artifact_stream(dev, ds, prefetch, iters)
    numbers["mode"] = mode
    return stream, numbers, digests, launches


def _drive_artifact_stream(dev, ds, prefetch, iters):
    stream = SyntheticStream(ds, batch_size=BATCH, seed=0, prefetch=prefetch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    reads = tba.COUNTS["transfers"]
    it = iter(stream)
    digests, metas, spans = [], [], []
    with traced(spans):  # the motion engine's stacks (chain.motion), the timed batches with them
        for _ in range(2):
            b = next(it)
            float(b["image"][..., ::64, ::64, ::64].sum())
            digests.append(torch.stack([digest(b["image"]), digest(b["label"])]))
            metas.append(b["meta"])
        t0 = time.perf_counter()
        for _ in range(iters):
            b = next(it)
            float(b["image"][..., ::64, ::64, ::64].sum())
            digests.append(torch.stack([digest(b["image"]), digest(b["label"])]))
            metas.append(b["meta"])
        dt = time.perf_counter() - t0
        it.close()
    launches = launched()
    # the batch a prefetching producer has in flight at close may be dropped
    # before its warp (the producer is slower than the core stream's)
    pair_warps_per_batch(launches, range(2 + iters, 3 + iters + (1 if prefetch else 0)), "stream with artifacts")
    motion = [r["attrs"] for r in spans if r["name"] == "chain.motion" and r["attrs"]]
    counted = {"transfers": tba.COUNTS["transfers"] - reads, "motion_samples": len(motion),
               "stacks_attempted": sum(a["stacks_attempted"] for a in motion),
               "stacks_accepted": sum(a["stacks_accepted"] for a in motion)}
    engines = collections.Counter(engine_of(m["pack"], i, stream) for m in metas for i in range(BATCH))
    numbers = {
        "prefetch": prefetch, "vol_per_s": BATCH * iters / dt, "batches": iters,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "launches": launches,
        "engine_share": {k: v / (BATCH * len(metas)) for k, v in sorted(engines.items())},
        "generated": counted, "stacks_accepted_per_motion_sample":
            counted["stacks_accepted"] / max(counted["motion_samples"], 1),
    }
    return stream, numbers, torch.stack(digests).cpu(), launches


@contextlib.contextmanager
def pinned(stream, B, motion_pins, gates=None, split=True, coarse=True):
    """``stream`` made to draw B-sample batches with the motion artifact's
    pins ``motion_pins``, quality gates ``gates`` ((3,) or None) and the
    engine's dz-split and coarse weight as given, then restored."""
    saved = stream.batch_size, stream._sm_gp, stream._gates, stream.chain
    stream.batch_size, stream._sm_gp, stream._gates = B, motion_pins, gates
    stream.chain = dataclasses.replace(stream.chain, split_dz=split, coarse_w=coarse)
    try:
        yield stream
    finally:
        stream.batch_size, stream._sm_gp, stream._gates, stream.chain = saved


def checked_replay(stream, batch, check, what):
    """``batch`` replayed with every K1/K2 launch held by ``check``; raises
    unless it is bit-identical."""
    with check.on():
        again = stream.replay_batch(batch["meta"])
    if not (torch.equal(again["image"], batch["image"]) and torch.equal(again["label"], batch["label"])):
        raise RuntimeError(f"{what}: the checked replay differs from the batch")


def engine_batch(dev, stream, name, rs, split, coarse, check):
    """One B=1 batch of phase 12 routed to one engine by its pinned slice
    resolution (the motion gate forced on): its per-artifact card time (the
    ``chain.*`` spans), the
    K1/K2 launches per form and peak memory; then the batch replayed with
    every K1/K2 launch held against its plain version, bit-identical to the
    first run. Returns the launches."""
    with pinned(stream, 1, {"resolution_slice": rs}, None, split, coarse):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        spans = []
        t0 = time.perf_counter()
        with traced(spans):
            batch = stream._generate()
            host_ms = 1e3 * (time.perf_counter() - t0)
        launches = launched()
        pair_warps_per_batch(launches, range(1, 2), f"stream engine {name}")
        peak = torch.cuda.max_memory_allocated(dev)
        pack = batch["meta"]["pack"]
        got = engine_of(pack, 0, stream)
        if got != name:
            raise RuntimeError(f"stream engine {name}: resolution_slice {rs} routed the sample to {got}")
        checked_replay(stream, batch, check, f"stream engine {name}")
    per = {r["name"]: round(r["ms"], 3) for r in spans if r["name"].startswith("chain.") and "ms" in r}
    log(json.dumps({"stream_engine": name, "resolution_slice": rs, "dz_split": split, "coarse_w": coarse,
                    "artifact_events_ms": per, "host_ms": host_ms, "launches": {k: v for k, v in launches.items() if v},
                    "peak_mem_bytes": peak, "dz_ok": pack["dz_ok"][0].tolist(), "num_stacks": int(pack["num_stacks"][0])}))
    return launches


def stream_forced_batch(dev, stream, check):
    """Phase 12: one B=4 batch with every artifact forced on (the motion
    artifact by ``{"apply": True}``, its geometry drawn): per-artifact card
    time per sample (the ``chain.*`` spans), launches, peak memory; then
    replayed under the check."""
    with pinned(stream, BATCH, {"apply": True}, np.ones(3, np.int32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        spans = []
        with traced(spans):
            batch = stream._generate()
        launches = launched()
        pair_warps_per_batch(launches, range(1, 2), "stream forced batch")
        peak = torch.cuda.max_memory_allocated(dev)
        checked_replay(stream, batch, check, "stream forced batch")
    per = collections.defaultdict(list)
    for r in spans:
        if r["name"].startswith("chain.") and "ms" in r:
            per[r["name"]].append(round(r["ms"], 3))
    pack = batch["meta"]["pack"]
    log(json.dumps({"stream_forced": True, "engines": [engine_of(pack, b, stream) for b in range(BATCH)],
                    "artifact_events_ms_per_sample": per, "launches": {k: v for k, v in launches.items() if v},
                    "peak_mem_bytes": peak}))
    return launches


def stream_sync_check(stream):
    """Phase 12: one forced batch with CUDA's sync debug mode at "error";
    the chain lifts it around its one planned read of the validity flags, so
    any other host sync fails the batch."""
    with pinned(stream, BATCH, {"apply": True}, np.ones(3, np.int32)):
        torch.cuda.synchronize()
        before = tba.COUNTS["transfers"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            batch = stream._generate()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    reads = tba.COUNTS["transfers"] - before
    if reads != 1 or not bool(torch.isfinite(batch["image"]).all()):
        raise RuntimeError(f"stream sync check: {reads} planned reads (want 1) or non-finite image")
    log(f"stream sync check: one forced B={BATCH} batch under sync debug mode 'error', {reads} planned read")


def stream_profile_artifacts(stream, n: int = 2, mode: str = "production"):
    """Phase 12's trace in ``mode``: ``torch.profiler`` over ``n`` forced
    batches, prefetch off: the card's kernel time against the host clock,
    the kernels with the most device time, and the copy kernels (the
    contiguous copies before the hat passes, einsum's permuted operands) per
    batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with stream_mode(mode), pinned(stream, BATCH, {"apply": True}, np.ones(3, np.int32)):
        stream._generate()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                stream._generate()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time in the stream with artifacts")
    copies = [e for e in kernels if "copy" in e.key.lower()]
    log(f"stream artifacts profile ({mode}), {n} forced B={BATCH} batches, prefetch off: kernel time "
        f"{busy_ms / n:.3f} ms "
        f"a batch, host clock {wall_ms / n:.3f} ms a batch, kernel time / host clock {busy_ms / wall_ms:.3f} "
        f"(profiler on); copy kernels {sum(e.count for e in copies) / n:.1f} a batch, "
        f"{sum(e.self_device_time_total for e in copies) / 1e3 / n:.3f} ms a batch")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"  kernel {100 * ms / busy_ms:5.1f}% {ms / n:9.3f} ms/batch {e.count / n:7.1f} calls/batch  {e.key[:150]}")


def stream_artifacts_cpu_check(dev, stream):
    """Phase 12: one B=1 forced batch (small engine, every artifact on) on
    the card against the port's CPU path on the same meta. The core's labels
    against the CPU core's within phase 11's bar (nearest-label ties may
    flip, ROADMAP §3); the chain run on the CPU from the card's core output
    with the card's recorded draws (torch's CUDA and CPU generators differ):
    the same validity flags, the image within 1e-4 of its scale outside the
    voxels whose recon weight crosses 1e-2 between the two (grown by one
    voxel where the box smooth ran) or whose boundaries mask differs, whose
    share is printed and bounded. In the f32 mode: its bars are f32 bars."""
    with stream_mode("f32"), pinned(stream, 1, {"resolution_slice": 0.7}, np.ones(3, np.int32)):
        batch = stream._generate()
        meta = batch["meta"]
        rec = tba.chain_draws(meta["seeds"], dev, record=True)
        tr_gpu, tr_cpu, core = [], [], {}
        chain_gpu = stream.make_chain(meta, draws=rec, traces=tr_gpu)

        def chain(out, seg):
            core.update(out=out.cpu(), seg=seg.cpu())
            core["chain"] = chain_gpu(out, seg)
            return core["chain"]

        gens = tpipe.make_generators(meta["seeds"], dev)
        p = sample_params(gens, stream.cfg)
        f = tpipe.draw_fields(gens, stream.cfg, dev)
        banks = stream._banks_for(meta["resident"])
        args = (torch.from_numpy(meta["subj"]), torch.from_numpy(meta["u"]))
        gpu, _ = batch_program(*banks, *(a.to(dev) for a in args), p, f, stream.cfg, stream._lo, chain)
        if not torch.equal(gpu, batch["image"]):
            raise RuntimeError("stream GPU vs CPU: the recorded rerun differs from the batch")
        t0 = time.perf_counter()
        _, seg_cpu = batch_program(*(t.cpu() for t in banks), *args, p.to("cpu"), f.to("cpu"), stream.cfg,
                                   stream._lo)
        chain_cpu = stream.make_chain(meta, draws=[tba.Draws(d.seed, "cpu", given=d.recorded) for d in rec],
                                      traces=tr_cpu)
        img = chain_cpu(core["out"], core["seg"])
        cpu_s = time.perf_counter() - t0
    label_frac = float((core["seg"] != seg_cpu).float().mean())
    g, c = tr_gpu[0], tr_cpu[0]
    if g["accepted"] != c["accepted"] or not np.array_equal(g["valid"], c["valid"]):
        raise RuntimeError(f"stream GPU vs CPU: accepted stacks {g['accepted']} / {c['accepted']}, "
                           f"{int((g['valid'] != c['valid']).sum())} validity flags differ")
    # the chain's two discontinuities: the recon weight's 1e-2 threshold
    # (grown by the box smooth) and the boundaries' mask (its fuzzy levels
    # round a Gaussian mixture)
    w_flips = (g["weight"].cpu() > 1e-2) != (c["weight"] > 1e-2)
    if meta["pack"]["smooth_on"][0]:
        w_flips = box_sum(w_flips.to(torch.float32), 3) > 0
    m_flips = g["mask"].cpu() != c["mask"]
    flips = w_flips | m_flips
    share = float(flips.float().mean())
    want = core["chain"][0].cpu()
    d = (want - img[0]).abs() / float(want.abs().max())
    err = float(torch.where(flips, 0.0, d).max())
    worst = [int(i) for i in np.unravel_index(int(torch.where(flips, 0.0, d).argmax()), SHAPE)]
    log(f"stream artifacts GPU vs CPU port, B=1 forced, engine {engine_of(meta['pack'], 0, stream)} ({cpu_s:.1f} s "
        f"on the CPU): chain max|d| / scale outside the flips={err:.3e} at {worst} (bar {IMAGE_TOL}); flips: recon "
        f"weight {int(w_flips.sum())}, boundaries mask {int(m_flips.sum())}, share {share:.3e} (bar {FLIP_SHARE_MAX}); "
        f"overall {float(d.max()):.3e}, voxels above the bar {int((d > IMAGE_TOL).sum())}; core labels differing "
        f"{label_frac:.3e} (bar {LABEL_TOL}); accepted stacks {g['accepted']}")
    if not err <= IMAGE_TOL or share > FLIP_SHARE_MAX or label_frac > LABEL_TOL:
        raise RuntimeError("stream with artifacts: GPU and CPU paths of the port disagree beyond the bars")


def motion_mode_check(dev, stream):
    """Phase 12: one motion call (``motion_t``, the 384 engine, a forced B=1
    batch's pack) in the production mode against the f32 mode, on the same
    f32 core output and the same draws: JAX's bars (relative L2 and
    correlation, ``tests/test_batched_artifacts.py:341-371``)."""
    with stream_mode("f32"), pinned(stream, 1, {"resolution_slice": 0.5}, np.zeros(3, np.int32)):
        meta = stream._generate()["meta"]
        gens = tpipe.make_generators(meta["seeds"], dev)
        p = sample_params(gens, stream.cfg)
        f = tpipe.draw_fields(gens, stream.cfg, dev)
        banks = stream._banks_for(meta["resident"])
        args = (torch.from_numpy(meta["subj"]).to(dev), torch.from_numpy(meta["u"]).to(dev))
        core, seg = batch_program(*banks, *args, p, f, stream.cfg, stream._lo,
                                  chain=lambda out, seg: out.clone())
    row = tba.row_of(meta["pack"], 0)
    outs, traces = {}, {}
    draws = tba.chain_draws(meta["seeds"], dev, record=True)[0]
    for mode in ("f32", "production"):
        traces[mode] = {}
        with core_mode(mode):
            outs[mode] = tba.motion_t(core[0], seg[0], row, stream._sm, SHAPE, stream.cube, stream.ns_grid, draws,
                                      stream.small_cube, stream.dz_split, stream.coarse_w, trace=traces[mode])
        draws = tba.Draws(draws.seed, dev, given=draws.recorded)
    torch.cuda.synchronize()
    corr, rel = _corr_rel(outs["production"], outs["f32"])
    log(json.dumps({"production_vs_f32_motion": {"engine": engine_of(meta["pack"], 0, stream), "corr": corr,
                                                  "rel_l2": rel, "accepted": {m: traces[m]["accepted"] for m in traces},
                                                  "dtype": str(outs["production"].dtype)},
                    "bars": {"corr_min": MOTION_CORR_MIN, "rel_max": MOTION_REL_MAX}}))
    if outs["production"].dtype != torch.float32 or corr <= MOTION_CORR_MIN or rel >= MOTION_REL_MAX:
        raise RuntimeError("production motion: beyond JAX's bf16-against-f32 bars")


def stream_kernel_checks(dev, check):
    """Phase 12: each K1/K2 form the stream launched, at each of its shapes
    (the inputs the check kept), against its plain version: bit-identical,
    timed with its bound and a ``grid_sample`` yardstick."""
    results = []
    for (key, shape), (xa, xb, coefs, disp) in sorted(check.kept.items(), key=lambda kv: (kv[0][0], kv[0][1])):
        B, D, H, S = xa.shape
        OW = S if disp is None else disp.shape[-1]
        pair = xb is not None
        if pair:
            run = lambda: hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b=False)  # noqa: E731
            plain = lambda: hat.hat_pass_pair_ref(xa, xb, coefs, disp, nearest_b=False)  # noqa: E731
        else:
            run = lambda: hat.hat_pass(xa, coefs, disp)  # noqa: E731
            plain = lambda: hat.hat_pass_ref(xa, coefs, disp)  # noqa: E731
        pos = hat._positions_of(coefs, B, D, H, OW, disp)
        n_half, n_out = count_positions(pos, S)
        n = 20 if B * D * H * S <= 2**26 else 5
        esize = xa.element_size()
        results.append(compare(
            f"stream:{key}", f"stream {tuple(shape)}", run, plain, hat_bound(pair, B, D, H, S, OW, disp, esize=esize),
            lib=lambda: grid_sample_ms([xa] + ([xb] if pair else []), pos, n), n=n,
            note=f" half-integer positions={n_half} saturated={n_out}",
        ))
        del pos
    check.kept.clear()
    return results


def stream_artifacts_path(dev, t_start):
    """Phase 12: the stream with the SR artifacts (``synth_train.yaml``'s
    generator on ``data/sub-sta21``, B=4 256^3). Returns (the stream forms'
    launches by kernel entry, the kernel checks)."""
    ds = stream_ds(dev)
    stream, n_on, d_on, l_on = drive_artifact_stream(dev, ds, True)
    _, n_off, d_off, l_off = drive_artifact_stream(dev, ds, False)
    if not torch.equal(d_on, d_off):
        differ = (d_on != d_off).flatten(1).any(1).nonzero().flatten().tolist()
        raise RuntimeError(f"stream with artifacts: prefetch on and off differ in batches {differ}")
    _, n_f32, _, l_f32 = drive_artifact_stream(dev, ds, True, mode="f32")
    it = iter(stream)
    b = next(it)
    it.close()
    for where, st in (("same", stream), ("fresh", SyntheticStream(ds, batch_size=BATCH, seed=5, prefetch=False))):
        again = st.replay_batch(b["meta"])
        if not (torch.equal(again["image"], b["image"]) and torch.equal(again["label"], b["label"])):
            raise RuntimeError(f"stream with artifacts: replay on the {where} stream is not bit-identical")
    del again, b
    sm = stream._sm
    pack_ms = []
    for i in range(24):
        t0 = time.perf_counter()
        tba.pack_motion(np.random.default_rng(i), BATCH, SHAPE, 0.5, sm, stream.cube, stream.ns_grid,
                        small_cube=stream.small_cube)
        pack_ms.append(1e3 * (time.perf_counter() - t0))
    for n in (n_on, n_off, n_f32):
        f32 = n["mode"] == "f32"
        n.update(api_artifacts_samples_per_s=MEASURED.get("synth_train_artifacts"),
                 artifact_free_stream_vol_per_s=MEASURED.get("stream_tree_b_f32" if f32 else "stream_tree_b"),
                 pack_motion_ms_per_batch=statistics.mean(pack_ms), cubes=list(stream.cubes),
                 ns_grid=stream.ns_grid, small_cube=stream.small_cube)
        checked = {} if f32 else {"prefetch_bit_identical": True, "replay_bit_identical": True}
        log(json.dumps({"stream_artifacts": "tree_b", **n, **checked}))
    log(f"phase 12 drives done at {time.perf_counter() - t_start:.1f} s")
    launches = collections.Counter()
    for lc in (l_on, l_off, l_f32):
        launches.update(lc)
    check = StreamHatCheck()
    for mode in MODES:
        with stream_mode(mode):
            launches.update(stream_forced_batch(dev, stream, check))
            for name, rs in STREAM_ENGINES:
                for split, coarse in ((True, True), (False, True), (True, False)):
                    launches.update(engine_batch(dev, stream, name, rs, split, coarse, check))
    log(f"phase 12 engine batches done at {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"stream_launch_check": {k: {"calls": check.calls[k], "max_abs_err": check.err[k],
                                                  "elements_differing": check.differ[k]} for k in check.calls}}))
    if any(check.differ.values()) or any(check.err.values()):
        raise RuntimeError(f"stream: a K1/K2 launch differs from its plain version: {dict(check.differ)}")
    if not all(launches[k] for k in ("hat_pass_pair", "hat_pass_pair_bf16", *STREAM_FORMS)):
        raise RuntimeError(f"stream: a K1/K2 form of the stream was never launched: {dict(launches)}")
    stream_sync_check(stream)
    for mode in MODES:
        stream_profile_artifacts(stream, mode=mode)
    motion_mode_check(dev, stream)
    stream_artifacts_cpu_check(dev, stream)
    log(f"phase 12 checks done at {time.perf_counter() - t_start:.1f} s")
    checks = stream_kernel_checks(dev, check)
    return {f"stream:{k}": launches[k] for k in STREAM_FORMS}, checks


TRAIN_STEPS = 20  # phase 13's timed steps, after 2 warm-up steps
TRAIN_CPU_SHAPE = (64, 64, 64)  # phase 13's card-against-CPU step
TRAIN_LOSS_RTOL = 1e-4  # |card - CPU| / |CPU| of that step's loss
TRAIN_GRAD_TOL = 1e-3  # |card - CPU| of each gradient over the leaf's max |g|
DDP_LOSS_RTOL = 1e-5  # the world-1 NCCL step's loss against the plain step's
DDP_GRAD_TOL = 1e-5  # its gradients against the plain step's, over each leaf's max |g|
ADAMW_STEP_TOL = 1e-6  # its weights against AdamW's first step of its own gradients


def train_inputs(dev, shape):
    """Phase 13's B=1 phantom seeds and segmentation on ``dev`` and the
    benchmark's generator config at ``shape``."""
    seeds_np, seg_np = phantom_seeds_and_seg(shape)
    seeds = torch.from_numpy(seeds_np.astype(np.int32))[None].to(dev)
    segs = torch.from_numpy(seg_np.astype(np.int32))[None].to(dev)
    cfg = dataclasses.replace(bench_cfg(), shape=tuple(shape))
    return seeds, segs, cfg


def drive_trainer(dev, cfg, seeds, segs):
    """Phase 13's drive: 2 warm-up steps, then TRAIN_STEPS timed fused steps
    of the default ``UNet3D``, the host clock around a read of each loss, a
    CUDA event at each step's start, at ``train_on``'s entry (the end of the
    generation) and at its end. Returns the numbers, the losses, and each
    timed step's sample seeds and its images and labels."""
    state = tstep.create_train_state(0, UNet3D(), SHAPE, device=dev)
    marks, kept = [], []

    def train_on(state, images, labels):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        kept.append((images, labels))
        return train_on_plain(state, images, labels)

    train_on_plain = tstep.train_on
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tstep.train_on = train_on
    try:
        for i in range(2):
            state, loss = tstep.generate_and_train_step(state, [90 + i], seeds, segs, cfg)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated(dev)
        marks.clear()
        kept.clear()
        reset_counts()
        starts, ends = [], []
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            state, loss = tstep.generate_and_train_step(state, [100 + i], seeds, segs, cfg)
            ev1.record()
            losses.append(float(loss))
            starts.append(ev0)
            ends.append(ev1)
        dt = time.perf_counter() - t0
        launches = launched()
    finally:
        tstep.train_on = train_on_plain
    gen_ms = [a.elapsed_time(m) for a, m in zip(starts, marks)]
    fit_ms = [m.elapsed_time(b) for m, b in zip(marks, ends)]
    numbers = {
        "steps_per_s": TRAIN_STEPS / dt,
        "vol_per_s": TRAIN_STEPS * seeds.shape[0] / dt,
        "generate_ms_p50": statistics.median(gen_ms),
        "train_ms_p50": statistics.median(fit_ms),
        "generate_ms": gen_ms,
        "train_ms": fit_ms,
        "peak_mem_bytes": peak,
        "launches": launches,
        "core_vol_per_s": MEASURED.get("core"),
    }
    return numbers, losses, [[100 + i] for i in range(TRAIN_STEPS)], kept


def train_profile(dev, cfg, seeds, segs, n: int = 2):
    """Phase 13: the kernels of ``n`` fused steps (``torch.profiler``, after
    one warm-up step): kernel time against the host clock, then the
    operators and kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = tstep.create_train_state(0, UNet3D(), SHAPE, device=dev)
    tstep.generate_and_train_step(state, [500], seeds, segs, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            tstep.generate_and_train_step(state, [501 + i], seeds, segs, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = prof.key_averages()
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    log(f"train profiler, {n} steps: kernel time {total_ms:.3f} ms, wall {wall_ms:.3f} ms (profiler on)")
    ops = [e for e in stats if e.device_type != DeviceType.CUDA and e.self_device_time_total > 0]
    for title, rows in (("operator", ops), ("kernel", kernels)):
        for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            ms = e.self_device_time_total / 1e3
            log(f"  train {title} {100 * ms / total_ms:5.1f}% {ms / n:8.3f} ms/step "
                f"{e.count / n:6.1f} calls/step  {e.key[:160]}")
    # the convolutions' and the GroupNorms' device time by their inputs' shapes
    by_shape = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key in ("aten::convolution_backward", "aten::cudnn_convolution", "aten::native_group_norm",
                             "aten::native_group_norm_backward")]
    for e in sorted(by_shape, key=lambda e: e.device_time_total, reverse=True)[:8]:
        log(f"  train by shape {e.device_time_total / 1e3 / n:8.3f} ms/step {e.count / n:4.1f} calls/step "
            f"{e.key} {str(e.input_shapes)[:120]}")


def train_step_record(dev, cfg, seeds, segs, ddp):
    """One fused step of the default ``UNet3D`` from seed 7's weights on
    seed 300's batch: the plain step, or through ``make_sharded_train_step``
    under an NCCL group of world size 1. Returns the loss, the module the
    step ran, the step count and each parameter's (initial weight,
    gradient, weight after the step)."""
    import torch.distributed as dist

    from fetalsyngen_torch.parallel.sharding import data_group

    state = tstep.create_train_state(7, UNet3D(), SHAPE, device=dev)
    init = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    if not ddp:
        _, loss = tstep.generate_and_train_step(state, [300], seeds, segs, cfg)
        module = state.model
    else:
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
            try:
                step = tstep.make_sharded_train_step(state, cfg, data_group(dev))
                loss, module = step([300], seeds, segs), step.module
                torch.cuda.synchronize(dev)
            finally:
                dist.destroy_process_group()
    leaves = {k: (init[k], p.grad.detach().clone(), p.detach().clone()) for k, p in state.model.named_parameters()}
    return float(loss), type(module).__name__, state.step, leaves


def train_ddp_check(dev, cfg, seeds, segs):
    """Phase 13: one step through ``make_sharded_train_step`` under an NCCL
    group of world size 1 against the plain step from the same weights and
    seeds, cuDNN deterministic for both: the losses within DDP_LOSS_RTOL;
    each gradient DDP left on the model within DDP_GRAD_TOL of the plain
    step's leaf's max |g| (DDP's hooks and all-reduce); each weight after
    the step within ADAMW_STEP_TOL of AdamW's first step of its own
    gradient from the initial weight (the update ran on those gradients)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, _, _, plain = train_step_record(dev, cfg, seeds, segs, ddp=False)
        got, wrapped, steps, leaves = train_step_record(dev, cfg, seeds, segs, ddp=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = abs(got - want) / abs(want)
    lr, wd = 1e-3, tstep.ADAMW["weight_decay"]  # create_train_state's default lr
    grad_err, step_err, grads_equal = (0.0, ""), (0.0, ""), True
    for k, (p0, g, p1) in leaves.items():
        g_plain = plain[k][1]
        scale = float(g_plain.abs().max()) or 1.0
        grad_err = max(grad_err, (float((g - g_plain).abs().max()) / scale, k))
        grads_equal &= torch.equal(g, g_plain)
        adamw = p0 * (1 - lr * wd) - lr * g / (g.abs() + 1e-8)
        step_err = max(step_err, (float((p1 - adamw).abs().max()), k))
    log(f"train: world-1 NCCL step ({wrapped}, {steps} step) loss {got:.7f}, plain step {want:.7f}, rel diff "
        f"{rel:.3e} (bar {DDP_LOSS_RTOL}); gradients bit-identical: {grads_equal}, worst leaf {grad_err[1]} "
        f"{grad_err[0]:.3e} of its max |g| (bar {DDP_GRAD_TOL}); weights against AdamW's step of their "
        f"gradients: worst leaf {step_err[1]} {step_err[0]:.3e} (bar {ADAMW_STEP_TOL})")
    if (wrapped != "DistributedDataParallel" or steps != 1 or not rel <= DDP_LOSS_RTOL
            or not grad_err[0] <= DDP_GRAD_TOL or not step_err[0] <= ADAMW_STEP_TOL):
        raise RuntimeError(f"train: the world-1 DDP step disagrees with the plain step "
                           f"({wrapped}, {steps}, {rel}, {grad_err}, {step_err})")


def train_cpu_check(dev):
    """Phase 13: one step at 64^3 of the f32 ``UNet3D`` on the card and on
    the CPU from the same weights, on the card's generated batch (TF32 off):
    the loss within TRAIN_LOSS_RTOL, each gradient within TRAIN_GRAD_TOL of
    its leaf's max |g|."""
    seeds, segs, cfg = train_inputs(dev, TRAIN_CPU_SHAPE)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("train: TF32 is on; the card-against-CPU step needs it off")
    images, labels = tstep.generate([400], seeds, segs, cfg, dev)
    states = [tstep.create_train_state(3, UNet3D(dtype=torch.float32), TRAIN_CPU_SHAPE, device=d)
              for d in (dev, "cpu")]
    t0 = time.perf_counter()
    (_, l_card), (_, l_cpu) = (tstep.train_on(st, images.to(st_dev), labels.to(st_dev))
                               for st, st_dev in zip(states, (dev, "cpu")))
    cpu_s = time.perf_counter() - t0
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    worst = max(
        (float((a.grad.cpu() - b.grad).abs().max()) / float(b.grad.abs().max()), name)
        for (name, a), b in zip(states[0].model.named_parameters(), states[1].model.parameters())
    )
    log(f"train: card vs CPU at {TRAIN_CPU_SHAPE} (f32 UNet3D, TF32 off, {cpu_s:.1f} s): loss {float(l_card):.7f} "
        f"vs {float(l_cpu):.7f}, rel diff {rel:.3e} (bar {TRAIN_LOSS_RTOL}); worst gradient leaf {worst[1]} "
        f"{worst[0]:.3e} of its max |g| (bar {TRAIN_GRAD_TOL})")
    if not rel <= TRAIN_LOSS_RTOL or not worst[0] <= TRAIN_GRAD_TOL:
        raise RuntimeError("train: the card and the CPU disagree beyond the bars")


def train_phase(dev, t_start):
    """Phase 13: the segmentation trainer on the card at full width (the
    default ``UNet3D``, bf16 compute) on the benchmark's generator config at
    256^3, B=1. Returns K1's launches over the timed steps and its kernel
    check at the trainer's shape."""
    seeds, segs, cfg = train_inputs(dev, SHAPE)
    numbers, losses, step_seeds, kept = drive_trainer(dev, cfg, seeds, segs)
    launches = numbers["launches"]
    head = statistics.mean(losses[: len(losses) // 3])
    tail = statistics.mean(losses[-(len(losses) // 3):])
    log(json.dumps({"train": f"UNet3D(16, 32, 64) bf16, {SHAPE[0]}^3 x 1", **numbers, "losses": losses,
                    "loss_first_third": head, "loss_last_third": tail}))
    if launches != counts(**pair_warps(TRAIN_STEPS)):
        raise RuntimeError(f"train: expected {pair_warps(TRAIN_STEPS)} launches and no other, got {launches}")
    if not all(np.isfinite(losses)) or not tail < head:
        raise RuntimeError(f"train: losses not finite or not trending down ({head} -> {tail})")
    for sps, (images, labels) in zip(step_seeds, kept):
        again = tstep.generate(sps, seeds, segs, cfg, dev)
        if not (torch.equal(again[0], images) and torch.equal(again[1], labels)):
            raise RuntimeError(f"train: the generation of step {sps} does not replay bit for bit")
    kept.clear()
    log(f"phase 13 steps done, {TRAIN_STEPS} generations replayed bit for bit, at "
        f"{time.perf_counter() - t_start:.1f} s")
    check = StreamHatCheck()
    with check.on(warp):
        again = tstep.generate(step_seeds[0], seeds, segs, cfg, dev)
    torch.cuda.synchronize()
    log(json.dumps({"train_launch_check": {k: {"calls": check.calls[k], "max_abs_err": check.err[k],
                                                 "elements_differing": check.differ[k]} for k in check.calls}}))
    if dict(check.calls) != {"hat_pass_pair": 3} or any(check.differ.values()) or any(check.err.values()):
        raise RuntimeError(f"train: a K1 launch differs from its plain version: {dict(check.differ)}")
    (xa, xb, coefs, disp), = (v for (k, _), v in check.kept.items() if k == "hat_pass_pair")
    B, D, H, S = xa.shape
    pos = hat._positions_of(coefs, B, D, H, S, disp)
    n_half, n_out = count_positions(pos, S)
    result = compare(
        "train:hat_pass_pair", f"trainer {tuple(xa.shape)}", lambda: hat.hat_pass_pair(xa, xb, coefs, disp),
        lambda: hat.hat_pass_pair_ref(xa, xb, coefs, disp), hat_bound(True, B, D, H, S, S, disp, nearest=True),
        lib=lambda: grid_sample_ms([xa, xb], pos), note=f" half-integer positions={n_half} saturated={n_out}",
    )
    del pos, xa, xb, coefs, disp, again, check
    train_profile(dev, cfg, seeds, segs)
    train_ddp_check(dev, cfg, seeds, segs)
    train_cpu_check(dev)
    return launches["hat_pass_pair"], [result]


SEED_MAX_SUBCLASSES = 6  # configs/dataset/generator/default.yaml's max_subclusters
SEED_STATE = 7  # phase 14's card-against-CPU fit: meta-label 2, k = 6, this random_state
SEED_K = 6
SEED_MEAN_RTOL = 1e-4  # |card - CPU| / |CPU| of each component mean
SEED_LABEL_SHARE = 1e-4  # the share of values whose component differs
SEED_STEM = "sub-sta21_rec-irtk_T2w_dseg_mlabel_{m}.nii.gz"


def _gz_bytes(path) -> bytes:
    import gzip

    with gzip.open(path, "rb") as f:
        return f.read()


def _rank_agreement(image, ours, theirs) -> float:
    """The share of voxels labelled in both seed volumes whose components
    agree once each side's components are ranked by ascending mean
    intensity."""
    both = (ours != 0) & (theirs != 0)

    def ranks(lab):
        on = lab != 0
        values = lab[on].astype(np.int64)
        n = np.bincount(values)
        means = np.bincount(values, weights=image[on]) / np.maximum(n, 1)
        used = np.flatnonzero(n)
        lut = np.zeros(n.size, dtype=np.int64)
        lut[used[np.argsort(means[used], kind="stable")]] = np.arange(used.size)
        return lut[lab[both].astype(np.int64)]

    return float(np.mean(ranks(ours) == ranks(theirs))) if both.any() else 1.0


def timed_fits(fits, picks_s):
    """``gmm.fit_predict`` with each call's size, k, CUDA events and fit
    appended to ``fits``, and ``gmm.kmeans_plusplus`` adding its host
    seconds to ``picks_s``."""
    plain, plain_picks = gmm.fit_predict, gmm.kmeans_plusplus

    def kmeans_plusplus(*a, **kw):
        t0 = time.perf_counter()
        try:
            return plain_picks(*a, **kw)
        finally:
            picks_s.append(time.perf_counter() - t0)

    def fit_predict(x, k, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fit = plain(x, k, **kw)
        e1.record()
        fits.append((int(np.asarray(x).size), k, e0, e1, fit))
        return fit

    return fit_predict, kmeans_plusplus


def seeds_generate(dev, bids: Path, out: Path, image, segm):
    """Phase 14: ``generate_seeds`` on the card (``--annotation feta
    --max_subclasses 6``, every fit's CUDA events), then its tree held: 24
    int8 files, each meta-label's labels in its range, ``subclasses_1``
    against the committed tree (meta-labels 2 and 3 equal, 1 and 4 differing
    exactly on segmentation label 4's voxels), and subclasses 2-6's
    agreement with the committed fits reported (unseeded on both sides)."""
    fits, picks_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    plain = gmm.fit_predict, gmm.kmeans_plusplus
    gmm.fit_predict, gmm.kmeans_plusplus = timed_fits(fits, picks_s)
    t0 = time.perf_counter()
    try:
        generate_seeds.main(["--bids_path", str(bids), "--out_path", str(out), "--max_subclasses",
                             str(SEED_MAX_SUBCLASSES), "--annotation", "feta", "--workers", "4"])
        torch.cuda.synchronize()
    finally:
        gmm.fit_predict, gmm.kmeans_plusplus = plain
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    # a fit's events span its host k-means++ picks and its EM on the card
    fit_ms = [a.elapsed_time(b) for _, _, a, b, _ in fits]
    iters = [f.em.n_iter.tolist() for *_, f in fits]
    log(json.dumps({"generate_seeds": "sub-sta21 feta, max_subclasses 6, on the card", "wall_s": wall_s,
                    "fits": len(fits), "fit_ms_median": statistics.median(fit_ms), "fit_ms_max": max(fit_ms),
                    "fit_ms_sum": sum(fit_ms), "kmeans_plusplus_host_s_sum": sum(picks_s),
                    "em_iterations_per_init_median": statistics.median(sum(iters, [])),
                    "em_iterations_per_init_max": max(sum(iters, [])), "peak_mem_bytes": peak,
                    "per_fit": [{"values": n, "k": k, "ms": ms, "iterations": it, "best": f.best}
                                for (n, k, *_, f), ms, it in zip(fits, fit_ms, iters)]}))
    if len(fits) != 4 * (SEED_MAX_SUBCLASSES - 1):
        raise RuntimeError(f"seeds: expected {4 * (SEED_MAX_SUBCLASSES - 1)} fits, got {len(fits)}")
    files = sorted(out.rglob("*.nii.gz"))
    if len(files) != 4 * SEED_MAX_SUBCLASSES:
        raise RuntimeError(f"seeds: expected {4 * SEED_MAX_SUBCLASSES} files, got {len(files)}")
    meta = np.zeros(segm.shape, dtype=np.int16)
    for a, b in generate_seeds.FETA2META.items():
        meta[segm == a] = b
    meta[(segm == 0) & (image != 0)] = 4
    label4 = segm == 4
    agreement = {}
    for n in range(1, SEED_MAX_SUBCLASSES + 1):
        for m in range(1, 5):
            rel = Path(f"subclasses_{n}") / "sub-sta21" / "anat" / SEED_STEM.format(m=m)
            # C order, as the volumes it is compared with: masks over mixed memory orders are slow
            got = np.ascontiguousarray(nifti.load(out / rel).data)
            values = set(np.flatnonzero(np.bincount(got.ravel().view(np.uint8), minlength=256)).tolist())
            if got.dtype != np.int8 or not values <= {0, *range(10 * m, 10 * m + n)}:
                raise RuntimeError(f"seeds: {rel} is {got.dtype} with labels {sorted(values)}")
            if not np.array_equal((got != 0), meta == m):
                raise RuntimeError(f"seeds: {rel} does not cover meta-label {m}'s voxels")
            committed = np.ascontiguousarray(nifti.load(DATA / "derivatives" / "seeds" / rel).data)
            if n == 1:
                differ = got != committed
                want = int(label4.sum()) if m in (1, 4) else 0
                if int(differ.sum()) != want or (differ & ~label4).any():
                    raise RuntimeError(f"seeds: {rel} differs from the committed tree on {int(differ.sum())} "
                                       f"voxels, {int((differ & ~label4).sum())} outside label 4 (want {want}, 0)")
            else:
                agreement[f"{n}/{m}"] = _rank_agreement(image, got, committed)
    log(f"seeds: subclasses_1 against the committed tree: meta-labels 2, 3 equal; 1, 4 differ on exactly the "
        f"{int(label4.sum())} voxels of segmentation label 4 (the committed tree puts them in the skull class)")
    log(json.dumps({"seeds_agreement_with_committed_by_mean_rank": agreement}))


def seeds_card_vs_cpu(dev, image, segm):
    """Phase 14: meta-label 2 (labels 2 and 6) with k = 6 and one
    ``random_state`` on the card and through the port on the CPU: the same
    k-means++ indices and winning init, each component mean within
    SEED_MEAN_RTOL, labels differing on at most SEED_LABEL_SHARE of the
    values."""
    x = image[(segm == 2) | (segm == 6)]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    card = gmm.fit_predict(x, SEED_K, random_state=SEED_STATE, device=dev)
    e1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = gmm.fit_predict(x, SEED_K, random_state=SEED_STATE, device="cpu")
    cpu_s = time.perf_counter() - t0
    means_card, means_cpu = card.em.means[card.best].cpu(), cpu.em.means[cpu.best]
    rel = float(((means_card - means_cpu).abs() / means_cpu.abs()).max())
    share = float((card.labels.cpu() != cpu.labels).double().mean())
    log(f"seeds: meta-label 2 ({x.size} values), k={SEED_K}, random_state={SEED_STATE}: card {e0.elapsed_time(e1):.3f} "
        f"ms, CPU {cpu_s:.3f} s; indices equal {np.array_equal(card.indices, cpu.indices)}, best {card.best} / "
        f"{cpu.best}, iterations {card.em.n_iter.tolist()} / {cpu.em.n_iter.tolist()}, means rel diff {rel:.3e} "
        f"(bar {SEED_MEAN_RTOL}), labels differing {share:.3e} (bar {SEED_LABEL_SHARE})")
    if (not np.array_equal(card.indices, cpu.indices) or card.best != cpu.best or not rel <= SEED_MEAN_RTOL
            or not share <= SEED_LABEL_SHARE):
        raise RuntimeError("seeds: the card's mixture disagrees with the CPU's beyond the bars")


def synth_train_dataset(dev, bids: Path, seeds: Path):
    """``configs/dataset/synth_train.yaml`` through the port's config loader
    on ``bids`` with ``seed_path`` at ``seeds``, its generator on ``dev``
    without its four SR artifacts."""
    from fetalsyngen_torch.config import instantiate, load_yaml, resolve_interpolations

    cfg = resolve_interpolations(load_yaml(REPO / "configs" / "dataset" / "synth_train.yaml"))
    cfg.update(bids_path=str(bids), seed_path=str(seeds))
    gen = cfg.pop("generator")
    for name in ("blur_cortex", "struct_noise", "simulate_motion", "boundaries"):
        del gen[name]
    gen["device"] = str(dev)
    gen["shape"] = gen["spatial_deform"]["size"] = list(SHAPE)  # the YAML's 256^3 at full size
    return instantiate(cfg, generator=instantiate(gen))


def seeds_phase(dev, t_start):
    """Phase 14: the seed-preparation path on a copy of ``data/sub-sta21``
    (256^3 at 0.5 mm): ``resample``, ``generate_seeds`` on the card, the card
    against the CPU, ``resize_seeds``, one draw of the dataset API from the
    fresh tree and the walkthrough at 64^3. Returns the kernels' launches of
    the draws."""
    from fetalsyngen_torch.examples import generator as walkthrough

    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bids = tmp / "bids"
        shutil.copytree(DATA / "sub-sta21", bids / "sub-sta21")
        t0 = time.perf_counter()
        resample.main(["--bids_path", str(bids), "--out_path", str(tmp / "resampled"), "--target_size",
                       *map(str, SHAPE)])
        resample_s = time.perf_counter() - t0
        written = sorted((tmp / "resampled").rglob("*.nii.gz"))
        for f in written:
            img = nifti.load(f)
            if img.data.shape != SHAPE or not np.array_equal(img.affine, np.diag([0.5, 0.5, 0.5, 1.0])):
                raise RuntimeError(f"seeds: resample wrote {f.name} at {img.data.shape}, affine {img.affine}")
        if len(written) != 2:
            raise RuntimeError(f"seeds: resample wrote {len(written)} files, not 2")
        log(f"seeds: resample of sub-sta21 in {resample_s:.2f} s on the host, 2 files at {SHAPE} and 0.5 mm")

        image, segm, _ = generate_seeds.load_subject(
            bids / "sub-sta21/anat/sub-sta21_rec-irtk_T2w.nii.gz",
            bids / "sub-sta21/anat/sub-sta21_rec-irtk_T2w_dseg.nii.gz", "feta")
        seeds = tmp / "seeds"
        seeds_generate(dev, bids, seeds, image, segm)
        log(f"phase 14 generate_seeds done at {time.perf_counter() - t_start:.1f} s")
        seeds_card_vs_cpu(dev, image, segm)

        before = {f: (_gz_bytes(f), nifti.load(f)) for f in sorted(seeds.rglob("*.nii.gz"))}
        t0 = time.perf_counter()
        resize_seeds.main([str(seeds)])
        resize_s = time.perf_counter() - t0
        for f, (raw, img) in before.items():
            again = nifti.load(f)
            if (_gz_bytes(f)[:352] != raw[:352] or again.data.dtype != img.data.dtype
                    or not np.array_equal(again.data, img.data) or not np.array_equal(again.affine, img.affine)):
                raise RuntimeError(f"seeds: resize_seeds changed {f.name}")
        log(f"seeds: resize_seeds over {len(before)} files in {resize_s:.2f} s: voxels and headers unchanged")
        del before

        ds = synth_train_dataset(dev, bids, seeds)
        torch.cuda.synchronize()
        reset_counts()
        item = ds.sample_with_meta(0)
        drawn = launched()
        reset_counts()
        again = ds.sample_with_meta(0, genparams=item["generation_params"])
        replayed = launched()
        img = item["image"]
        log(f"seeds: synth_train draw from the fresh tree: launches {drawn}, replay {replayed}, image {img.shape} "
            f"[{img.min():.6f}, {img.max():.6f}], labels {sorted(np.unique(item['label']).tolist())}")
        if drawn != counts(**pair_warps(1)) or replayed != drawn:
            raise RuntimeError(f"seeds: expected {pair_warps(1)} launches a draw, got {drawn}, {replayed}")
        if img.shape != (1, *SHAPE) or not np.isfinite(img).all() or img.min() < 0.0 or img.max() > 1.0:
            raise RuntimeError(f"seeds: bad image from the fresh tree {img.shape}")
        if not (np.array_equal(again["image"], img) and np.array_equal(again["label"], item["label"])):
            raise RuntimeError("seeds: the draw from the fresh tree does not replay bit for bit")
        launches.update({k: v for k, v in drawn.items() if v})
        launches.update({k: v for k, v in replayed.items() if v})

        reset_counts()
        walk = walkthrough.main(["--shape", "64", "--out", str(tmp / "walkthrough")])
        walked = {k: v for k, v in hat.LAUNCHES.items() if v}
        for name in ("synth_train", "real_train"):
            w = walk[name]["image"]
            if w.shape != (1, 64, 64, 64) or not np.isfinite(w).all() or w.min() < 0.0 or w.max() > 1.0:
                raise RuntimeError(f"seeds: the walkthrough's {name} image is bad: {w.shape}")
        if walk["reversed"]["image"].shape != walk["testing"]["image"].shape or not walked.get("hat_pass_pair"):
            raise RuntimeError(f"seeds: the walkthrough's testing item or launches are wrong ({walked})")
        log(f"seeds: walkthrough at 64^3 on the card: launches {walked}")
        launches.update(walked)
    return launches


# phase 15: the separable-warp surface at B=4 256^3 onto another grid (OW
# below and above S across the U passes), its card-against-CPU crop, and
# the K1/K2 forms it launches: their kernel entries are "separable:<form>"
SEP_OUT = (240, 256, 272)
SEP_CPU_SHAPE, SEP_CPU_OUT = (64, 64, 64), (60, 64, 68)
SEP_MODES = ((False, True), (False, False), (True, False), (True, True))
SEP_PAIR_FORMS = tuple(hat._PAIR_FORMS[(*m, 0, 0)] for m in SEP_MODES)
SEP_FORMS = ("hat_pass", "hat_pass_bf16", "hat_pass_field_bf16", *SEP_PAIR_FORMS,
             *(f"{f}_bf16" for f in SEP_PAIR_FORMS), "hat_pass_pair_slice_bf16")
for _form in SEP_FORMS:
    KERNELS[f"separable:{_form}"] = KERNELS["hat_pass_pair" if "pair" in _form else "hat_pass"]


def separable_inputs(dev, shape, out_shape, seed=15, batch=BATCH):
    """Phase 15's inputs at ``shape``, B=4 (or ``batch``): a smooth image in
    [0, 100], its labels (8 levels), a near-identity affine of the
    generator's ranges mapping the ``out_shape`` grid's centre onto the
    input's, and three smooth displacement components with a standard
    deviation of 10 voxels (their peaks pass +-FIELD_LIM)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    big = tuple(n + 8 for n in shape)

    def smooth():
        v = F.avg_pool3d(torch.rand((batch, 1, *big), generator=g, device=dev), 9, 1)[:, 0]
        return (v - v.mean()) / v.std()

    img = smooth()
    img = 100.0 * (img - img.min()) / (img.max() - img.min())
    lab = torch.floor(img * 0.0799)
    A = make_affine_matrix(
        (torch.rand((batch, 3), generator=g, device=dev) - 0.5) * (40.0 / 180.0 * np.pi),
        (torch.rand((batch, 3), generator=g, device=dev) - 0.5) * 0.04,
        1.0 + (torch.rand((batch, 3), generator=g, device=dev) - 0.5) * 0.2)
    def centre(grid):
        return (torch.tensor(grid, dtype=torch.float32, device=dev) - 1) / 2

    t = centre(shape) - torch.einsum("bij,j->bi", A, centre(out_shape))
    fields = [10.0 * smooth() for _ in range(3)]
    return img, lab, A, t, fields


def separable_ops(img, lab, A, t, fields, out_shape):
    """The separable-warp surface on one set of inputs: the affine warp of
    the image and the labels onto ``out_shape``, the pair warp in each pair
    of modes, and the displacement warp of each. Returns {(op, modes):
    outputs}."""
    outs = {("affine", (False,)): (warp.warp_affine_separable(img, A, t, False, out_shape),),
            ("affine", (True,)): (warp.warp_affine_separable(lab, A, t, True, out_shape),)}
    for m in SEP_MODES:
        outs[("pair", m)] = warp.warp_affine_separable_pair(lab if m[0] else img, lab if m[1] else img, A, t, m,
                                                            out_shape)
    for nearest in (False, True):
        outs[("displacement", (nearest,))] = (warp.warp_displacement_separable(lab if nearest else img, *fields,
                                                                               nearest),)
    return outs


def separable_path(dev):
    """Phase 15's path: the separable-warp surface at B=4 256^3 onto
    SEP_OUT, in f32 and under ``storage_scope(bf16)``, and the JAX surface's
    paired hat pass (``ops.warp.hat_pass_pair``) with the scanner's per-slice
    table of a 384-cube stack on bf16 rows. Returns the launches of the run
    by form; raises on a wrong count or a non-finite or misshapen output."""
    img, lab, A, t, fields = separable_inputs(dev, SHAPE, SEP_OUT)
    _, _, (D, H, S), coefs, _ = next(x for x in stack_tables(dev, 384, TIER_RS[384], SHAPE) if x[0] == "acquire dv")
    g = torch.Generator(device=dev).manual_seed(151)
    xa, xb = ((100.0 * torch.rand((1, D, H, S), generator=g, device=dev)).to(BF16) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    shapes = {}
    for mode in (None, BF16):
        with linops.storage_scope(mode):
            for key, outs in separable_ops(img, lab, A, t, fields, SEP_OUT).items():
                for o in outs:
                    if not bool(torch.isfinite(o).all()):
                        raise RuntimeError(f"separable {key} {mode}: non-finite output")
                shapes[key] = tuple(outs[0].shape)
                del outs
    warp.hat_pass_pair(xa, xb, coefs, None, nearest_b=False)
    torch.cuda.synchronize()
    got = {k: v for k, v in hat.LAUNCHES.items() if v}
    want = {"hat_pass": 16, "hat_pass_bf16": 10, "hat_pass_field_bf16": 6, "hat_pass_pair_slice_bf16": 1,
            **{f: 5 for f in SEP_PAIR_FORMS}, **{f"{f}_bf16": 5 for f in SEP_PAIR_FORMS}}
    named = {f"{op} {modes}": sh for (op, modes), sh in shapes.items()}
    log(f"separable: launches {json.dumps(got)}; output shapes {json.dumps(named)}")
    if got != want:
        raise RuntimeError(f"separable: launches {got}, expected {want}")
    for (op, _), sh in shapes.items():
        if sh != (BATCH, *(SHAPE if op == "displacement" else SEP_OUT)):
            raise RuntimeError(f"separable: {op} wrote {sh}")
    return {f"separable:{k}": got[k] for k in SEP_FORMS}


def separable_cpu_check(dev):
    """Phase 15: each op of the surface on a 64^3 crop (B=4, onto
    SEP_CPU_OUT) on the card against the port's CPU path on the same inputs,
    f32 and under ``storage_scope(bf16)``: images within IMAGE_TOL of their
    scale (bf16: BF16_ULPS bf16 ulps), labels differing on at most
    LABEL_TOL of the voxels."""
    inputs = separable_inputs(dev, SEP_CPU_SHAPE, SEP_CPU_OUT, seed=16)
    cpu_inputs = [v.cpu() if isinstance(v, torch.Tensor) else [f.cpu() for f in v] for v in inputs]
    worst = {}
    for mode in (None, BF16):
        with linops.storage_scope(mode):
            card = separable_ops(*inputs, SEP_CPU_OUT)
            cpu = separable_ops(*cpu_inputs, SEP_CPU_OUT)
        for (op, modes), outs in card.items():
            for o, c, nearest in zip(outs, cpu[(op, modes)], modes):
                o = o.cpu().float()
                c = c.float()
                if nearest:
                    share = float((o != c).float().mean())
                    bad = share > LABEL_TOL
                    worst[f"{op} {modes} {mode} labels"] = share
                else:
                    scale = float(c.abs().max())
                    err = float((o - c).abs().max()) / scale
                    bad = err > (BF16_ULPS * 2.0**-8 if mode else IMAGE_TOL)
                    worst[f"{op} {modes} {mode} image"] = err
                if bad:
                    raise RuntimeError(f"separable {op} {modes} {mode}: card against CPU {worst}")
    log(f"separable: card against CPU at {SEP_CPU_SHAPE} onto {SEP_CPU_OUT}: {json.dumps(worst)}")


def separable_kernel_checks(dev):
    """Phase 15: each K1/K2 form of the surface at its B=4 256^3 passes (the
    U-z pass writing 272 lanes from 256, the U-x pass 240, the displacement
    warp's x pass) against its plain version: bit-identical, timed with its
    bound and a ``grid_sample`` yardstick; and K1's per-slice bf16 pair at
    the 384-cube stack's table."""
    img, lab, A, t, fields = separable_inputs(dev, SHAPE, SEP_OUT)
    U, _ = ul_decompose(A)
    z = torch.zeros(BATCH, device=dev)
    uz = torch.stack([z, z, U[:, 2, 2], t[:, 2]], 1).contiguous()
    ux = torch.stack([U[:, 0, 1], U[:, 0, 2], U[:, 0, 0], t[:, 0]], 1).contiguous()
    unit = torch.stack([z, z, z + 1, z], 1).contiguous()
    gx = torch.clamp(fields[0], -FIELD_LIM, FIELD_LIM).permute(0, 2, 3, 1).contiguous()
    B, D, H, S = img.shape
    # the first and the second operand of a pair in each mode: distinct
    # tensors (one read twice would come from the L2 cache the second time)
    vols = {(dt, n, op): (lab if n else img).flip(-1 - op).to(dt).contiguous() for dt in (torch.float32, BF16)
            for n in (False, True) for op in (0, 1)}
    cases = []  # (entry, name, pair, modes, coefs, disp, OW, dtype)
    for dt, sfx in ((torch.float32, ""), (BF16, "_bf16")):
        cases += [(f"hat_pass{sfx}", "U-z linear", False, (False,), uz, None, SEP_OUT[2], dt),
                  (f"hat_pass{sfx}", "U-x nearest", False, (True,), ux, None, SEP_OUT[0], dt)]
        field_entry = "hat_pass_field_bf16" if sfx else "hat_pass"
        cases += [(field_entry, f"field x {'nearest' if n else 'linear'}", False, (n,), unit, gx, S, dt)
                  for n in (False, True)]
        cases += [(f"{hat._PAIR_FORMS[(*m, 0, 0)]}{sfx}", f"U-z {m}", True, m, uz, None, SEP_OUT[2], dt)
                  for m in SEP_MODES]
    results = []
    for entry, name, pair, modes, coefs, disp, OW, dt in cases:
        xs = [vols[(dt, m, op)] for op, m in enumerate(modes)]
        if pair:
            run = lambda: hat.hat_pass_pair(*xs, coefs, disp, modes[1], OW, modes[0])  # noqa: E731
            plain = lambda: hat.hat_pass_pair_ref(*xs, coefs, disp, modes[1], OW, modes[0])  # noqa: E731
        else:
            run = lambda: hat.hat_pass(xs[0], coefs, disp, modes[0], OW)  # noqa: E731
            plain = lambda: hat.hat_pass_ref(xs[0], coefs, disp, modes[0], OW)  # noqa: E731
        pos = hat._positions_of(coefs, B, D, H, OW, disp)
        n_half, n_out = count_positions(pos, S)
        nearest_b = modes[-1]
        results.append(compare(
            f"separable:{entry}", name, run, plain,
            hat_bound(pair, B, D, H, S, OW, disp, nearest_b, esize=xs[0].element_size(),
                      nearest_a=pair and modes[0]),
            lib=lambda: grid_sample_ms(xs, pos),
            note=f" B={B} R={D * H} S={S} OW={OW} {dt} half-integer positions={n_half} saturated={n_out}",
        ))
        del pos
    del vols, img, lab, fields, gx
    _, _, (D, H, S), coefs, _ = next(x for x in stack_tables(dev, 384, TIER_RS[384], SHAPE) if x[0] == "acquire dv")
    g = torch.Generator(device=dev).manual_seed(152)
    xa, xb = ((100.0 * torch.rand((1, D, H, S), generator=g, device=dev)).to(BF16) for _ in range(2))
    pos = hat._positions_of(coefs, 1, D, H, S, None)
    n_half, n_out = count_positions(pos, S)
    results.append(compare(
        "separable:hat_pass_pair_slice_bf16", "acquire dv cube 384",
        lambda: hat.hat_pass_pair(xa, xb, coefs, None, nearest_b=False),
        lambda: hat.hat_pass_pair_ref(xa, xb, coefs, None, nearest_b=False),
        hat_bound(True, 1, D, H, S, S, None, esize=2), lib=lambda: grid_sample_ms([xa, xb], pos),
        note=f" R={D * H} S=OW={S} bf16 half-integer positions={n_half} saturated={n_out}",
    ))
    return results


def separable_phase(dev, t_start):
    """Phase 15: the separable-warp surface. Returns (the launches of its
    path by kernel entry, the kernel checks)."""
    launches = separable_path(dev)
    log(f"phase 15 path done at {time.perf_counter() - t_start:.1f} s")
    separable_cpu_check(dev)
    return launches, separable_kernel_checks(dev)


ROW_AFFINE_BATCH = 16  # the benchmark's core cell


def row_affine_passes(A, t):
    """The pair warp's five row-affine passes: (name, slope, amount, bias,
    out_order), as ``warp_affine_field_pair_pre`` runs them."""
    U, L = ul_decompose(A)
    return [("U-z", U[:, 2, 2], 0.0, t[:, 2], "ikj"), ("U-y", U[:, 1, 1], U[:, 1, 2], t[:, 1], "kji"),
            ("U-x i+U02*k", 1.0, U[:, 0, 2], 0.0, "jik"), ("U-x", U[:, 0, 0], U[:, 0, 1], t[:, 0], "kij"),
            ("L-z peel", 1.0, L[:, 2, 1], 0.0, "ijk")]


def bf16_ulps(got, want) -> int:
    """The largest distance of two bf16 tensors in units in the last place."""
    def ordered(x):
        v = x.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v + 32768), v)

    return int((ordered(got) - ordered(want)).abs().max())


def row_affine_check(name, form, run, plain, nbytes, n=20, n_plain=5):
    """One pass: ``run()`` (the kernel) against ``plain()`` (the einsum):
    labels bit-identical, the image within one bf16 ulp (bf16) or 2^-22 of
    its scale (f32 results), or raise; then kernel, fenced and plain ms
    and the bound of ``nbytes``. ``err`` is the image's largest absolute
    difference, ``ulps`` its largest in bf16 ulps (bf16 results)."""
    (ka, kb), (pa, pb) = run(), plain()
    torch.cuda.synchronize()
    err = float((ka.float() - pa.float()).abs().max())
    ulps = None
    if form == "bf16":
        ulps = bf16_ulps(ka, pa)
        ok = ulps <= 1
    else:
        ok = err <= 2.0**-22 * max(float(pa.abs().max()), 1e-30)
    labels = int((kb != pb).sum())
    del ka, kb, pa, pb
    if labels or not ok:
        raise RuntimeError(f"row_affine {name} {form}: {labels} labels differ, image max|d| {err} ulps {ulps}")
    bound_ms, bound_by = bound(nbytes, 0)
    ms, plain_ms = cuda_ms(run, n), cuda_ms(plain, n_plain)
    fenced_ms = ring_profile.one_ms(run, True)
    log(f"kernel row_affine_pair_{form} {name}: labels differing=0 image max|d|={err:.3e} ulps={ulps} "
        f"kernel {ms:.4f} ms (fenced {fenced_ms:.4f} ms, {100 * bound_ms / fenced_ms:.1f}% of bound {bound_ms:.4f} "
        f"ms, host wait {1e3 * (ms - fenced_ms):.1f} us) plain {plain_ms:.4f} ms bound ({bound_by}, {nbytes} bytes)")
    return dict(key=f"row_affine_pair_{form}", err=err, ulps=ulps, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, fenced_ms=fenced_ms)


def row_affine_phase(dev):
    """Phase 16: the row-affine pair pass against the einsum in each form.
    Returns its checks (the main paths count its launches)."""
    B = ROW_AFFINE_BATCH
    img, lab, A, t, _ = separable_inputs(dev, SHAPE, SHAPE, seed=160, batch=B)
    lab = lab.to(torch.int32)
    results = []
    with linops.storage_scope(BF16):
        a, b = img, lab
        for i, (name, slope, amount, bias, order) in enumerate(row_affine_passes(A, t)):
            if i == 4:  # the hat pass's (B, D, W, H) output, read as (B, D, H, W)
                a, b = a.permute(0, 1, 3, 2), b.permute(0, 1, 3, 2)
            xa, xb = a, b
            args = (slope, amount, bias)
            nbytes = (xa.element_size() + xb.element_size() + 2 * 2) * xa.numel()
            results.append(row_affine_check(
                name, "bf16", lambda: warp.row_affine_pass_pair(xa, xb, *args, out_order=order),
                # the parent's path: the first pass on f32 operands (its two copies included)
                lambda: warp._row_affine_matmul_pair(xa.float() if i == 0 else xa, xb.float() if i == 0 else xb,
                                                     *args, out_order=order),
                nbytes))
            a, b = warp.row_affine_pass_pair(xa, xb, *args, out_order=order)
        del a, b, xa, xb
        D, H, W = SHAPE
        zeros = [torch.zeros((B, *sh), device=dev) for sh in ((D, W, H), (D, H, W), (H, W, D))]  # gyT, gz, gxT
        torch.cuda.synchronize()
        reset_counts()
        oa, ob = warp.warp_affine_field_pair_pre(img, lab, A, t, *zeros)
        torch.cuda.synchronize()
    got = {k: v for k, v in row_affine.LAUNCHES.items() if v}
    log(f"row_affine: one warp_affine_field_pair_pre call at B={B} {SHAPE} launched {json.dumps(got)}")
    if got != {"row_affine_pair_bf16": 5} or oa.dtype != BF16 or ob.dtype != torch.int32:
        raise RuntimeError(f"row_affine: pair warp launched {got}, wrote {oa.dtype} {ob.dtype}")
    del oa, ob, zeros, img, lab
    img, lab, A, t, _ = separable_inputs(dev, SHAPE, SHAPE, seed=161, batch=2)
    lab = lab.to(torch.int32)
    for form, scope in (("f32", linops.f32_scope), ("default", lambda: linops.precision_scope(linops.DEFAULT))):
        with scope():
            a, b = img, lab
            for i, (name, slope, amount, bias, order) in enumerate(row_affine_passes(A, t)):
                if i == 4:
                    a, b = a.permute(0, 1, 3, 2), b.permute(0, 1, 3, 2)
                xa, xb, args = a, b, (slope, amount, bias)
                results.append(row_affine_check(
                    f"{name} B=2", form, lambda: warp.row_affine_pass_pair(xa, xb, *args, out_order=order),
                    lambda: warp._row_affine_matmul_pair(xa.float(), xb.float(), *args, out_order=order),
                    (xa.element_size() + xb.element_size() + 2 * 4) * xa.numel(), n=5, n_plain=3))
                a, b = warp.row_affine_pass_pair(xa, xb, *args, out_order=order)
    return results


def mask_check(name, run, plain, nbytes, ops, err, differ, n=20, n_plain=5):
    """One mask kernel's call, checked by the caller (``err`` its output's
    largest absolute difference from the composition's over every voxel,
    ``differ`` the mask decisions apart): kernel, fenced and plain ms
    against the bound of ``nbytes`` and ``ops``."""
    bound_ms, bound_by = bound(nbytes, ops)
    ms, plain_ms = cuda_ms(run, n), cuda_ms(plain, n_plain)
    fenced_ms = ring_profile.one_ms(run, True)
    log(f"kernel {name}: max|d|={err:.3e} mask decisions differing={differ} kernel {ms:.4f} ms (fenced "
        f"{fenced_ms:.4f} ms, {100 * bound_ms / fenced_ms:.1f}% of bound {bound_ms:.4f} ms, host wait "
        f"{1e3 * (ms - fenced_ms):.1f} us) plain {plain_ms:.4f} ms bound ({bound_by}, {nbytes} bytes, {ops} operations)")
    return dict(key=name, err=err, differ=differ, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, fenced_ms=fenced_ms)


def mask_phase(dev):
    """Phase 16: the mask kernels (``kernels.deform_mask``) at B=16 256^3 on
    the benchmark's generator draws (bf16 image in the pair warp's (B, H, W,
    D) layout) against the plain composition (``pair_mask_plain``, then
    ``where``): shift identical, mask on all but 1e-6 of the voxels, image
    equal where the masks agree, output contiguous; then each kernel timed
    (one call, fenced) against its bound and the composition it replaces.
    Bounds: ``mask_apply`` reads and writes the image (2 bytes each a voxel);
    ``mask_shift`` reads the field alone, and per voxel and axis forms H (3
    operations), the coordinate (3) and the min (1)."""
    B = ROW_AFFINE_BATCH
    cfg = bench_cfg()
    gens = tpipe.make_generators(range(160, 160 + B), dev)
    p = sample_params(gens, cfg)
    f_nonlin = tpipe.draw_fields(gens, cfg, dev).nonlin
    A = make_affine_matrix(p.rotations, p.shears, p.scalings)
    h_s = torch.einsum("bij,bjxyz->bixyz", A, tpipe._small_field(p, f_nonlin)).contiguous()
    size = p.size_F_small.contiguous()
    c2 = device_const([(s - 1.0) / 2.0 for s in SHAPE], torch.float32, dev).expand(B, 3)
    g = torch.Generator(device=dev).manual_seed(162)
    a = (100.0 * torch.rand((B, SHAPE[1], SHAPE[2], SHAPE[0]), generator=g, device=dev) + 1.0).to(BF16)
    a = a.permute(0, 3, 1, 2)
    args = (h_s, size, A, c2)
    shift_p, ok = tpipe.pair_mask_plain(*args, SHAPE, True)
    reset_counts()
    shift = deform_mask.mask_shift(*args, SHAPE)
    out = deform_mask.mask_apply(a, *args, shift)
    torch.cuda.synchronize()
    differ = int(((out != 0) != ok).sum())
    agree = (out != 0) == ok
    shift_err = float((shift - shift_p).abs().max())
    apply_err = float((out.float() - torch.where(ok, a, 0.0).float()).abs().max())
    log(f"mask: B={B} {SHAPE} shift {shift.flatten().tolist()} (plain equal: {torch.equal(shift, shift_p)}), "
        f"max|d| {shift_err}, mask decisions differing {differ} of {ok.numel()}, image max|d| {apply_err}, inside "
        f"{float(ok.float().mean()):.4f}, launches {json.dumps(dict(deform_mask.LAUNCHES))}")
    if (not torch.equal(shift, shift_p) or differ > 1e-6 * ok.numel() or not out.is_contiguous()
            or not torch.equal(out[agree], torch.where(ok, a, 0.0)[agree])
            or deform_mask.LAUNCHES != {"mask_shift": 1, "mask_apply": 1}):
        raise RuntimeError(f"mask: the kernels differ from the plain composition ({differ} mask decisions)")
    del out, agree, shift_p
    voxels = B * SHAPE[0] * SHAPE[1] * SHAPE[2]
    results = [
        mask_check("mask_shift", lambda: deform_mask.mask_shift(*args, SHAPE),
                   lambda: tpipe.pair_mask_plain(*args, SHAPE, True), h_s.numel() * 4, 21 * voxels, shift_err, 0),
        mask_check("mask_apply", lambda: deform_mask.mask_apply(a, *args, shift), lambda: torch.where(ok, a, 0.0),
                   4 * voxels, 33 * voxels, apply_err, differ),
    ]
    return results


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the production mode's bf16 GEMMs then sum in f32 with a bf16 result
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}; "
        f"bf16 bmm with an f32 result (aten::bmm.dtype): {'dtype' in torch.ops.aten.bmm.overloads()}")

    t_start = time.perf_counter()
    libs = build.build()
    log(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t_start:.2f} s")

    cfg = bench_cfg()
    checks = check_kernel(dev, cfg) + check_single_kernel(dev, cfg)
    checks += check_scanner_kernels(dev)
    checks += check_new_hat_forms(dev)
    checks += check_bf16_kernels(dev, cfg)
    check_hat_tiles(dev)
    check_pair_tiles(dev)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    seeds_np, seg_np = phantom_seeds_and_seg(SHAPE)
    launches, seeds, segs = run_slice(dev, cfg, seeds_np, seg_np)
    for k, v in production_core(dev, cfg, seeds, segs).items():
        launches[k] += v
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    for mode in MODES:
        time_slice(dev, cfg, seeds, segs, mode)
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
    for k, v in stream_path(dev, t_start).items():
        launches[k] += v
    log(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
    stream_launches, stream_checks = stream_artifacts_path(dev, t_start)
    launches.update(stream_launches)
    checks += stream_checks
    log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    t13 = time.perf_counter()
    launches["train:hat_pass_pair"], train_checks = train_phase(dev, t_start)
    checks += train_checks
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t13:.1f} s)")
    t14 = time.perf_counter()
    for k, v in seeds_phase(dev, t_start).items():
        launches[k] += v
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t14:.1f} s)")
    t15 = time.perf_counter()
    sep_launches, sep_checks = separable_phase(dev, t_start)
    launches.update(sep_launches)
    checks += sep_checks
    log(f"phase 15 done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t15:.1f} s)")
    t16 = time.perf_counter()
    checks += row_affine_phase(dev)
    checks += mask_phase(dev)
    log(f"phase 16 done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t16:.1f} s)")
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
            **({"max_bf16_ulps": max(r["ulps"] for r in rs)} if rs[0].get("ulps") is not None else {}),
            **({"mask_decisions_differing": max(r["differ"] for r in rs)} if "differ" in rs[0] else {}),
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
