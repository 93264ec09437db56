"""What decides ``correct``: the served batch against the plain reference.

The compared batch is one the window served, copied as it was served. The
reference (:mod:`.reference.stream`, which imports neither the port nor
JAX) works out that batch's host draws again from the run's seed, reads
the seed volumes itself and computes each element alone in f32. The
numbers:

- ``image_rel_l2``: the batch's relative L2 distance of the images,
  ``|served - reference| / |reference|`` over all its voxels;
- ``image_rel_l2_worst``: the largest of the same taken per element;
- ``label_mismatch``: the share of voxels whose label differs;
- ``label_mismatch_worst``: the largest of the same taken per element, so
  that a fault in one element's labels is not diluted by the others.

``checks/<workload>.json`` gives each compared number its limit; a number
without one is printed but decides nothing. A run with no compared batch,
or a number that is not finite, is not correct.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

from .reference import stream as ref


def reference_batch(config: dict, traffic: dict, seed: int, index: int, device, mode=None):
    """The reference's images and labels of batch ``index``, one element at a
    time: a generator of (j, image, label)."""
    gen = config["dataset"]["generator"]
    spec = ref.stream_spec(gen)
    bids = Path(config["dataset"]["bids_path"])
    seed_path = Path(config["dataset"]["seed_path"])
    subjects = sorted(p.name for p in bids.glob("sub-*") if p.is_dir())
    sub_list = config["dataset"].get("sub_list")
    if sub_list is not None:
        subjects = sorted(set(subjects) & set(sub_list))
    B = int(traffic["batch_size"])
    meta = ref.batch_meta(spec, seed, B, index, n_subjects=len(subjects),
                          mix_subjects=min(int(traffic.get("mix_subjects", 1)), len(subjects)))
    seeds = {}
    for j in range(B):
        name = subjects[meta["resident"][int(meta["subj"][j])]]
        if name not in seeds:
            seeds[name] = ref.Seeds(bids, seed_path, name)
        image, label = ref.sample(spec, seeds[name], meta, j, device, mode)
        yield j, image, label


def distances(pairs) -> dict:
    """The compared numbers over (served image, served label, reference
    image, reference label) tuples, one per element."""
    err2 = ref2 = 0.0
    worst = 0.0
    mismatch = voxels = 0
    worst_label = 0.0
    for image, label, r_image, r_label in pairs:
        e = float((image.float() - r_image).square().sum())
        r = float(r_image.square().sum())
        err2 += e
        ref2 += r
        worst = max(worst, math.sqrt(e / r) if r > 0 else math.inf)
        wrong = int((label != r_label).sum())
        mismatch += wrong
        voxels += label.numel()
        worst_label = max(worst_label, wrong / label.numel())
    return {
        "image_rel_l2": math.sqrt(err2 / ref2) if ref2 > 0 else math.inf,
        "image_rel_l2_worst": worst,
        "label_mismatch": mismatch / voxels,
        "label_mismatch_worst": worst_label,
    }


def compare(config: dict, traffic: dict, keeper, seed: int, device) -> dict:
    """The compared numbers of the kept batch."""
    def pairs():
        for j, r_image, r_label in reference_batch(config, traffic, seed, keeper.index, device):
            yield keeper.image[j].to(device), keeper.label[j].to(device), r_image, r_label

    return distances(pairs())


def judge(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit (the limits of
    ``checks/<workload>.json``), and whether all are within."""
    checks = {}
    ok = bool(numbers)
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None:
            print(f"info {name} = {value!r} (not compared)", file=sys.stderr)
            continue
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    if not numbers:
        print("check: no batch was compared", file=sys.stderr)
    return checks, ok


def print_checks(checks: dict) -> None:
    """Each compared number beside its limit, on standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
