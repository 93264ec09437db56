"""The cohort cell, ``cohort80.stream.b16``: its tree of links (under
``cohorts/``, outside the benchmark's paths, whose files are all regular
files), the frozen
reference against the stream over a cohort of aliases at 32^3 with every
subject resident, a traced run reporting the cell's per-layer metrics (its
own and the core's, whose readers do not depend on the cell), its readers
on crafted records (and on a program that records none of them), and the
tree's links kept as links by ``git archive``."""

from __future__ import annotations

import io
import os
import subprocess
import tarfile
import time
from pathlib import Path

import pytest
import torch

from h100_bench import runner
from h100_bench.check import reference_batch
from h100_bench.manifest import HERE, load, read_json
from h100_bench.tests import tiny

ROOT = HERE.parent
DATA = ROOT / "data"
COHORT = ROOT / "cohorts" / "feta80"
CELL = "cohort80.stream.b16"
CONFIG = "fsg_core_feta80_256"
TRAFFIC = "stream.b16.mix80"
NEW = ("bank_fill_s.cohort", "bank_gib.cohort", "bank_fills_per_batch.cohort")
SEED = 2**31 + 21


def test_the_cohort_tree_is_80_subjects_of_relative_links_into_data():
    config = read_json("configs", CONFIG)
    assert (ROOT / config["dataset"]["bids_path"]).resolve() == COHORT.resolve()
    subjects = sorted(p.name for p in COHORT.glob("sub-*") if p.is_dir())
    assert subjects == [f"sub-feta{i:02d}" for i in range(1, 81)]
    entries = [p for p in COHORT.rglob("*") if not p.is_dir() or p.is_symlink()]
    assert len(entries) == 2080 == 80 * (2 + 6 * 4)
    data = DATA.resolve()
    for p in entries:
        assert p.is_symlink() and not os.path.isabs(os.readlink(p)), p
        target = p.resolve()
        assert target.is_file() and target.is_relative_to(data), p
        assert not target.is_relative_to(COHORT.resolve()), p
    one = {p.name for p in (data / "sub-sta21" / "anat").iterdir()}
    assert {p.name.replace("sub-feta07", "sub-sta21") for p in (COHORT / "sub-feta07" / "anat").iterdir()} == one
    # the dataset's own discovery: 80 subjects, six options each
    ds = runner.build_dataset(tiny.config(CONFIG, COHORT))
    assert sorted(ds.seed_paths) == subjects
    assert all(sorted(v) == [1, 2, 3, 4, 5, 6] for v in ds.seed_paths.values())


def test_the_benchmark_holds_regular_files_alone():
    """The cohort's links live outside the benchmark's paths: a link there
    could lead to a file that changes under the benchmark."""
    for path in load(ROOT / "BENCHMARK.json").doc["paths"]:
        for p in (ROOT / path).rglob("*"):
            if "__pycache__" in p.parts:
                continue
            assert not p.is_symlink() and (p.is_dir() or p.is_file()), p


def test_git_archive_keeps_the_links_as_links():
    try:
        out = subprocess.run(["git", "archive", "HEAD", "--", "cohorts/feta80"], cwd=ROOT,
                             capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"git archive did not run: {e}")
    if out.returncode != 0 or not out.stdout:
        pytest.skip(f"no committed cohort tree to archive here: {out.stderr.decode(errors='replace')[:200]}")
    with tarfile.open(fileobj=io.BytesIO(out.stdout)) as tar:
        members = [m for m in tar.getmembers() if not m.isdir()]
    assert len(members) == 2080 and all(m.issym() and m.size == 0 for m in members)
    assert len(out.stdout) < 8 << 20  # tar headers of links: 80 copies of the subject would be 600 MB


def alias_cohort(root: Path, n: int) -> Path:
    """A cohort of ``n`` subjects under ``root``, each a set of relative
    links to one of the tiny tree's two subjects (alternating), as the
    cohort tree links to ``data/``."""
    base = tiny.tree(root / "tiny")
    cohort = root / "cohort"
    if cohort.exists():
        return cohort
    for i in range(n):
        src = ("sub-aaa", "sub-bbb")[i % 2]
        name = f"sub-alias{i:02d}"
        for f in sorted(base.rglob(f"*{src}*")):
            if f.is_dir():
                continue
            rel = f.relative_to(base)
            dst = cohort / Path(*(part.replace(src, name) for part in rel.parts))
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.symlink_to(os.path.relpath(f, dst.parent))
    return cohort


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return alias_cohort(tmp_path_factory.mktemp("alias32"), 6)


@pytest.fixture(autouse=True)
def one_warmup_batch(monkeypatch):
    monkeypatch.setattr(runner, "WARMUP_BATCHES", 1)


def test_reference_equals_the_stream_over_the_whole_cohort(cohort, monkeypatch):
    """Every subject resident (``mix_subjects`` = the cohort): each element
    of the stream's f32 batches equals the frozen reference's, which reads
    its subject's seeds itself; two subjects that share their files are two
    banks."""
    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    config, traffic = tiny.config(CONFIG, cohort), tiny.traffic(TRAFFIC, batch_size=4)
    stream = SyntheticStream(runner.build_dataset(config), batch_size=4, seed=SEED,
                             mix_subjects=int(traffic["mix_subjects"]))
    it = iter(stream)
    batches = [next(it) for _ in range(3)]
    it.close()
    assert stream.mix_subjects == 6 and len(stream.banks.records) == 6 == stream.banks.capacity
    assert len(set(stream.banks.slots(stream._names))) == 6
    for index, batch in enumerate(batches):
        for j, image, label in reference_batch(config, traffic, SEED, index, "cpu"):
            assert torch.equal(image, batch["image"][j])
            assert torch.equal(label, batch["label"][j])
    assert len({n for b in batches for n in b["name"]}) > 2


def test_a_traced_run_of_the_cell_reports_its_metrics(cohort):
    bench = load(ROOT / "BENCHMARK.json")
    metrics = bench.metrics(CELL, trace=True)
    names = [m["name"] for m in metrics]
    assert names[-3:] == list(NEW)
    assert names[:-3] == [m["name"] for m in bench.metrics("core.stream.b16", trace=True)]
    traffic = tiny.traffic(TRAFFIC)
    traffic["trace_seconds"] = 1.0
    t0 = time.perf_counter()
    r = runner.run(bench.workload(CELL), tiny.config(CONFIG, cohort), traffic, read_json("checks", CELL)["limits"],
                   metrics, SEED, 4.0, True, lambda: time.perf_counter() - t0, "cpu")
    got = r["metrics"]
    assert got["bank_fill_s.cohort"]["value"] > 0
    assert got["bank_gib.cohort"]["value"] == 6 * 2 * 4 * 32**3 / 2**30  # six slots of two options
    assert got["bank_fills_per_batch.cohort"]["value"] == 0
    assert got["bank_build_s"]["value"] > 0 and got["producer_ms_per_batch.core"]["value"] > 0
    # no CUDA clock, no device trace on the CPU
    assert "deform_card_ms_per_vol.core" not in got and "device_idle_pct.core" not in got
    assert r["correct"], r["checks"]


def _rec(name, t0, t1, ms=None, **attrs):
    r = {"name": name, "t0": t0, "t1": t1, "attrs": attrs, "batch": 0, "thread": 1, "id": 0, "parent": None}
    if ms is not None:
        r["ms"] = ms
    return r


def _ctx(records, t0=10.0, t1=20.0, batches=2, batch_size=4):
    return {"untraced": {"t0": t0, "t1": t1, "batches": batches, "volumes": batches * batch_size},
            "batch_size": batch_size, "program_spans": records, "trace": None, "device_kind": "cpu"}


def _read(name, ctx):
    return runner.load_reader(name)(ctx)


def test_the_readers_on_crafted_records():
    G = 2**30
    recs = [
        _rec("bank.fill", 1.0, 4.5, subjects=80, bytes=80, threads=8),
        _rec("stream.compose", 2.0, 2.1, ms=1.0, subjects=16, filled=80, slab_bytes=3 * G),  # set-up
        _rec("bank.fill", 12.0, 12.5, subjects=1, bytes=1, threads=1),
        _rec("stream.compose", 10.5, 10.6, ms=4.0, subjects=15, filled=0, slab_bytes=30 * G),
        _rec("stream.compose", 12.5, 12.6, ms=6.0, subjects=16, filled=1, slab_bytes=30 * G),
    ]
    ctx = _ctx(recs)
    assert _read("bank_fill_s.cohort", ctx) == pytest.approx(3.5)
    assert _read("bank_gib.cohort", ctx) == 30.0
    assert _read("bank_fills_per_batch.cohort", ctx) == 0.5
    # a program whose spans carry none of the counts (the parent's compose
    # span has no attributes, and it has no bank.fill): nothing, no error
    bare = [_rec("stream.compose", 10.5, 10.6, ms=4.0), _rec("stream.compose", 12.5, 12.6, ms=6.0)]
    for name in NEW:
        assert _read(name, _ctx(bare)) is None
    # no records, or no untraced window: nothing but set-up's fill
    assert all(_read(m, _ctx(None)) is None and _read(m, _ctx([])) is None for m in NEW)
    assert [m for m in NEW if _read(m, _ctx(recs, t0=None)) is not None] == ["bank_fill_s.cohort"]
