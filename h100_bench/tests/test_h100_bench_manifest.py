"""``BENCHMARK.json``'s rules, and a cell, configuration, traffic, metric
and span added by adding files and entries alone."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

from h100_bench import manifest, runner
from h100_bench.manifest import HERE, ManifestError, read_json, validate
from h100_bench.spans import Recorder

ROOT = HERE.parent


@pytest.fixture
def doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_benchmark_validates(doc):
    validate(doc, ROOT)
    bench = manifest.Benchmark(doc)
    for w in doc["workloads"]:
        read_json("configs", w["config"])
        read_json("traffic", w["traffic"])
        assert read_json("checks", w["name"])["limits"]
        for m in bench.metrics(w["name"], False) + bench.metrics(w["name"], True):
            assert runner.load_reader(m["name"]) is not None, m["name"]
    for p in (HERE / "spans").glob("*.json"):
        assert {"layer", "targets", "clock"} <= set(json.loads(p.read_text()))


@pytest.mark.parametrize("edit, message", [
    (lambda d: d["workloads"][0].update(name="core stream"), "not a name"),
    (lambda d: d["workloads"][0].update(name="a/b"), "not a name"),
    (lambda d: d["end_to_end"][0].update(unit="volumes per second"), "unit"),
    (lambda d: d["end_to_end"][0].update(unit="a" * 17), "unit"),
    (lambda d: d["end_to_end"][0].update(unit="µs"), "unit"),
    (lambda d: d["end_to_end"][0].update(why="x"), "keys"),
    (lambda d: d["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda d: d["end_to_end"][0].update(source="program_span"), "source"),
    (lambda d: d["per_layer"][0].update(moves="peak_mem_gib_x"), "moves unknown"),
    (lambda d: d["per_layer"][0].update(workloads=["synth_train.stream.b4"]), "does not report vol_per_s"),
    (lambda d: d["end_to_end"].pop(3), "setup_s"),
    (lambda d: d.update(extra=1), "keys"),
    (lambda d: d["workloads"][1].update(config="fsg_core_256", traffic="stream.b16"), "twice"),
    (lambda d: d.update(run_seconds=52), "run_seconds"),
])
def test_the_rules_refuse(doc, edit, message):
    edit(doc)
    with pytest.raises(ManifestError, match=message):
        validate(doc)


def test_at_most_a_quarter_of_cells_on_four_chips(doc):
    four = copy.deepcopy(doc)
    four["workloads"][0]["chips"] = 4  # one four-chip cell is always allowed
    validate(four)
    four["workloads"][1]["chips"] = 4
    with pytest.raises(ManifestError, match="four chips"):
        validate(four)
    for i in range(6):  # 8 cells: two on four chips is 25%
        w = dict(doc["workloads"][0], name=f"extra.{i}", traffic=f"extra.{i}", chips=1)
        four["workloads"].append(w)
        for m in four["end_to_end"] + four["per_layer"]:
            if doc["workloads"][0]["name"] in m.get("workloads", []):
                m["workloads"].append(w["name"])
    validate(four)


def test_a_cell_added_by_files_and_entries_alone(doc, tmp_path):
    """A new configuration, traffic mix, cell, metric and span: files added
    beside copies of the existing ones, entries added to the manifest; no
    file that is there is edited."""
    base = tmp_path / "h100_bench"
    for kind in ("configs", "traffic", "checks", "metrics", "spans"):
        shutil.copytree(HERE / kind, base / kind)
    cfg = read_json("configs", "fsg_core_256")
    cfg["name"] = "fsg_core_256_f32"
    cfg["env"]["FSG_STREAM_BF16"] = "0"
    (base / "configs" / "fsg_core_256_f32.json").write_text(json.dumps(cfg))
    t = read_json("traffic", "stream.b16")
    t["batch_size"] = 8
    (base / "traffic" / "stream.b8.json").write_text(json.dumps(t))
    (base / "checks" / "core_f32.stream.b8.json").write_text(json.dumps({"limits": {"image_rel_l2": 0.01}}))
    (base / "metrics" / "batches_per_s.core_f32.py").write_text(
        "def read(ctx):\n    return ctx['batches'] / ctx['window_s']\n")
    (base / "spans" / "gamma.json").write_text(json.dumps(
        {"layer": "core", "targets": ["fetalsyngen_torch.generator.pipeline:gamma_stage"], "clock": "host"}))

    doc["configs"].append({"name": "fsg_core_256_f32", "source": cfg["source"],
                           "file": "h100_bench/configs/fsg_core_256_f32.json", "reduced": [], "why": "f32 mode"})
    doc["workloads"].append({"name": "core_f32.stream.b8", "config": "fsg_core_256_f32", "traffic": "stream.b8",
                             "chips": 1, "why": "the f32 mode at B=8"})
    doc["end_to_end"][0]["workloads"].append("core_f32.stream.b8")
    doc["per_layer"].append({"name": "batches_per_s.core_f32", "unit": "batch/s", "better": "higher",
                             "source": "host_clock", "layer": "stream", "moves": "vol_per_s",
                             "workloads": ["core_f32.stream.b8"]})
    validate(doc)
    bench = manifest.Benchmark(doc)
    assert [m["name"] for m in bench.metrics("core_f32.stream.b8", True)] == ["batches_per_s.core_f32"]
    assert read_json("traffic", "stream.b8", base)["batch_size"] == 8
    assert read_json("configs", "fsg_core_256_f32", base)["env"]["FSG_STREAM_BF16"] == "0"
    read = runner.load_reader("batches_per_s.core_f32", base)
    assert read({"batches": 10, "window_s": 4.0}) == 2.5
    rec = Recorder()
    rec.install(["gamma"], base)
    try:
        assert rec.active("gamma")
        import fetalsyngen_torch.generator.pipeline as pipeline

        assert pipeline.gamma_stage.__wrapped__ is not None
    finally:
        rec.uninstall()
    assert not hasattr(pipeline.gamma_stage, "__wrapped__")


def test_a_span_whose_target_is_gone_stays_inactive(tmp_path):
    (tmp_path / "spans").mkdir()
    (tmp_path / "spans" / "gone.json").write_text(json.dumps(
        {"layer": "core", "targets": ["fetalsyngen_torch.generator.pipeline:no_such_stage"], "clock": "host"}))
    rec = Recorder()
    rec.install(base=tmp_path)
    assert not rec.active("gone") and rec.between("gone", 0, 1) is None
    read = runner.load_reader("hat_roofline.core")
    ctx = {"untraced": {"t0": 0.0, "t1": 1.0, "batches": 1, "volumes": 16}, "recorder": rec,
           "device_kind": "NVIDIA H100 80GB HBM3"}
    assert read(ctx) is None


def test_config_files_state_their_source(doc):
    for c in doc["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and cfg["name"] == c["name"]
        assert Path(ROOT / cfg["dataset"]["bids_path"]).exists()
