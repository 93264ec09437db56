"""The readers of the program's own spans (``h100_bench.program_spans``) on
the CPU: their arithmetic on crafted records, a traced run of each cell at
32^3 that turns the program's tracing on and reports the host metrics, and
a tree without ``fetalsyngen_torch.trace`` (an older program) on which the
span stays inactive and every reader returns None."""

from __future__ import annotations

import sys
import time

import pytest

from h100_bench import program_spans, runner
from h100_bench.manifest import HERE, load, read_json
from h100_bench.spans import Recorder
from h100_bench.tests import tiny

NEW = {
    "core.stream.b16": ("produce_host_ms_per_batch.core", "join_wait_ms_per_batch.core",
                        "deform_card_ms_per_vol.core", "resample_card_ms_per_vol.core"),
    "synth_train.stream.b4": ("motion_host_ms_per_stack.artifacts", "motion_stacks_per_vol.artifacts",
                              "sync_wait_ms_per_batch.artifacts"),
}
ALL = [m for names in NEW.values() for m in names]


def _rec(name, t0, t1, ms=None, **attrs):
    r = {"name": name, "t0": t0, "t1": t1, "attrs": attrs, "batch": 0, "thread": 1, "id": 0, "parent": None}
    if ms is not None:
        r["ms"] = ms
    return r


def _ctx(records, t0=10.0, t1=20.0, batches=2, batch_size=4):
    return {"untraced": {"t0": t0, "t1": t1, "batches": batches, "volumes": batches * batch_size},
            "batch_size": batch_size, "program_spans": records}


def _read(name, ctx):
    return runner.load_reader(name)(ctx)


def test_readers_on_crafted_records():
    recs = [
        _rec("stream.produce", 9.0, 9.5, ms=500.0, volumes=4),  # before the untraced window: left out
        _rec("stream.produce", 10.0, 10.14, ms=150.0, volumes=4),
        _rec("stream.produce", 11.0, 11.16, ms=154.0, volumes=4),
        _rec("stream.join", 11.0, 11.002), _rec("stream.join", 12.0, 12.004),
        _rec("core.deform", 10.01, 10.02, ms=16.0), _rec("core.deform", 11.01, 11.02, ms=18.0),
        _rec("core.resample_noise", 10.05, 10.06, ms=12.0),
        _rec("chain.motion", 10.1, 10.2, ms=1.0, stacks_attempted=5, stacks_accepted=3),
        _rec("chain.motion", 10.2, 10.3, ms=1.0), _rec("chain.motion", 11.1, 11.2, ms=1.0),
        _rec("chain.motion", 11.2, 11.3, ms=1.0, stacks_attempted=2, stacks_accepted=1),
        _rec("motion.stack", 10.11, 10.14), _rec("motion.stack", 10.15, 10.17), _rec("motion.stack", 10.18, 10.19),
        _rec("motion.stack", 11.21, 11.25),
        _rec("chain.sync", 10.09, 10.1), _rec("stream.produce", 20.0, 20.1),  # at t1: left out
    ]
    ctx = _ctx(recs)
    produce = _read("produce_host_ms_per_batch.core", ctx)
    assert produce["value"] == pytest.approx(150.0) and produce["batches"] == 2
    assert produce["card_ms"] == pytest.approx(152.0)
    assert produce["card_ms_per_vol"]["core.deform"] == pytest.approx(34.0 / 8)
    assert produce["card_ms_per_vol"]["core.gamma"] is None
    assert _read("join_wait_ms_per_batch.core", ctx) == pytest.approx(3.0)
    assert _read("deform_card_ms_per_vol.core", ctx) == pytest.approx(34.0 / 8)
    assert _read("resample_card_ms_per_vol.core", ctx) == pytest.approx(12.0 / 4)
    assert _read("motion_host_ms_per_stack.artifacts", ctx) == pytest.approx((30 + 20 + 10 + 40) / 4)
    assert _read("motion_stacks_per_vol.artifacts", ctx) == pytest.approx(4 / 4)
    assert _read("sync_wait_ms_per_batch.artifacts", ctx) == pytest.approx(10.0 / 2)
    # host spans only (no CUDA clock): the card metrics report nothing
    host = _ctx([{k: v for k, v in r.items() if k != "ms"} for r in recs])
    assert _read("deform_card_ms_per_vol.core", host) is None
    assert "card_ms" not in _read("produce_host_ms_per_batch.core", host)
    # no untraced window, or no records: nothing
    for ctx in (_ctx(recs, t0=None), _ctx(recs, batches=0), _ctx(None), _ctx([])):
        assert all(_read(m, ctx) is None for m in ALL)


def _run(cell, root, metrics, seconds=4.0, trace_seconds=1.0):
    name, traffic_name = {"core.stream.b16": ("fsg_core_256", "stream.b16"),
                          "synth_train.stream.b4": ("fsg_synth_train_256", "stream.b4")}[cell]
    traffic = tiny.traffic(traffic_name)
    traffic["trace_seconds"] = trace_seconds
    workload = load(HERE.parent / "BENCHMARK.json").workload(cell)
    t0 = time.perf_counter()
    return runner.run(workload, tiny.config(name, root), traffic, read_json("checks", cell)["limits"], metrics,
                      2**31 + 5, seconds, True, lambda: time.perf_counter() - t0, "cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bids32"))


@pytest.fixture(autouse=True)
def one_warmup_batch(monkeypatch):
    monkeypatch.setattr(runner, "WARMUP_BATCHES", 1)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_program_spans(cell, root):
    from fetalsyngen_torch import trace

    bench = load(HERE.parent / "BENCHMARK.json")
    r = _run(cell, root, bench.metrics(cell, trace=True))
    got = r["metrics"]
    assert not trace.enabled() and trace.drain() == []  # the readers drained and turned it off
    if cell == "core.stream.b16":
        assert got["produce_host_ms_per_batch.core"]["value"] > 0
        assert got["join_wait_ms_per_batch.core"]["value"] >= 0
        # no CUDA clock on the CPU
        assert "deform_card_ms_per_vol.core" not in got and "card_ms" not in got["produce_host_ms_per_batch.core"]
    else:
        stacks = got["motion_stacks_per_vol.artifacts"]["value"]
        assert stacks >= 0 and got["sync_wait_ms_per_batch.artifacts"]["value"] >= 0
        assert ("motion_host_ms_per_stack.artifacts" in got) == (stacks > 0)
    assert r["correct"], r["checks"]


def test_an_untraced_run_leaves_the_program_untraced(root):
    from fetalsyngen_torch import trace

    t0 = time.perf_counter()
    workload = load(HERE.parent / "BENCHMARK.json").workload("core.stream.b16")
    runner.run(workload, tiny.config("fsg_core_256", root), tiny.traffic("stream.b16"), {}, [], 3, 1.0, False,
               lambda: time.perf_counter() - t0, "cpu")
    assert not trace.enabled() and trace.drain() == []


def test_a_program_without_spans_reports_none(monkeypatch):
    """An older tree: no ``fetalsyngen_torch.trace`` to import."""
    import fetalsyngen_torch

    monkeypatch.delattr(fetalsyngen_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "fetalsyngen_torch.trace", None)
    rec = Recorder()
    rec.install(["program"])
    try:
        assert not rec.active("program") and rec.missing["program"] == ["h100_bench.program_spans:switch"]
    finally:
        rec.uninstall()
    ctx = _ctx(None)
    del ctx["program_spans"]
    assert program_spans.records(ctx) is None
    assert all(_read(m, ctx) is None for m in ALL)


def test_the_switch_turns_the_program_spans_on(monkeypatch):
    from fetalsyngen_torch import trace

    rec = Recorder()
    rec.install(["program"])
    try:
        assert rec.active("program") and trace.enabled()
    finally:
        rec.uninstall()
    with trace.span("stream.produce", volumes=4):
        pass
    ctx = _ctx(None, t0=0.0, t1=float("inf"))
    del ctx["program_spans"]
    [produce] = program_spans.records(ctx)
    assert produce["name"] == "stream.produce" and not trace.enabled()
    assert program_spans.records(ctx) == [produce]  # drained once a run
    rec = Recorder()
    rec.install(["program"])  # a second run in one process turns it on again
    try:
        assert trace.enabled()
    finally:
        rec.uninstall()
        trace.disable()
        trace.drain()
