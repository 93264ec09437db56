"""The port's spans (``fetalsyngen_torch.trace``) on a tiny CPU stream with
the four SR artifacts: off they record nothing and change nothing; on, they
nest as the layers do, carry each batch's draw index on the producer's and
the consumer's thread, count the motion engine's stacks, and lie on
``torch.profiler``'s timeline under their names. Nothing here is timed."""

import json
import os

import numpy as np
import pytest
import torch

from fetalsyngen_torch import trace
from fetalsyngen_torch.data.datasets import FetalSynthDataset
from fetalsyngen_torch.generator import model
from fetalsyngen_torch.generator.artifacts import quality as tq
from fetalsyngen_torch.generator.artifacts import scanner as tsc
from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream
from fetalsyngen_torch.testing import build_bids_tree

torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 8) // 4)))

SHAPE = (32, 32, 32)
LABELS = [0] + list(range(10, 50))
GEN_CLASSES = [0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))
# every artifact on, the motion engine on every sample
FORCED = {"artifacts": {"blur_cortex": {"apply": True}, "struct_noise": {"apply": True},
                        "boundaries": {"apply": True}, "simulate_motion": {"apply": True}}}
CORE = ["core.intensity", "core.deform", "core.gamma", "core.bias", "core.resample_noise"]
CHAIN = ["chain.blur_cortex", "chain.struct_noise", "chain.motion", "chain.boundaries"]


def _generator():
    """The stream tests' 32^3 generator with ``synth_train.yaml``'s four
    artifacts, the motion engine at one 64 tier."""
    mp = tq.StructNoiseMergeParams(
        "perlin", gauss_nloc_min=5, gauss_nloc_max=15, gauss_sigma_mu=25, gauss_sigma_std=5,
        perlin_res_list=[1, 2], perlin_octaves_list=[1, 2, 4], perlin_persistence=0.5,
        perlin_lacunarity=2, perlin_increase_size=0.1,
    )
    motion = tsc.SimulateMotion(
        prob=0.4, tiers=(64,), ns_grid=32,
        scanner_params=tsc.ScannerParams(
            1.0, 1.5, 2.0, 1.0, 1.5, 1.0, 1.5, 1, 2, 200, 0, 0.05, 1, 1, 0.3, 0.5, 0.05, None, False, 0.0,
        ),
        recon_params=tsc.ReconParams(
            0.5, 0.1, 0.5, 1.0, 0.5, 0.5, 0.1, 0.4, 1.0,
            tq.ReconMergeParams("perlin", perlin_res_list=[1, 2], perlin_octaves_list=[1, 2], perlin_persistence=0.5,
                                perlin_lacunarity=2, perlin_increase_size=0.25, gauss_ngaussians_min=2,
                                gauss_ngaussians_max=4),
        ),
    )
    return model.FetalSynthGen(
        shape=SHAPE, resolution=(0.5, 0.5, 0.5),
        intensity_generator=model.ImageFromSeeds(1, 2, LABELS, GEN_CLASSES),
        spatial_deform=model.SpatialDeformation(20, 0.02, 0.1, SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=model.RandResample(0.9, 0.5, 1.5), bias_field=model.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=model.RandNoise(0.9, 5, 15), gamma=model.RandGamma(0.9, 0.1), seed=0,
        blur_cortex=tq.BlurCortex(prob=0.4, cortex_label=2, nblur_min=50, nblur_max=200),
        struct_noise=tq.StructNoise(prob=0.4, wm_label=3, std_min=0.2, std_max=0.4, merge_params=mp),
        boundaries=tq.SimulatedBoundaries(prob_no_mask=0.5, prob_if_mask_halo=0.5, prob_if_mask_fuzzy=0.5),
        simulate_motion=motion, device="cpu",
    )


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = build_bids_tree(tmp_path_factory.mktemp("bids_trace"), shape=SHAPE)
    return FetalSynthDataset(str(root), _generator(), str(root / "derivatives" / "seeds"))


@pytest.fixture
def tracing():
    """Tracing on for the test, with an empty buffer; off and empty after."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _batches(stream, n):
    it = iter(stream)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _forced(ds, prefetch=True, seed=5):
    return SyntheticStream(ds, batch_size=2, seed=seed, prefetch=prefetch, genparams=FORCED)


def test_off_span_is_one_shared_null_object():
    assert not trace.enabled()
    a = trace.span("core.deform", cuda=True)
    b = trace.span("stream.produce", volumes=4)
    assert a is b is trace.NULL
    with a as s:
        s.set(batch=3, stacks_accepted=1)
        trace.annotate(stacks_attempted=2)
    assert trace.drain() == []


def test_off_a_batch_records_nothing(ds):
    trace.drain()
    _batches(_forced(ds), 1)
    assert trace.drain() == []


def test_batches_are_bit_identical_with_tracing_on_and_off(ds, tracing):
    on = _batches(_forced(ds), 2)
    trace.disable()
    off = _batches(_forced(ds), 2)
    for a, b in zip(on, off):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])


def test_spans_nest_and_carry_the_draw_index(ds, tracing):
    _batches(_forced(ds), 2)
    recs = trace.drain()
    by_id = {r["id"]: r for r in recs}
    produce = [r for r in recs if r["name"] == "stream.produce"]
    # the two batches served, and the one in flight when the iterator closed
    # if its producer drew before the close (else it drew nothing: None)
    ran = sorted(r["batch"] for r in produce if r["batch"] is not None)
    assert ran in ([0, 1], [0, 1, 2]) and len(produce) == 3
    assert all(r["parent"] is None and r["attrs"] == {"volumes": 2} for r in produce)
    producers = {r["thread"] for r in produce}
    joins = [r for r in recs if r["name"] == "stream.join"]
    assert [r["batch"] for r in joins] == [0, 1]
    assert all(r["parent"] is None and r["thread"] not in producers for r in joins)
    under = {
        "stream.compose": "stream.produce", **dict.fromkeys(CORE, "stream.produce"),
        **dict.fromkeys(CHAIN, "stream.produce"), "chain.sync": "stream.produce", "motion.stack": "chain.motion",
        "bank.fill": "stream.produce", "bank.decode": "bank.fill", "bank.to_ras": "bank.fill",
    }
    assert {r["name"] for r in recs} == set(under) | {"stream.produce", "stream.join"}
    fills = [r for r in recs if r["name"] == "bank.fill"]
    # the first batch builds both subjects' banks, each on a thread of its own
    assert len(fills) == 1 and fills[0]["attrs"]["subjects"] == fills[0]["attrs"]["threads"] == 2
    build_threads = {r["thread"] for r in recs if r["name"] == "bank.decode"}
    assert len(build_threads) == 2 and fills[0]["thread"] not in build_threads
    for r in recs:
        if r["name"] in under:
            parent = by_id[r["parent"]]
            assert parent["name"] == under[r["name"]], r["name"]
            assert r["batch"] == parent["batch"]
            assert r["thread"] == parent["thread"] or r["thread"] in build_threads
            assert parent["t0"] <= r["t0"] <= r["t1"] <= parent["t1"]
    for batch in ran:
        names = [r["name"] for r in sorted(recs, key=lambda r: r["t0"]) if r["batch"] == batch
                 and r["name"] in CORE + CHAIN]
        # synth_core's stages once a batch, then the chain per sample
        assert names == CORE + CHAIN * 2
    assert not any("ms" in r for r in recs)  # no CUDA clock on the CPU


def test_chain_motion_counts_the_stacks_the_pack_drew(ds, tracing):
    stream = _forced(ds, prefetch=False, seed=11)
    traces, packs = [], []
    for _ in range(2):
        batch_traces = []
        batch = stream._generate(traces=batch_traces)
        traces += batch_traces
        packs.append(batch["meta"]["pack"])
    recs = trace.drain()
    motion = [r for r in recs if r["name"] == "chain.motion"]
    assert len(motion) == 4
    drawn = [len(p["q_idx"][b]) for p in packs for b in range(2)]
    assert [r["attrs"]["stacks_attempted"] for r in motion] == drawn
    assert [r["attrs"]["stacks_accepted"] for r in motion] == [len(t["accepted"]) for t in traces]
    assert all(r["attrs"]["stacks_accepted"] <= p["num_stacks"][b]
               for r, (p, b) in zip(motion, [(p, b) for p in packs for b in range(2)]))
    stacks = [r for r in recs if r["name"] == "motion.stack"]
    assert len(stacks) == sum(r["attrs"]["stacks_accepted"] for r in motion) > 0
    assert [r["attrs"]["stack"] for r in stacks] == [k for t in traces for k in t["accepted"]]


def _enclosing(spans, i):
    """The name of the innermost span of ``spans`` (sorted by start) on the
    same thread that holds span ``i``, or None."""
    s = spans[i]
    best = None
    for o in spans[:i]:
        if o["tid"] == s["tid"] and o["ts"] <= s["ts"] and s["ts"] + s["dur"] <= o["ts"] + o["dur"]:
            best = o
    return best["name"] if best else None


def test_spans_lie_on_the_profiler_timeline(ds, tracing, tmp_path):
    stream = _forced(ds, prefetch=False, seed=7)
    stream._generate()  # banks built before the profiled batch
    trace.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stream._generate()
    recs = trace.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {r["name"] for r in recs}
    marks = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in names),
                   key=lambda e: (e["ts"], -e["dur"]))
    ordered = sorted(recs, key=lambda r: r["t0"])
    assert [e["name"] for e in marks] == [r["name"] for r in ordered]
    by_id = {r["id"]: r for r in recs}
    parents = [by_id[r["parent"]]["name"] if r["parent"] is not None else None for r in ordered]
    assert [_enclosing(marks, i) for i in range(len(marks))] == parents


def test_the_buffer_stays_bounded(tracing):
    extra = 10
    for i in range(trace.CAPACITY + extra):
        with trace.span("x", i=i):
            pass
    recs = trace.drain()
    assert len(recs) == trace.CAPACITY
    assert recs[0]["attrs"]["i"] == extra and recs[-1]["attrs"]["i"] == trace.CAPACITY + extra - 1
    assert trace.drain() == []


def test_attributes_go_to_the_innermost_open_span(tracing):
    with trace.span("outer", batch=7) as outer:
        with trace.span("inner"):
            trace.annotate(stacks_accepted=2)
        outer.set(volumes=4)
    inner, outer_rec = trace.drain()
    assert inner["attrs"] == {"stacks_accepted": 2} and inner["batch"] == 7
    assert outer_rec["attrs"] == {"volumes": 4} and inner["parent"] == outer_rec["id"]
    assert np.isfinite(inner["t1"] - inner["t0"])
