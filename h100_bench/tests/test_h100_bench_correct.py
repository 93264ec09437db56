"""What decides ``correct``, on the CPU at 32^3: the reference against the
stream bit for bit in the f32 mode, a sound run judged correct, the run and
the control comparing the same batch, the control failing the limits, and
runs with the timed path broken underneath judged not correct. Both cells
run on one card, so the fault of an exchange between cards left out does
not arise. The control and a label fault at a cell's own size run on the
card (``-m cuda``)."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from h100_bench import runner
from h100_bench.check import reference_batch
from h100_bench.control import compared_index, control_numbers
from h100_bench.manifest import HERE, load, read_json
from h100_bench.tests import tiny

CELLS = {"core.stream.b16": ("fsg_core_256", "stream.b16"), "synth_train.stream.b4": ("fsg_synth_train_256", "stream.b4")}
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bids32"))


@pytest.fixture(autouse=True)
def one_warmup_batch(request, monkeypatch):
    if request.node.get_closest_marker("cuda") is None:
        monkeypatch.setattr(runner, "WARMUP_BATCHES", 1)


@pytest.fixture
def production(monkeypatch):
    monkeypatch.setenv("FSG_STREAM_BF16", "1")


def _run(cell: str, root: Path, seconds: float = 2.0, seed: int = SEED):
    name, traffic = CELLS[cell]
    config = tiny.config(name, root)
    limits = read_json("checks", cell)["limits"]
    workload = load(HERE.parent / "BENCHMARK.json").workload(cell)
    t0 = time.perf_counter()
    return runner.run(workload, config, tiny.traffic(traffic), limits, [], seed, seconds, False,
                      lambda: time.perf_counter() - t0, "cpu")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_equals_the_stream_in_f32(cell, root, monkeypatch):
    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    name, traffic_name = CELLS[cell]
    config, traffic = tiny.config(name, root), tiny.traffic(traffic_name)
    stream = SyntheticStream(runner.build_dataset(config), batch_size=2, seed=SEED, mix_subjects=1)
    it = iter(stream)
    batches = [next(it) for _ in range(3)]
    it.close()
    for index, batch in enumerate(batches):
        for j, image, label in reference_batch(config, traffic, SEED, index, "cpu"):
            assert torch.equal(image, batch["image"][j])
            assert torch.equal(label, batch["label"][j])


def test_the_worst_case_warmup_leaves_the_runs_draws(root, monkeypatch):
    """The worst-case warm-up serves its pinned draws (every sample with
    motion on) from a stream of its own, sharing the seed banks, and the
    run's stream then serves the batches it serves without it."""
    import fetalsyngen_torch.parallel.input_pipeline as ip

    name, traffic_name = CELLS["synth_train.stream.b4"]
    config, traffic = tiny.config(name, root), tiny.traffic(traffic_name)
    assert traffic["worst_case"]
    served = []
    real_iter = ip.SyntheticStream.__iter__

    def watched(self):
        for batch in real_iter(self):
            served.append((self.genparams, batch["meta"]))
            yield batch

    monkeypatch.setattr(ip.SyntheticStream, "__iter__", watched)

    def first_batch(warm: bool):
        served.clear()
        ds = runner.build_dataset(config)
        stream = ip.SyntheticStream(ds, batch_size=2, seed=SEED, mix_subjects=1)
        if warm:
            runner.worst_case_warmup(ds, stream, traffic)
        it = iter(stream)
        batch = next(it)
        it.close()
        return stream, batch, list(served)

    stream, warmed, log = first_batch(True)
    pinned = [meta for gp, meta in log if gp]
    assert len(pinned) == runner.WARMUP_BATCHES
    assert all(bool(m["scanner"]["motion_on"].all()) for m in pinned)
    assert stream.banks.records, "the warm-up built the banks the run uses"
    _, plain, _ = first_batch(False)
    assert torch.equal(warmed["image"], plain["image"])
    assert torch.equal(warmed["label"], plain["label"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell, root, production):
    r = _run(cell, root)
    assert r["compared"]["batch_index"] is not None
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_run_and_the_control_compare_one_batch(cell, root, production):
    name, traffic = CELLS[cell]
    for seed in (SEED, SEED + 3):
        r = _run(cell, root, seed=seed)
        assert r["compared"]["batch_index"] == compared_index(tiny.config(name, root), tiny.traffic(traffic), seed)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails(cell, root):
    name, traffic = CELLS[cell]
    limits = read_json("checks", cell)["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        nums = control_numbers(tiny.config(name, root), tiny.traffic(traffic), seed, "cpu")
        assert any(nums[k] > lim for k, lim in limits.items()), nums


def _broken_batches(monkeypatch, how):
    import fetalsyngen_torch.parallel.input_pipeline as ip

    real = ip.batch_program

    def broken(*args, **kwargs):
        image, label = real(*args, **kwargs)
        return how(image.clone(), label.clone())

    monkeypatch.setattr(ip, "batch_program", broken)


def _half_left_out(image, label):
    h = image.shape[0] // 2
    image[h:] = 0
    label[h:] = 0
    return image, label


def _image_altered(image, label):
    image[0] = image[0].roll(1, 0)
    return image, label


def _label_altered(image, label):
    label[0, :4, :4, :4] += 1
    return image, label


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["deform_unchanged", "half_left_out", "image_altered", "label_altered"])
def test_a_broken_path_is_not_correct(cell, fault, root, production, monkeypatch):
    if fault == "deform_unchanged":
        import fetalsyngen_torch.generator.pipeline as pipeline

        monkeypatch.setattr(pipeline, "deform_stage", lambda p, f, cfg, out, seg, image=None: (out, seg, image))
    else:
        _broken_batches(monkeypatch, {"half_left_out": _half_left_out, "image_altered": _image_altered,
                                      "label_altered": _label_altered}[fault])
    r = _run(cell, root)
    assert r["compared"]["batch_index"] is not None
    assert not r["correct"], r["checks"]


def test_the_motion_engine_unchanged_is_not_correct(root, production, monkeypatch):
    import fetalsyngen_torch.generator.artifacts.batched as batched

    monkeypatch.setattr(batched, "motion_t", lambda out, *a, **k: out)
    r = _run("synth_train.stream.b4", root)
    assert r["compared"]["batch_index"] is not None
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_at_the_cells_size(cell, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the control at a cell's own size runs on a CUDA card")
    name, traffic = CELLS[cell]
    config = read_json("configs", name)
    monkeypatch.chdir(HERE.parent)
    for k, v in config["env"].items():
        monkeypatch.setenv(k, v)
    runner.apply_flags(torch, config["torch_flags"])
    limits = read_json("checks", cell)["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        nums = control_numbers(config, read_json("traffic", traffic), seed, "cuda")
        assert any(nums[k] > lim for k, lim in limits.items()), nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_label_fault_in_one_element_at_the_cells_size(cell, monkeypatch):
    """An 11^3 block of one element's labels altered: 1,331 voxels, under the
    batch's share at B=16 but over the per-element limit."""
    if not torch.cuda.is_available():
        pytest.skip("a run at a cell's own size needs a CUDA card")
    name, traffic = CELLS[cell]
    config = read_json("configs", name)
    monkeypatch.chdir(HERE.parent)
    for k, v in config["env"].items():
        monkeypatch.setenv(k, v)
    limits = read_json("checks", cell)["limits"]

    def block(image, label):
        label[0, :11, :11, :11] += 1
        return image, label

    _broken_batches(monkeypatch, block)
    workload = load(HERE.parent / "BENCHMARK.json").workload(cell)
    t0 = time.perf_counter()
    r = runner.run(workload, config, read_json("traffic", traffic), limits, [], SEED, 3.0, False,
                   lambda: time.perf_counter() - t0)
    assert r["checks"]["label_mismatch_worst"]["value"] > limits["label_mismatch_worst"], r["checks"]
    assert not r["correct"]
