"""The port's artifact-free input stream against the JAX package's, on the CPU.

The native loader, the seed banks, the seed composition and the choice law
are held against ``fetalsyngen_tpu.io.native`` and
``fetalsyngen_tpu.parallel.input_pipeline`` on a 32^3 mini-BIDS tree. The
whole batch is held against the JAX stream's (f32 contract,
``FSG_STREAM_BF16=0``): the port's batch program gets JAX's draws (the
per-sample keys' ``GenParams`` and voxel fields, and the uniforms that
choose the options) and must give the image within 1e-4 (values in [0, 1])
and the same labels. The rest holds the port's stream to its own contract:
names, replay, prefetch, the refusal without a card, that a generator's SR
artifacts run in the stream, and a cohort served from one slab of bank
slots: every element against its replay and its computation alone, the
slots' LRU, the counts, the lazy slab and the spans' counts.
"""

import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fetalsyngen_tpu.data.datasets import FetalSynthDataset as JaxDataset
from fetalsyngen_tpu.generator import model as jmodel
from fetalsyngen_tpu.generator import params as jparams
from fetalsyngen_tpu.io import native as jnative
from fetalsyngen_tpu.parallel import input_pipeline as jpipe
from fetalsyngen_torch import trace
from fetalsyngen_torch.convert import fields_from_numpy, params_from_numpy
from fetalsyngen_torch.data.datasets import FetalSynthDataset
from fetalsyngen_torch.generator import params as tparams
from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.generator.artifacts import quality as tq
from fetalsyngen_torch.io import native, nifti
from fetalsyngen_torch.parallel import input_pipeline as tstream
from fetalsyngen_torch.testing import build_bids_tree

REPO = Path(__file__).resolve().parent.parent
SHAPE = (32, 32, 32)
B = 2
LABELS = [0] + list(range(10, 50))
GEN_CLASSES = [0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))


def _generator(mod, **kw):
    """``small_generator`` of the dataset tests at 32^3, from the port's
    model module or JAX's."""
    return mod.FetalSynthGen(
        shape=SHAPE,
        resolution=(0.5, 0.5, 0.5),
        intensity_generator=mod.ImageFromSeeds(1, 2, LABELS, GEN_CLASSES),
        spatial_deform=mod.SpatialDeformation(20, 0.02, 0.1, SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=mod.RandResample(0.9, 0.5, 1.5),
        bias_field=mod.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=mod.RandNoise(0.9, 5, 15),
        gamma=mod.RandGamma(0.9, 0.1),
        seed=0,
        **kw,
    )


def _port_generator(**kw):
    from fetalsyngen_torch.generator import model

    return _generator(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_bids_tree(tmp_path_factory.mktemp("bids"), shape=SHAPE)


@pytest.fixture(scope="module")
def ds(root):
    return FetalSynthDataset(str(root), _port_generator(), str(root / "derivatives" / "seeds"))


@pytest.fixture(scope="module")
def jds(root):
    return JaxDataset(str(root), _generator(jmodel), str(root / "derivatives" / "seeds"))


@pytest.fixture(scope="module")
def seed_files(root):
    return sorted(str(p) for p in root.glob("derivatives/seeds/subclasses_2/sub-aaa/anat/*.nii.gz"))


def _batches(stream, n):
    it = iter(stream)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _equal(a, b):
    return torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"]) and a["name"] == b["name"]


# ---------------------------------------------------------------------------
# native loader
# ---------------------------------------------------------------------------


def test_native_source_is_jax_copy_and_builds_under_build_dir():
    assert native.SOURCE.read_bytes() == (REPO / "fetalsyngen_tpu/io/native/nifti_loader.cpp").read_bytes()
    assert native.available(), native.build_error()
    assert native.build_error() is None
    lib = Path(native.get_lib()._name)
    assert lib.parent == REPO / "build" / "fetalsyngen_torch_native" and lib.exists()
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_native_batch_matches_jax_and_python_reader(seed_files):
    assert len(seed_files) == 4
    got = native.load_labels_batch(seed_files, SHAPE)
    ref = jnative.load_labels_batch(seed_files, SHAPE)
    assert got is not None and ref is not None and len(got) == len(seed_files)
    for g, r, p in zip(got, ref, seed_files):
        assert g.dtype == np.int32 and g.shape == SHAPE
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, nifti.load(p).data.astype(np.int32))


def test_native_shape_mismatch_returns_none(seed_files):
    assert native.load_labels_batch(seed_files, (8, 8, 8)) is None
    assert jnative.load_labels_batch(seed_files, (8, 8, 8)) is None


def test_failed_build_is_reported_and_banks_fall_back(ds, tmp_path, monkeypatch):
    """A compiler that fails leaves no library, ``build_error`` holds its
    message, and the bank cache decodes with the Python reader, saying so,
    into the same bytes."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.get_lib() is None and not native.available()
    assert "no-such-compiler" in native.build_error()
    assert not list((tmp_path / "native").glob("*.so"))
    name = sorted(ds.seed_paths)[0]
    cache = tstream.SeedBankCache(ds.seed_paths, device="cpu")
    bank = cache.bank(name)
    assert cache.records[name]["reader"] == "python"
    monkeypatch.undo()
    native_cache = tstream.SeedBankCache(ds.seed_paths, device="cpu")
    assert torch.equal(native_cache.bank(name), bank)
    assert native_cache.records[name]["reader"] == "native"


# ---------------------------------------------------------------------------
# seed banks, composition, the choice law
# ---------------------------------------------------------------------------


def test_banks_equal_jax_byte_for_byte(ds, jds):
    port = tstream.SeedBankCache(ds.seed_paths, device="cpu")
    ref = jpipe.SeedBankCache(jds.seed_paths)
    assert port.max_bytes == ref.max_bytes
    for name in sorted(ds.seed_paths):
        trace.drain()
        trace.enable()
        try:
            got = port.bank(name)
        finally:
            trace.disable()
        want = np.asarray(ref.bank(name))
        assert got.dtype == torch.int8 and got.device.type == "cpu"
        assert tuple(got.shape) == want.shape == (2, 4, *SHAPE)
        assert got.numpy().tobytes() == want.tobytes()
        assert port.records[name] == {"reader": "native", "bytes": got.numel()}
        spans = trace.drain()
        # decoded and oriented on the host, nothing pinned or uploaded on the CPU
        assert [r["name"] for r in spans] == ["bank.decode", "bank.to_ras"]
        assert all(r["t1"] >= r["t0"] and r["attrs"] == {"volumes": 8} for r in spans)
    assert port.nbytes == ref.nbytes


def test_bank_cache_evicts_by_bytes_in_lru_order(ds, jds):
    """As ``tests/test_input_pipeline.py``: a budget of one bank keeps the
    last; with a budget of two banks, the least recently used goes, in the
    same order as JAX's cache."""
    names = sorted(ds.seed_paths)
    one = tstream.SeedBankCache(ds.seed_paths, device="cpu").bank(names[0]).numel()
    cache = tstream.SeedBankCache(ds.seed_paths, max_bytes=one, device="cpu")
    cache.bank(names[0])
    cache.bank(names[1])
    assert list(cache._cache) == [names[1]] and cache.nbytes <= one
    # a third subject (an alias of the first) makes an LRU order observable
    order = [names[0], names[1], names[0], "sub-ccc", names[1]]
    kept = []
    for mod, paths, kw in ((tstream, dict(ds.seed_paths), {"device": "cpu"}), (jpipe, dict(jds.seed_paths), {})):
        paths["sub-ccc"] = paths[names[0]]
        c = mod.SeedBankCache(paths, max_bytes=2 * one, **kw)
        steps = []
        for n in order:
            c.bank(n)
            steps.append(list(c._cache))
        kept.append(steps)
        assert c.nbytes == 2 * one
    assert kept[0] == kept[1]
    assert kept[0][3] == [names[0], "sub-ccc"]


def test_bank_cache_default_device_is_cuda(ds, monkeypatch):
    """As the JAX cache puts its banks on the default accelerator, a bank
    cache built with no device means CUDA: without a card it raises, naming
    the CPU's spelling."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.SeedBankCache(ds.seed_paths)
    assert tstream.SeedBankCache(ds.seed_paths, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("choices", [(0, 1, 0, 1), (1, 1, 1, 1), (1, 0, 0, 1)])
def test_compose_seeds_matches_jax(ds, jds, choices):
    name = sorted(ds.seed_paths)[1]
    bank = tstream.SeedBankCache(ds.seed_paths, device="cpu").bank(name)
    got = tstream.compose_seeds(bank, torch.tensor(choices, dtype=torch.int32))
    jbank = jpipe.SeedBankCache(jds.seed_paths).bank(name)
    want = np.asarray(jpipe.compose_seeds(jbank, jnp.asarray(choices, jnp.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.numpy(), want)
    host = sum(bank[c, m].numpy().astype(np.int32) for m, c in enumerate(choices))
    np.testing.assert_array_equal(got.numpy(), host)


def _jax_choice(u, hi_s, lo):
    """The JAX stream's choice law (``input_pipeline.py:190-192``) on (B, 4)."""
    ch = lo + jnp.floor(u * (hi_s - lo).astype(jnp.float32)[:, None]).astype(jnp.int32)
    return jnp.clip(ch, lo, hi_s[:, None] - 1)


@pytest.mark.parametrize("lo", [0, 1])
def test_choice_law_matches_jax(lo):
    rng = np.random.default_rng(4)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    # products landing exactly on integers (0.5 * 2, 0.25 * 4, 0.75 * 4 ...),
    # the ends of [0, 1), then random draws
    exact = np.array([0.0, 0.5, 0.25, 0.75, 1 / 3, 2 / 3, 0.2, 0.6, below_one], np.float32)
    u = np.concatenate([np.resize(exact, 36), rng.random(60, dtype=np.float32)]).reshape(-1, 4)
    hi = np.resize(np.array([2, 3, 4, 5, 6], np.int32), len(u))
    hi = np.maximum(hi, lo + 1)
    got = tstream.choose_options(torch.from_numpy(u), torch.from_numpy(hi), lo)
    want = np.asarray(_jax_choice(jnp.asarray(u), jnp.asarray(hi), lo))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >= lo).all() and (got.numpy() < hi[:, None]).all()


@pytest.mark.parametrize("dtype, V", [(torch.int8, 64), (torch.int8, 27), (torch.int16, 12), (torch.int16, 10)])
def test_take_rows_is_indexing(dtype, V):
    """The batch program's word-wise gather equals plain indexing, whether
    or not a row holds whole 8-byte words."""
    t = torch.randint(-100, 100, (6, V), generator=torch.Generator().manual_seed(V)).to(dtype)
    rows = torch.tensor([[1, 5, 0, 2], [3, 3, 4, 0]])
    assert torch.equal(tstream._take_rows(t, rows), t[rows])


# ---------------------------------------------------------------------------
# the whole batch against the JAX stream
# ---------------------------------------------------------------------------


def _jax_draws(sub, cfg, n):
    """The JAX stream's per-sample parameters and fields (from ``split(sub,
    n)``) and its option uniforms (``fold_in(sub, 2)``), as numpy."""
    keys = jax.random.split(jnp.asarray(sub), n)
    shapes = tpipe.field_shapes(cfg)
    params, fields = [], []
    for key in keys:
        p = jparams.sample_params(key, cfg)
        params.append({f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)})
        fields.append({
            k: np.asarray(jax.random.normal(jparams.field_key(key, f"field_{k}"), shp, jnp.float32))
            for k, shp in shapes.items()
        })
    u = np.asarray(jax.random.uniform(jax.random.fold_in(jnp.asarray(sub), 2), (n, 4)))
    stack = lambda ds_: {k: np.stack([d[k] for d in ds_]) for k in ds_[0]}  # noqa: E731
    return stack(params), stack(fields), u


def test_batch_matches_jax_stream(ds, jds, monkeypatch):
    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    jstream = jpipe.SyntheticStream(jds, batch_size=B, seed=0, prefetch=False, artifacts=False)
    jbatch = next(iter(jstream))
    meta = jbatch["meta"]
    params, fields, u = _jax_draws(meta["sub"], jstream.cfg, B)

    stream = tstream.SyntheticStream(ds, batch_size=B, seed=0, prefetch=False, artifacts=False)
    banks = stream._banks_for(meta["resident"])
    image, label = tstream.batch_program(
        *banks, torch.tensor(meta["subj"]), torch.tensor(u),
        params_from_numpy(params), fields_from_numpy(**fields), stream.cfg, stream._lo,
    )
    j_image, j_label = np.asarray(jbatch["image"]), np.asarray(jbatch["label"])
    assert image.shape == (B, *SHAPE) and label.dtype == torch.int32
    assert float(image.min()) >= 0.0 and float(image.amax(dim=(1, 2, 3)).min()) == 1.0
    np.testing.assert_allclose(image.numpy(), j_image, atol=1e-4, rtol=0)
    flips = np.argwhere(label.numpy() != j_label)
    assert len(flips) == 0, f"{len(flips)} labels differ, first at {flips[:8].tolist()}"
    # the port's own stream draws the same residents and subjects per batch
    assert next(iter(stream))["name"] == jbatch["name"]


def test_names_rotate_as_jax(ds, jds):
    """With one resident subject the set rotates each batch; for one seed
    the port's stream names the same subjects as JAX's, batch by batch. The
    names are host draws: JAX's device program is replaced by a stub that
    returns nothing, so no JAX program compiles."""
    jstream = jpipe.SyntheticStream(jds, batch_size=B, seed=5, prefetch=False, artifacts=False, mix_subjects=1)
    jstream._batch_fn = lambda *a: (None, None)
    want = [jstream._generate()["name"] for _ in range(3)]
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=5, prefetch=False, artifacts=False, mix_subjects=1)
    got = [b["name"] for b in _batches(stream, 3)]
    assert got == want
    assert {n[0] for n in got} == set(ds.seed_paths)


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------


def test_replay_is_bit_identical(ds):
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=3, prefetch=False)
    batches = _batches(stream, 3)
    assert set(batches[0]["meta"]) == {"seeds", "u", "resident", "subj", "batch_size"}
    assert not torch.equal(batches[0]["image"], batches[1]["image"])
    meta = batches[1]["meta"]
    assert _equal(stream.replay_batch(meta), batches[1])
    fresh = tstream.SyntheticStream(ds, batch_size=B, seed=99, prefetch=False)
    assert _equal(fresh.replay_batch(meta), batches[1])
    one = fresh.replay_sample(meta, 1)
    assert torch.equal(one["image"], batches[1]["image"][1]) and one["name"] == batches[1]["name"][1]
    with pytest.raises(ValueError, match="batch_size"):
        tstream.SyntheticStream(ds, batch_size=B + 1, seed=3, prefetch=False).replay_batch(meta)


def test_prefetch_on_and_off_give_the_same_batches(ds):
    on = _batches(tstream.SyntheticStream(ds, batch_size=B, seed=11, prefetch=True), 3)
    off = _batches(tstream.SyntheticStream(ds, batch_size=B, seed=11, prefetch=False), 3)
    assert all(_equal(a, b) for a, b in zip(on, off))


def test_producer_error_reaches_the_consumer(ds, monkeypatch):
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=0, prefetch=True)

    def fail(*a):
        raise ValueError("producer failed")

    monkeypatch.setattr(stream, "_run", fail)
    with pytest.raises(ValueError, match="producer failed"):
        next(iter(stream))


def test_concurrent_iterators_keep_the_draws_whole(ds):
    """Two prefetching iterators and replays on one stream, with a short
    switch interval: every batch is the replay of its own meta, and the
    draws together are the sequential stream's first six."""
    stream = tstream.SyntheticStream(ds, batch_size=1, seed=21, prefetch=True)
    got, errors = [], []

    def pull():
        try:
            it = iter(stream)
            for _ in range(3):
                got.append(next(it))
            it.close()
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=pull) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    seq = _batches(tstream.SyntheticStream(ds, batch_size=1, seed=21, prefetch=False), 6)
    key = lambda b: int(b["meta"]["seeds"][0])  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, seq))
    for b in got:
        assert _equal(stream.replay_batch(b["meta"]), b)


def _count_draws(stream):
    """Counts the stream's host draws. Returns ``wait(n)``, which returns
    once ``n`` batches have been drawn."""
    cond, n, draw = threading.Condition(), [0], stream._draw

    def counted():
        out = draw()
        with cond:
            n[0] += 1
            cond.notify_all()
        return out

    stream._draw = counted

    def wait(k):
        with cond:
            assert cond.wait_for(lambda: n[0] >= k, timeout=120), f"{n[0]} of {k} batches drawn"

    return wait


def test_closed_iterator_hands_its_batch_in_flight_back(ds):
    """A prefetching iterator closed after one batch, once the second is
    drawn: its draws go back to the stream, so a new iterator's first
    batch is the sequential stream's second, bit for bit."""
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=23, prefetch=True)
    drawn = _count_draws(stream)
    it = iter(stream)
    first = next(it)
    drawn(2)
    it.close()
    assert [i for i, _ in stream._returned] == [1]
    second = _batches(stream, 1)[0]
    seq = _batches(tstream.SyntheticStream(ds, batch_size=B, seed=23, prefetch=False), 2)
    assert _equal(first, seq[0]) and _equal(second, seq[1])
    assert all(np.array_equal(second["meta"][k], seq[1]["meta"][k]) for k in ("seeds", "u", "subj"))


def test_iterator_closed_before_its_producer_draws_draws_nothing(ds, monkeypatch):
    """The producer of the second batch waits until its iterator is closed:
    it then draws nothing, and a new iterator's first batch is the
    sequential stream's second."""
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=23, prefetch=True)
    generate, boxes = stream._generate, []

    def gated(box=None, **kw):
        boxes.append(box)
        deadline = time.monotonic() + 120
        while len(boxes) == 2 and not box.get("closed") and time.monotonic() < deadline:
            time.sleep(0.01)
        return generate(box, **kw)

    monkeypatch.setattr(stream, "_generate", gated)
    first = _batches(stream, 1)[0]
    assert boxes[1]["closed"] and "meta" not in boxes[1] and boxes[1]["batch"] is None
    assert stream._n_drawn == 1 and not stream._returned
    second = _batches(stream, 1)[0]
    seq = _batches(tstream.SyntheticStream(ds, batch_size=B, seed=23, prefetch=False), 2)
    assert _equal(first, seq[0]) and _equal(second, seq[1])


def test_failed_batch_is_not_handed_back(ds, monkeypatch):
    """A batch whose generation failed raises in the consumer and its draws
    are dropped: the next batch is the sequential stream's second."""
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=23, prefetch=True)
    run, calls = stream._run, []

    def fail_first(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("producer failed")
        return run(*a, **kw)

    monkeypatch.setattr(stream, "_run", fail_first)
    with pytest.raises(ValueError, match="producer failed"):
        next(iter(stream))
    assert not stream._returned
    got = _batches(stream, 1)[0]
    seq = _batches(tstream.SyntheticStream(ds, batch_size=B, seed=23, prefetch=False), 2)
    assert _equal(got, seq[1])


def test_handed_back_draws_come_back_in_draw_order(ds):
    """Two iterators closed in the reverse of their draws' order: the
    batches they hand back are drawn again in the order they were first
    drawn, then new draws follow."""
    stream = tstream.SyntheticStream(ds, batch_size=1, seed=23, prefetch=True)
    drawn = _count_draws(stream)
    a = iter(stream)
    next(a)
    drawn(2)  # a holds batch 0, batch 1 in flight
    b = iter(stream)
    next(b)
    drawn(4)  # b holds batch 2, batch 3 in flight
    b.close()
    a.close()
    assert sorted(i for i, _ in stream._returned) == [1, 3]
    got = _batches(stream, 3)
    seq = _batches(tstream.SyntheticStream(ds, batch_size=1, seed=23, prefetch=False), 5)
    assert all(_equal(g, s) for g, s in zip(got, (seq[1], seq[3], seq[4])))


def test_artifacts_run_and_differ_from_artifact_free(root):
    """A generator with an SR artifact streams it: the same seed gives the
    same subjects, labels and core, and images that differ from the stream
    built with ``artifacts=False``."""
    gen = _port_generator(blur_cortex=tq.BlurCortex(1.0, 2, 5, 20))
    ads = FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))
    got = next(iter(tstream.SyntheticStream(ads, batch_size=B, seed=4, prefetch=False)))
    plain = next(iter(tstream.SyntheticStream(ads, batch_size=B, seed=4, prefetch=False, artifacts=False)))
    assert got["image"].shape == plain["image"].shape == (B, *SHAPE)
    assert got["name"] == plain["name"] and torch.equal(got["label"], plain["label"])
    assert float(got["image"].min()) >= 0.0 and float(got["image"].max()) <= 1.0
    assert not torch.allclose(got["image"], plain["image"])
    assert "pack" in got["meta"] and "pack" not in plain["meta"]


def test_genparams_pins_read_under_both_keys(ds):
    pins = {"blur_cortex": {"nblur": 9}, "struct_noise": None}
    for key in ("artifacts", "artifact_params"):
        stream = tstream.SyntheticStream(ds, batch_size=B, genparams={key: pins, "seed": None})
        assert stream.artifact_pins == {"blur_cortex": {"nblur": 9}}
        assert stream.genparams == {key: pins}


def test_default_device_needs_a_card(root):
    """A generator without a device means CUDA; without a card the stream
    refuses, it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    class _Gen:
        cfg = _port_generator().cfg
        artifacts = {}

    cuda_ds = FetalSynthDataset(str(root), _Gen(), str(root / "derivatives" / "seeds"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tstream.SyntheticStream(cuda_ds, batch_size=B)


# ---------------------------------------------------------------------------
# a cohort: one slab of slots, filled by threads, gathered through the slots
# ---------------------------------------------------------------------------

COHORT = tuple(f"sub-c{i}" for i in range(6))
ONE_BANK = 2 * 4 * 32**3  # two options of four meta-labels at 32^3, int8


@pytest.fixture(scope="module")
def cohort_root(tmp_path_factory):
    return build_bids_tree(tmp_path_factory.mktemp("cohort"), np.random.default_rng(3), shape=SHAPE, subjects=COHORT)


def _alone(ds, stream, meta, j):
    """Element ``j`` of a batch computed alone (B=1) from its subject's own
    seed files: a bank of its own, ``compose_seeds``, the segmentation read
    again, ``synth_core`` and the division by the peak."""
    name = meta["resident"][int(meta["subj"][j])]
    bank = tstream.SeedBankCache({name: ds.seed_paths[name]}, device="cpu").bank(name)
    hi = torch.tensor([min(stream.cfg.intensity.max_subclusters, bank.shape[0])], dtype=torch.int32)
    choice = tstream.choose_options(torch.from_numpy(meta["u"][j : j + 1]), hi, stream._lo)[0]
    seeds = tstream.compose_seeds(bank, choice)[None]
    idx = [ds._sub_ses_idx(i) for i in range(len(ds.sub_ses))].index(name)
    seg = torch.from_numpy(nifti.load_ras(str(ds.segm_paths[idx])).data.astype(np.int32))[None]
    gens = tpipe.make_generators(meta["seeds"][j : j + 1], "cpu")
    out, seg, _ = tpipe.synth_core(tparams.sample_params(gens, stream.cfg), tpipe.draw_fields(gens, stream.cfg, "cpu"),
                                   seeds, seg, stream.cfg)
    peak = out.amax(dim=(1, 2, 3), keepdim=True)
    return name, (out / torch.where(peak > 0, peak, 1.0))[0], seg[0]


@pytest.mark.parametrize("setting", ["all_resident", "rotation_evicts", "one_subject"])
def test_cohort_batches_equal_replay_and_each_element_alone(cohort_root, setting, monkeypatch):
    """Six subjects at 32^3, f32: every subject resident; two resident at a
    time under a budget of three banks, so the rotation evicts; one
    subject. Every element equals ``replay_sample`` and its computation
    alone from its subject's seeds."""
    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    sub_list = [COHORT[4]] if setting == "one_subject" else None
    ds = FetalSynthDataset(str(cohort_root), _port_generator(), str(cohort_root / "derivatives" / "seeds"),
                           sub_list=sub_list)
    mix = {"all_resident": 6, "rotation_evicts": 2, "one_subject": 1}[setting]
    stream = tstream.SyntheticStream(ds, batch_size=3, seed=2**31 + 9, prefetch=False, mix_subjects=mix)
    if setting == "rotation_evicts":
        stream.banks.max_bytes = 3 * ONE_BANK
    counts = dict(tstream.BANK_COUNTS)
    batches = _batches(stream, 5)
    built = tstream.BANK_COUNTS["fills"] - counts["fills"]
    evicted = tstream.BANK_COUNTS["evictions"] - counts["evictions"]
    capacity = {"all_resident": 6, "rotation_evicts": 3, "one_subject": 1}[setting]
    assert stream.banks.capacity == capacity and stream.banks.banks.shape == (capacity, 2, 4, *SHAPE)
    assert stream.banks.segs.shape == (capacity, *SHAPE) and stream.banks.segs.dtype == torch.int16
    # the rotation's residents advance a subject a batch: 2, then one more each
    assert built == {"all_resident": 6, "rotation_evicts": 6, "one_subject": 1}[setting]
    assert evicted == {"all_resident": 0, "rotation_evicts": 3, "one_subject": 0}[setting]
    for batch in batches:
        meta = batch["meta"]
        for j in range(3):
            one = stream.replay_sample(meta, j)
            assert torch.equal(one["image"], batch["image"][j]) and torch.equal(one["label"], batch["label"][j])
            name, image, label = _alone(ds, stream, meta, j)
            assert name == batch["name"][j] == one["name"]
            assert torch.equal(image, batch["image"][j]) and torch.equal(label, batch["label"][j])


def test_cohort_fill_keeps_the_lru_order_and_counts(cohort_root):
    """The LRU order of ``_cache`` over slots: a fill makes its names the
    most recent in their order, never evicts one of them, and the least
    recently used leaves its slot first; a fill beyond the slots raises."""
    ds = FetalSynthDataset(str(cohort_root), _port_generator(), str(cohort_root / "derivatives" / "seeds"))
    cache = tstream.SeedBankCache(ds.seed_paths, max_bytes=3 * ONE_BANK, device="cpu")
    assert cache.banks is None and cache.slab_bytes == 0  # made at the first bank
    c0 = dict(tstream.BANK_COUNTS)
    assert cache.fill([COHORT[2], COHORT[0], COHORT[1]]) == 3 == cache.filled
    assert list(cache._cache) == [COHORT[2], COHORT[0], COHORT[1]] and cache.slab_bytes == 3 * ONE_BANK
    assert not vars(cache._local)  # no staging set outlives its fill
    assert cache.fill([COHORT[2]]) == 0
    assert list(cache._cache) == [COHORT[0], COHORT[1], COHORT[2]]
    slot0 = cache.slots([COHORT[0]])[0]
    assert cache.fill([COHORT[3], COHORT[1]]) == 1  # COHORT[0] is the least recent: its slot is taken
    assert list(cache._cache) == [COHORT[2], COHORT[3], COHORT[1]] and cache.slots([COHORT[3]]) == [slot0]
    assert cache.nbytes == 3 * ONE_BANK
    d = {k: tstream.BANK_COUNTS[k] - c0[k] for k in c0}
    assert d == {"fills": 4, "hits": 2, "evictions": 1}
    # each slot holds its subject's own bank
    for name in cache._cache:
        alone = tstream.SeedBankCache({name: ds.seed_paths[name]}, device="cpu").bank(name)
        assert torch.equal(cache.banks[cache.slots([name])[0]], alone)
    with pytest.raises(RuntimeError, match="max_bytes"):
        cache.fill(COHORT[:4])


def _fill_in_a_thread(cache, names):
    """``cache.fill(names)`` on a thread of its own, joined within a minute:
    (the exception it raised or None, whether it still runs)."""
    out = {}

    def run():
        try:
            cache.fill(names)
        except Exception as e:  # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    return out.get("error"), t.is_alive()


def test_cohort_fill_beyond_the_slots_or_with_failed_builds_raises(cohort_root, monkeypatch):
    """On four threads: a fill of two subjects more than the slots raises
    before any build; a fill in which two builds fail, in the decode or
    after taking a slot, raises their error, returns, and leaves their
    slots free for the next fill."""
    monkeypatch.setattr(tstream, "FILL_THREADS", 4)
    ds = FetalSynthDataset(str(cohort_root), _port_generator(), str(cohort_root / "derivatives" / "seeds"))
    cache = tstream.SeedBankCache(ds.seed_paths, max_bytes=3 * ONE_BANK, device="cpu")
    fills = tstream.BANK_COUNTS["fills"]
    error, running = _fill_in_a_thread(cache, COHORT[:5])
    assert not running and isinstance(error, RuntimeError) and "max_bytes" in str(error)
    assert tstream.BANK_COUNTS["fills"] == fills and cache.capacity == 3 and not cache._cache

    load = cache._load_into
    bad = {COHORT[1], COHORT[2]}

    def failing(name, out, raw):
        if name in bad:
            raise OSError(f"corrupt seed file of {name}")
        return load(name, out, raw)

    monkeypatch.setattr(cache, "_load_into", failing)
    error, running = _fill_in_a_thread(cache, COHORT[:3])
    assert not running and isinstance(error, OSError) and "corrupt" in str(error)
    assert list(cache._cache) == [COHORT[0]] and len(cache._free) == 2 and not cache._keep
    bad.clear()
    # builds that fail after taking their slot hand it back
    orient = tstream._orient_into
    monkeypatch.setattr(tstream, "_orient_into", lambda *a: (_ for _ in ()).throw(OSError("upload failed")))
    error, running = _fill_in_a_thread(cache, COHORT[3:5])
    assert not running and isinstance(error, OSError) and "upload" in str(error)
    assert list(cache._cache) == [COHORT[0]] and len(cache._free) == 2
    monkeypatch.setattr(tstream, "_orient_into", orient)
    error, running = _fill_in_a_thread(cache, COHORT[:3])
    assert error is None and not running
    assert sorted(cache.slots(COHORT[:3])) == [0, 1, 2] and not cache._free
    for name in COHORT[:3]:
        alone = tstream.SeedBankCache({name: ds.seed_paths[name]}, device="cpu").bank(name)
        assert torch.equal(cache.banks[cache.slots([name])[0]], alone)


def test_a_second_stream_on_the_banks_allocates_nothing(cohort_root):
    """The slab is made at the first bank, not with the stream: a second
    stream that takes ``stream.banks`` (as the benchmark's worst-case
    warm-up does) makes no slab and builds no bank."""
    ds = FetalSynthDataset(str(cohort_root), _port_generator(), str(cohort_root / "derivatives" / "seeds"))
    stream = tstream.SyntheticStream(ds, batch_size=2, seed=4, prefetch=False, mix_subjects=6)
    assert stream.banks.banks is None and stream.banks.segs is None
    first = _batches(stream, 1)[0]
    slab = stream.banks.banks
    second = tstream.SyntheticStream(ds, batch_size=2, seed=4, prefetch=False, mix_subjects=6)
    own = second.banks
    second.banks = stream.banks
    fills = tstream.BANK_COUNTS["fills"]
    again = _batches(second, 1)[0]
    assert own.banks is None and own.records == {}
    assert tstream.BANK_COUNTS["fills"] == fills and stream.banks.banks is slab
    assert _equal(first, again)


def test_subjects_sharing_files_take_a_slot_each(ds):
    """Banks are keyed by subject name, not by file: an alias of a subject
    (the same seed files) is a second bank in a second slot."""
    paths = dict(ds.seed_paths)
    name = sorted(paths)[0]
    paths["sub-alias"] = paths[name]
    cache = tstream.SeedBankCache(paths, device="cpu")
    cache.fill([name, "sub-alias"])
    a, b = cache.slots([name, "sub-alias"])
    assert a != b and torch.equal(cache.banks[a], cache.banks[b])
    assert cache.nbytes == 2 * cache.records[name]["bytes"] and cache.slab_bytes == 3 * cache.records[name]["bytes"]


def test_compose_span_counts_the_batch(cohort_root):
    """``stream.compose`` carries the batch's distinct subjects, the banks
    built for it and the slab's bytes; ``bank.fill`` the fill's subjects,
    bytes and threads, its builds nested under it."""
    ds = FetalSynthDataset(str(cohort_root), _port_generator(), str(cohort_root / "derivatives" / "seeds"))
    stream = tstream.SyntheticStream(ds, batch_size=4, seed=8, prefetch=False, mix_subjects=6)
    trace.drain()
    trace.enable()
    try:
        batches = _batches(stream, 2)
    finally:
        trace.disable()
    recs = trace.drain()
    compose = [r for r in recs if r["name"] == "stream.compose"]
    want = [{"subjects": len(set(b["name"])), "filled": f, "slab_bytes": 6 * ONE_BANK}
            for b, f in zip(batches, (6, 0))]
    assert [r["attrs"] for r in compose] == want
    (fill,) = [r for r in recs if r["name"] == "bank.fill"]
    assert fill["attrs"] == {"subjects": 6, "threads": min(6, tstream.FILL_THREADS), "bytes": 6 * ONE_BANK}
    nested = [r for r in recs if r["name"] in ("bank.decode", "bank.to_ras")]
    assert len(nested) == 6 * 4 and all(r["parent"] == fill["id"] for r in nested)  # seeds and seg, each subject


@pytest.mark.parametrize("perm, signs", [((0, 1, 2), (1, 1, 1)), ((2, 0, 1), (1, -1, 1)), ((1, 2, 0), (-1, -1, -1))])
def test_narrow_then_orient_is_to_ras(perm, signs):
    """A bank's volume narrowed in its files' order on the host, then
    reoriented where the slab lives, equals ``nifti.to_ras`` of it, for
    axes permuted and flipped and a volume that is not a cube."""
    rng = np.random.default_rng(sum(perm) + signs[0])
    a = np.asfortranarray(rng.integers(-300, 300, (5, 6, 7)).astype(np.int32))
    affine = np.eye(4)
    affine[:3, :3] = 0.5 * np.eye(3)[:, list(perm)] * np.asarray(signs)[None, :]
    want = nifti.to_ras(a.astype(np.int8), affine)[0]
    for dtype in (torch.int8, torch.int16):
        flat = torch.empty(a.size, dtype=dtype)
        tstream._narrow_into(flat, a)
        dst = torch.empty(want.shape, dtype=dtype)
        tstream._orient_into(dst, flat, affine)
        np.testing.assert_array_equal(dst.numpy(), nifti.to_ras(a.astype(dst.numpy().dtype), affine)[0])
    assert dst.shape == want.shape
