"""The port's public API on the CPU: the dataset contract (following
``tests/test_datasets.py``), genparams replay, the YAML configs, and a JAX
genparams dict replayed in the port.

The port's generator runs on ``device="cpu"`` here (its plain paths); the
card runs the same API in ``chip_smoke.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from fetalsyngen_torch.config import instantiate, load_and_instantiate, load_yaml, resolve_interpolations
from fetalsyngen_torch.data.datasets import FetalSynthDataset, FetalTestDataset
from fetalsyngen_torch.generator.model import (
    ARTIFACTS,
    FetalSynthGen,
    ImageFromSeeds,
    RandBiasField,
    RandGamma,
    RandNoise,
    RandResample,
    SpatialDeformation,
    _HostSeedCache,
)
from fetalsyngen_torch.generator.params import overrides_from_genparams
from fetalsyngen_torch.io import nifti
from fetalsyngen_torch.testing import FIXTURE_SUBJECTS, build_bids_tree

SHAPE = (32, 32, 32)
LABELS = [0] + list(range(10, 50))
GEN_CLASSES = [0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))


@pytest.fixture(scope="module")
def bids_root(tmp_path_factory):
    return build_bids_tree(tmp_path_factory.mktemp("bids"), shape=SHAPE)


def small_generator(nonlinear=True, seed=0, device="cpu", **kw):
    return FetalSynthGen(
        shape=SHAPE,
        resolution=(0.5, 0.5, 0.5),
        intensity_generator=ImageFromSeeds(1, 2, LABELS, GEN_CLASSES),
        spatial_deform=SpatialDeformation(20, 0.02, 0.1, SHAPE, 0.9, nonlinear, 0.03, 0.06, 4.0, 0.5),
        resampler=RandResample(0.9, 0.5, 1.5),
        bias_field=RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=RandNoise(0.9, 5, 15),
        gamma=RandGamma(0.9, 0.1),
        device=device,
        seed=seed,
        **kw,
    )


def seed_ds(root, **kw):
    return FetalSynthDataset(str(root), small_generator(), str(root / "derivatives" / "seeds"), **kw)


def test_discovery_and_getitem_contract(bids_root):
    ds = seed_ds(bids_root)
    assert len(ds) == len(FIXTURE_SUBJECTS)
    assert set(ds.seed_paths[FIXTURE_SUBJECTS[0]].keys()) == {1, 2}
    item = ds[0]
    img, lab = item["image"], item["label"]
    assert img.shape == (1, *SHAPE) and img.dtype == np.float32
    assert lab.shape == (1, *SHAPE) and lab.dtype == np.int64
    assert 0.0 <= img.min() and img.max() <= 1.0 and img.max() == pytest.approx(1.0)
    assert item["name"] == FIXTURE_SUBJECTS[0]
    assert "generation_time" in ds.generation_params
    assert set(np.unique(lab)) <= set(np.unique(nifti.load_ras(ds.segm_paths[0]).data))


@pytest.mark.parametrize("json_roundtrip", [False, True])
def test_genparams_replay_is_bit_identical(bids_root, json_roundtrip):
    ds = seed_ds(bids_root)
    first = ds.sample_with_meta(1)
    gp = first["generation_params"]
    if json_roundtrip:
        gp = json.loads(json.dumps(gp, default=lambda o: np.asarray(o).tolist()))
    second = ds.sample_with_meta(1, genparams=gp)
    np.testing.assert_array_equal(second["image"], first["image"])
    np.testing.assert_array_equal(second["label"], first["label"])
    assert second["generation_params"]["selected_seeds"] == first["generation_params"]["selected_seeds"]
    # a fresh draw differs
    third = ds.sample_with_meta(1)
    assert third["generation_params"]["seed"] != gp["seed"]
    assert not np.array_equal(third["image"], first["image"])


def test_generate_then_augment_equals_sample(bids_root):
    gen = small_generator()
    ds = FetalSynthDataset(str(bids_root), gen, str(bids_root / "derivatives" / "seeds"))
    seg = nifti.load_ras(ds.segm_paths[0]).data
    seeds = ds.seed_paths[FIXTURE_SUBJECTS[0]]
    out_s, seg_s, img_s, params_s = gen.sample(None, seg, seeds, seed=7)
    out_g, seg_g, _, params_g = gen.generate(None, seg, seeds, seed=7)
    out_a, params_a = gen.augment(out_g, seg_g, seed=7)
    assert img_s is None
    assert torch.equal(out_a, out_s) and torch.equal(seg_g, seg_s)
    assert "deform_params" in params_g and "gamma_params" not in params_g
    assert "gamma_params" in params_a and "deform_params" not in params_a
    assert params_g["selected_seeds"] == params_s["selected_seeds"]
    # generate replays from its own params
    out_r, seg_r, _, _ = gen.generate(None, seg, seeds, genparams=params_g)
    assert torch.equal(out_r, out_g) and torch.equal(seg_r, seg_g)


def test_sub_list_filter(bids_root):
    assert len(seed_ds(bids_root, sub_list=[FIXTURE_SUBJECTS[0]])) == 1


@pytest.mark.parametrize("nonlinear", [True, False])
def test_image_as_intensity(bids_root, nonlinear):
    ds = FetalSynthDataset(
        str(bids_root), small_generator(nonlinear), seed_path=None, load_image=True,
        image_as_intensity=True,
    )
    first = ds.sample_with_meta(0)
    assert first["image"].shape == (1, *SHAPE) and np.isfinite(first["image"]).all()
    assert first["generation_params"]["selected_seeds"] == {}
    again = ds.sample_with_meta(0, genparams=first["generation_params"])
    np.testing.assert_array_equal(again["image"], first["image"])
    np.testing.assert_array_equal(again["label"], first["label"])


def test_test_dataset_transforms_and_inverse(bids_root):
    ds = FetalTestDataset(str(bids_root))
    item = ds[0]
    assert item["image"].shape == (1, *SHAPE) and item["label"].dtype == np.int64
    tf = load_and_instantiate("configs/dataset/transforms/inference.yaml")
    assert type(tf).__module__ == "fetalsyngen_torch.data.transforms"
    for t in tf.transforms:
        if hasattr(t, "spatial_size"):
            t.spatial_size = (40, 40, 40)
        if hasattr(t, "roi_size"):
            t.roi_size = (40, 40, 40)
    ds = FetalTestDataset(str(bids_root), transforms=tf)
    item = ds[0]
    assert item["image"].shape == (1, 40, 40, 40) and item["image"].max() <= 1.0
    rev = ds.reverse_transform(dict(item))
    assert rev["image"].shape == (1, *SHAPE)


def _small_artifacts():
    """Each SR artifact, always on, sized for SHAPE (the motion artifact on a
    64 cube)."""
    from fetalsyngen_torch.generator.artifacts import quality as q
    from fetalsyngen_torch.generator.artifacts import scanner as sc

    merge = dict(perlin_res_list=[1, 2], perlin_octaves_list=[1, 2], perlin_persistence=0.5,
                 perlin_lacunarity=2, perlin_increase_size=0.25)
    return {
        "blur_cortex": q.BlurCortex(1.0, 2, 5, 20),
        "struct_noise": q.StructNoise(1.0, 3, 0.2, 0.4, q.StructNoiseMergeParams("perlin", **merge)),
        "simulate_motion": sc.SimulateMotion(
            1.0,
            sc.ScannerParams(0.5, 2, 1.5, 1.5, 3.5, 1.5, 5.5, 1, 2, 250, 0, 0.1, 1, 2, 0.2, 0.1, 0.05),
            sc.ReconParams(0.1, 0.1, 0.1, 3.0, 0.2, 0.3, 0.1, 0.4, 1.0, q.ReconMergeParams("perlin", **merge)),
            tiers=(64,), ns_grid=32,
        ),
        "boundaries": q.SimulatedBoundaries(0.0, 1.0, 1.0),
    }


def test_artifacts_and_device_errors(monkeypatch, bids_root):
    """Each SR artifact object is accepted and runs in ``sample``; the
    device and shape checks raise."""
    seg = nifti.load_ras(seed_ds(bids_root).segm_paths[0]).data
    for name, artifact in _small_artifacts().items():
        gen = small_generator(**{name: artifact})
        out, _, _, params = gen.sample(None, seg, seed_ds(bids_root).seed_paths[FIXTURE_SUBJECTS[0]], seed=3)
        assert list(params["artifacts"]) == [name] and params["artifacts"][name], name
        assert out.shape == SHAPE and bool(torch.isfinite(out).all()), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device: cpu"):
        small_generator(device=None)
    gen = small_generator()
    with pytest.raises(ValueError, match="shape"):
        gen.sample(None, np.zeros((8, 8, 8), np.int16), None)
    with pytest.raises(ValueError, match="intensity prior"):
        gen.sample(None, np.zeros(SHAPE, np.int16), None)


def _yaml_dataset(name, root, nonlinear=True):
    """``configs/dataset/<name>.yaml`` on the fixture tree at SHAPE, with the
    generator's artifact entries removed and ``device: cpu``."""
    cfg = resolve_interpolations(load_yaml(f"configs/dataset/{name}.yaml"))
    cfg["bids_path"] = str(root)
    if cfg["seed_path"] is not None:
        cfg["seed_path"] = str(root / "derivatives" / "seeds")
    gen = cfg.pop("generator")
    for k in ARTIFACTS:
        gen.pop(k)
    gen["device"] = "cpu"
    gen["shape"] = list(SHAPE)
    gen["spatial_deform"]["size"] = list(SHAPE)
    gen["spatial_deform"]["nonlinear_transform"] = nonlinear
    gen["intensity_generator"]["max_subclusters"] = 2
    return instantiate(cfg, generator=instantiate(gen))


@pytest.mark.parametrize(
    "name, nonlinear", [("synth_train", True), ("real_train", True), ("real_train", False)]
)
def test_yaml_dataset_generates_and_replays(bids_root, name, nonlinear):
    ds = _yaml_dataset(name, bids_root, nonlinear)
    assert isinstance(ds, FetalSynthDataset) and isinstance(ds.generator, FetalSynthGen)
    first = ds.sample_with_meta(0)
    again = ds.sample_with_meta(0, genparams=first["generation_params"])
    assert 0.0 <= first["image"].min() and first["image"].max() <= 1.0
    np.testing.assert_array_equal(again["image"], first["image"])
    np.testing.assert_array_equal(again["label"], first["label"])


@pytest.mark.parametrize("nonlinear", [True, False])
def test_chip_smoke_generator_matches_yaml(nonlinear):
    """The generator ``chip_smoke.py`` builds in Python is
    ``configs/dataset/generator/default.yaml`` less its artifact entries."""
    gen_cfg = resolve_interpolations(load_yaml("configs/dataset/generator/default.yaml"))
    for k in ARTIFACTS:
        gen_cfg.pop(k)
    gen_cfg["device"] = "cpu"
    gen_cfg["spatial_deform"]["nonlinear_transform"] = nonlinear
    want = instantiate(gen_cfg).cfg
    got = chip_smoke.api_generator("cpu", nonlinear).cfg
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got == want


@pytest.mark.parametrize("forced", [False, True])
def test_chip_smoke_artifacts_match_yaml(forced):
    """The SR artifacts ``chip_smoke.py`` builds in Python are
    ``configs/dataset/generator/default.yaml``'s (``forced``: every
    probability 1, the boundaries' no-mask 0)."""
    gen_cfg = resolve_interpolations(load_yaml("configs/dataset/generator/default.yaml"))
    if forced:
        for k in ("blur_cortex", "struct_noise", "simulate_motion"):
            gen_cfg[k]["prob"] = 1.0
        gen_cfg["boundaries"].update(prob_no_mask=0.0, prob_if_mask_halo=1.0, prob_if_mask_fuzzy=1.0)
    got = chip_smoke.default_artifacts(forced)
    assert list(got) == list(ARTIFACTS)
    for k in ARTIFACTS:
        want = instantiate(gen_cfg[k])
        assert type(got[k]) is type(want) and vars(got[k]) == vars(want), k


def test_host_seed_cache_byte_budget():
    blob = np.zeros(1000, np.int16)  # 2000 bytes each
    loads = []
    cache = _HostSeedCache(max_bytes=5000, loader=lambda p: (loads.append(p), blob)[1])
    for i in range(10):
        cache.get(f"p{i}")
    assert cache.nbytes <= 5000 - 1000 and len(cache) == 2
    cache.get("p9")
    assert loads.count("p9") == 1
    cache.get("p0")
    assert loads.count("p0") == 2


def test_jax_genparams_pin_the_port(bids_root):
    """A genparams dict from the JAX ``FetalSynthDataset.sample_with_meta``
    pins every parameter it holds and ``selected_seeds`` in the port; its
    ``"key"`` is ignored and the port draws its own ``"seed"``."""
    from fetalsyngen_tpu.data.datasets import FetalSynthDataset as JaxDataset
    from fetalsyngen_tpu.generator import model as jmodel

    jgen = jmodel.FetalSynthGen(
        SHAPE, (0.5, 0.5, 0.5), jmodel.ImageFromSeeds(1, 2, LABELS, GEN_CLASSES),
        jmodel.SpatialDeformation(20, 0.02, 0.1, SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        jmodel.RandResample(0.9, 0.5, 1.5), jmodel.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        jmodel.RandNoise(0.9, 5, 15), jmodel.RandGamma(0.9, 0.1), seed=3,
    )
    jds = JaxDataset(str(bids_root), jgen, str(bids_root / "derivatives" / "seeds"))
    jgp = jds.sample_with_meta(0)["generation_params"]
    assert "key" in jgp and "seed" not in jgp

    port = seed_ds(bids_root).sample_with_meta(0, genparams=jgp)["generation_params"]
    assert port["selected_seeds"] == jgp["selected_seeds"]
    assert "key" not in port and isinstance(port["seed"], int)
    pinned, got = overrides_from_genparams(jgp), overrides_from_genparams(port)
    assert len(pinned) >= 10
    for name, value in pinned.items():
        np.testing.assert_array_equal(
            np.asarray(got[name], np.float32), np.asarray(value, np.float32), err_msg=name
        )


ART_SHAPE = (48, 48, 48)


@pytest.fixture(scope="module")
def art_root(tmp_path_factory):
    return build_bids_tree(tmp_path_factory.mktemp("bids48"), shape=ART_SHAPE)


def _default_generator_all_artifacts(seed=0):
    """``configs/dataset/generator/default.yaml`` at 48^3 on the CPU, every SR
    artifact forced on (prob 1; boundaries: halo and fuzzy), the motion
    artifact on a 96 cube with 32 slice rows (its default tiers are sized
    for 256^3)."""
    gen = resolve_interpolations(load_yaml("configs/dataset/generator/default.yaml"))
    gen.update(device="cpu", shape=list(ART_SHAPE), seed=seed)
    gen["spatial_deform"]["size"] = list(ART_SHAPE)
    gen["intensity_generator"]["max_subclusters"] = 2
    for k in ("blur_cortex", "struct_noise", "simulate_motion"):
        gen[k]["prob"] = 1.0
    gen["simulate_motion"].update(tiers=[96], ns_grid=32)
    gen["boundaries"].update(prob_no_mask=0.0, prob_if_mask_halo=1.0, prob_if_mask_fuzzy=1.0)
    return instantiate(gen)


@pytest.fixture(scope="module")
def art_sample(art_root):
    gen = _default_generator_all_artifacts()
    ds = FetalSynthDataset(str(art_root), gen, str(art_root / "derivatives" / "seeds"))
    return ds, ds.sample_with_meta(0)


def test_default_generator_runs_all_artifacts(art_sample):
    ds, item = art_sample
    gen = ds.generator
    assert [type(gen.artifacts[k]).__module__ for k in ARTIFACTS] == [
        "fetalsyngen_torch.generator.artifacts.quality",
        "fetalsyngen_torch.generator.artifacts.quality",
        "fetalsyngen_torch.generator.artifacts.scanner",
        "fetalsyngen_torch.generator.artifacts.quality",
    ]
    meta = item["generation_params"]["artifacts"]
    assert list(meta) == list(ARTIFACTS)
    assert meta["blur_cortex"]["nblur"] is not None and "nstages" in meta["struct_noise"]
    assert meta["simulate_motion"]["nstacks"] >= 1 and "device_seed" in meta["simulate_motion"]
    assert meta["boundaries"] == {"no_mask_on": False, "halo_on": True, "fuzzy_on": True}
    img = item["image"]
    assert img.shape == (1, *ART_SHAPE) and np.isfinite(img).all() and 0 <= img.min() <= img.max() <= 1


def test_artifact_genparams_replay_is_bit_identical(art_sample):
    ds, item = art_sample
    gp = json.loads(json.dumps(item["generation_params"], default=lambda o: np.asarray(o).tolist()))
    again = ds.sample_with_meta(0, genparams=gp)
    np.testing.assert_array_equal(again["image"], item["image"])
    np.testing.assert_array_equal(again["label"], item["label"])
    assert again["generation_params"]["artifacts"] == gp["artifacts"]


def test_artifact_pins_are_honored(art_sample):
    """A pin replaces its draw and leaves the later draws of the artifact's
    stream unchanged (the JAX package's ``tests/test_artifacts.py:430-443``)."""
    ds, item = art_sample
    gp = item["generation_params"]
    meta = gp["artifacts"]
    pins = {
        "blur_cortex": {"nblur": meta["blur_cortex"]["nblur"] + 7},
        "struct_noise": {"nstages": 1 + meta["struct_noise"]["nstages"] % 4},
        "simulate_motion": {"slice_thickness": meta["simulate_motion"]["slice_thickness"] * 1.3},
    }
    pinned = ds.sample_with_meta(0, genparams={"seed": gp["seed"], "artifacts": pins})
    got = pinned["generation_params"]["artifacts"]
    assert got["blur_cortex"]["nblur"] == pins["blur_cortex"]["nblur"]
    assert got["blur_cortex"]["std_blurs"] == meta["blur_cortex"]["std_blurs"]
    assert got["struct_noise"]["nstages"] == pins["struct_noise"]["nstages"]
    assert got["struct_noise"]["noise_std"] == meta["struct_noise"]["noise_std"]
    sm = got["simulate_motion"]
    assert sm["slice_thickness"] == pytest.approx(pins["simulate_motion"]["slice_thickness"])
    assert sm["gap"] == meta["simulate_motion"]["gap"]
    assert sm["resolution_slice"] == meta["simulate_motion"]["resolution_slice"]
    assert got["boundaries"] == meta["boundaries"]
    assert not np.array_equal(pinned["image"], item["image"])


def test_augment_applies_artifacts(art_root):
    gen = _default_generator_all_artifacts()
    gen.artifacts["simulate_motion"] = None  # the motion artifact is covered by sample above
    seg = nifti.load_ras(FetalTestDataset(str(art_root)).segm_paths[0]).data
    image = nifti.load_ras(FetalTestDataset(str(art_root)).img_paths[0]).data
    out, params = gen.augment(image, seg, seed=11)
    assert set(params["artifacts"]) == {"blur_cortex", "struct_noise", "boundaries"}
    again, _ = gen.augment(image, seg, genparams={"seed": 11, "artifact_params": {"blur_cortex": {"nblur": 9}}})
    assert torch.equal(gen.augment(image, seg, genparams=params)[0], out)
    assert not torch.equal(again, out)
    plain = small_generator()
    assert plain.augment(image[:32, :32, :32], seg[:32, :32, :32], seed=11)[1]["artifacts"] == {}


def test_entry_script_runs_the_yaml_untrimmed(art_root, tmp_path):
    """``python -m fetalsyngen_torch.test`` builds ``synth_train.yaml``'s
    generator with its four artifacts and generates on the CPU at 48^3."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "fetalsyngen_torch.test", "--config", "configs/dataset/synth_train.yaml",
         "--bids_path", str(art_root), "--seed_path", str(art_root / "derivatives" / "seeds"),
         "--device", "cpu", "--shape", "48", "--count", "1", "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dataset: FetalSynthDataset" in r.stdout and "not yet ported" not in r.stdout
    meta = json.loads((tmp_path / "out" / "image_0.json").read_text())
    assert set(meta["artifacts"]) <= set(ARTIFACTS) and "boundaries" in meta["artifacts"]
