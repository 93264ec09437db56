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


def test_artifacts_and_device_errors(monkeypatch):
    for name in ARTIFACTS:
        with pytest.raises(NotImplementedError, match="items 4 and 6"):
            small_generator(**{name: object()})
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
