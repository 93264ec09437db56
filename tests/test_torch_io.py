"""The port's copies of host-only modules held equal to the JAX package's:
NIfTI I/O, the dict transforms, the config loader and the mini-BIDS builder.
"""

from pathlib import Path

import numpy as np
import pytest

import fetalsyngen_torch.testing as ttesting
import fetalsyngen_tpu.testing as jtesting
from fetalsyngen_torch import config as tconfig
from fetalsyngen_torch.io import nifti as tnifti
from fetalsyngen_tpu import config as jconfig
from fetalsyngen_tpu.io import nifti as jnifti

REPO = Path(__file__).resolve().parent.parent
ANAT = REPO / "data" / "sub-sta21" / "anat"
FIXTURE_FILES = [
    ANAT / "sub-sta21_rec-irtk_T2w.nii.gz",
    ANAT / "sub-sta21_rec-irtk_T2w_dseg.nii.gz",
    REPO / "data/derivatives/seeds/subclasses_3/sub-sta21/anat/sub-sta21_rec-irtk_T2w_dseg_mlabel_2.nii.gz",
]


def _same_image(a, b):
    assert a.data.dtype == b.data.dtype
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.affine, b.affine)


@pytest.mark.parametrize("path", FIXTURE_FILES, ids=lambda p: p.name.split("_rec-irtk_")[-1])
def test_nifti_load_matches_jax(path, tmp_path):
    _same_image(tnifti.load(path), jnifti.load(path))
    _same_image(tnifti.load_ras(path), jnifti.load_ras(path))
    # a save/load roundtrip through the port of a 64^3 block of the file,
    # read back by both packages
    img = tnifti.load(path)
    img = tnifti.NiftiImage(np.ascontiguousarray(img.data[96:160, 96:160, 96:160]), img.affine)
    for name in ("vol.nii.gz", "vol.nii"):
        tnifti.save(tmp_path / name, img.data, img.affine)
        _same_image(tnifti.load(tmp_path / name), img)
        _same_image(jnifti.load(tmp_path / name), img)


def _inference_chain(mod, size):
    tf = mod.load_and_instantiate("configs/dataset/transforms/inference.yaml")
    for t in tf.transforms:
        if hasattr(t, "spatial_size"):
            t.spatial_size = size
        if hasattr(t, "roi_size"):
            t.roi_size = size
    return tf


def test_transforms_match_jax():
    """The inference chain (reorientation, fill, foreground crop, spacing,
    pad, centre crop, scaling) and its inverse, on an oblique-spacing
    flipped volume so every step acts."""
    rng = np.random.default_rng(4)
    shape = (20, 24, 18)
    img = rng.random((1, *shape), np.float32)
    img[:, :2] = 0.0
    img[0, 5, 5, 5] = np.nan
    lab = rng.integers(0, 5, (1, *shape))
    affine = np.diag([-0.6, 0.5, 0.7, 1.0])
    data = {"image": img, "label": lab, "image_affine": affine, "label_affine": affine}
    tf_t = _inference_chain(tconfig, (24, 24, 24))
    tf_j = _inference_chain(jconfig, (24, 24, 24))
    assert type(tf_t).__module__ == "fetalsyngen_torch.data.transforms"
    out_t, out_j = tf_t(dict(data)), tf_j(dict(data))
    assert out_t.keys() == out_j.keys()
    for k in ("image", "label", "image_affine", "label_affine"):
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    assert out_t["image"].shape == (1, 24, 24, 24)
    inv_t, inv_j = tf_t.inverse(dict(out_t)), tf_j.inverse(dict(out_j))
    for k in ("image", "label"):
        np.testing.assert_array_equal(inv_t[k], inv_j[k], err_msg=k)


@pytest.mark.parametrize(
    "path", ["configs/test.yaml", "configs/dataset/synth_train.yaml", "configs/dataset/real_train.yaml",
             "configs/dataset/testing.yaml"],
)
def test_config_load_matches_jax(path):
    raw = tconfig.load_yaml(path)
    assert raw == jconfig.load_yaml(path)
    resolved = tconfig.resolve_interpolations(raw)
    assert resolved == jconfig.resolve_interpolations(raw)


def test_config_prefix_rewrite():
    gen = tconfig.resolve_interpolations(tconfig.load_yaml("configs/dataset/generator/default.yaml"))
    for k in ("blur_cortex", "struct_noise", "simulate_motion", "boundaries"):
        gen.pop(k)
    assert gen["_target_"] == "fetalsyngen_tpu.generator.model.FetalSynthGen"
    assert gen["spatial_deform"]["device"] is None  # interpolated from ${..device}
    gen["device"] = "cpu"
    obj = tconfig.instantiate(gen)
    assert type(obj).__module__ == "fetalsyngen_torch.generator.model"
    assert type(obj.intensity_generator).__module__ == "fetalsyngen_torch.generator.model"
    # targets outside the JAX package are imported as they are
    od = tconfig.instantiate({"_target_": "collections.OrderedDict", "a": 1})
    assert type(od).__module__ == "collections" and od["a"] == 1


def test_build_bids_tree_matches_jax(tmp_path):
    shape = (16, 18, 14)
    t_root = ttesting.build_bids_tree(tmp_path / "t", np.random.default_rng(5), shape)
    j_root = jtesting.build_bids_tree(tmp_path / "j", np.random.default_rng(5), shape)
    t_files = sorted(p.relative_to(t_root) for p in t_root.rglob("*.nii.gz"))
    j_files = sorted(p.relative_to(j_root) for p in j_root.rglob("*.nii.gz"))
    assert t_files == j_files and len(t_files) == 2 * (2 + 2 * 4)
    for rel in t_files:
        _same_image(tnifti.load(t_root / rel), jnifti.load(j_root / rel))
    a, b = ttesting.make_phantom(np.random.default_rng(1), shape), jtesting.make_phantom(
        np.random.default_rng(1), shape
    )
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
