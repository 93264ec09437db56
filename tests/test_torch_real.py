"""The port on the real anatomy of the in-repo ``data/sub-sta21`` fixture, on
a 48^3 crop around the label centroid: the pipeline against JAX
``_synth_core`` (the seed path, the image as intensity with the co-deformed
T2w, and that without the nonlinear field), and the dataset API from the
repository's YAMLs, generating and replaying bit-identically.
"""

from pathlib import Path

import numpy as np
import pytest

from fetalsyngen_torch.config import instantiate, load_yaml, resolve_interpolations
from fetalsyngen_torch.generator.model import ARTIFACTS
from fetalsyngen_torch.io import nifti as tnifti
from fetalsyngen_tpu.io import nifti as jnifti

from test_torch_pipeline import _cfg, check_core_matches_jax, jconfig

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "data"
CROP = 48
ANAT = "sub-sta21/anat"
SEEDS = "derivatives/seeds/subclasses_{n}/sub-sta21/anat/sub-sta21_rec-irtk_T2w_dseg_mlabel_{m}.nii.gz"


def _crop_slices():
    seg = tnifti.load_ras(DATA / ANAT / "sub-sta21_rec-irtk_T2w_dseg.nii.gz").data
    c = np.round(np.argwhere(seg > 0).mean(0)).astype(int)
    return tuple(slice(ci - CROP // 2, ci - CROP // 2 + CROP) for ci in c)


def _load_crop(rel, sl):
    """``rel`` through both packages' loaders (held equal), cropped."""
    t, j = tnifti.load_ras(DATA / rel), jnifti.load_ras(DATA / rel)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.affine, j.affine)
    return np.ascontiguousarray(t.data[sl]), t.affine


@pytest.fixture(scope="module")
def crop():
    sl = _crop_slices()
    t2w = _load_crop(f"{ANAT}/sub-sta21_rec-irtk_T2w.nii.gz", sl)[0]
    seg = _load_crop(f"{ANAT}/sub-sta21_rec-irtk_T2w_dseg.nii.gz", sl)[0]
    # one subcluster count per meta-label, summed as ImageFromSeeds does
    counts = {1: 3, 2: 2, 3: 4, 4: 1}
    seeds = sum(
        tnifti.load_ras(DATA / SEEDS.format(n=n, m=m)).data[sl].astype(np.int16)
        for m, n in counts.items()
    )
    return t2w.astype(np.float32), seg.astype(np.int32), seeds.astype(np.int32)


# (nonlinear_transform, image as intensity + co-deformed, key, force gates)
REAL_CASES = {
    "seeds": (True, False, 0, False),
    "image_prior": (True, True, 3, False),
    "affine_image_prior": (False, True, 5, True),
}


@pytest.mark.parametrize("case", list(REAL_CASES))
def test_real_crop_pipeline_matches_jax(case, crop):
    nonlinear, image_prior, k, force = REAL_CASES[case]
    t2w, seg, seeds = crop
    assert len(np.unique(seg)) >= 5 and 0.05 < (seg > 0).mean()
    shape = (CROP,) * 3
    prior = None
    if image_prior:
        lo, hi = t2w.min(), t2w.max()
        prior = ((t2w - lo) / (hi - lo) * np.float32(255.0)).astype(np.float32)
    check_core_matches_jax(
        _cfg(nonlinear=nonlinear, shape=shape), _cfg(mod=jconfig, nonlinear=nonlinear, shape=shape),
        k, force, seeds, seg, t2w if image_prior else None, prior, ("intensity", "deform", "augment"),
    )


@pytest.fixture(scope="module")
def crop_tree(tmp_path_factory):
    """The fixture's BIDS tree (images, dseg, the whole seed tree) cropped."""
    root = tmp_path_factory.mktemp("sta21_crop")
    sl = _crop_slices()
    for f in DATA.rglob("*.nii.gz"):
        img = tnifti.load(f)
        out = root / f.relative_to(DATA)
        out.parent.mkdir(parents=True, exist_ok=True)
        tnifti.save(out, np.ascontiguousarray(tnifti.load_ras(f).data[sl]), img.affine)
    return root


@pytest.mark.parametrize(
    "name, nonlinear", [("synth_train", True), ("real_train", True), ("real_train", False)]
)
def test_real_crop_dataset_generates_and_replays(crop_tree, name, nonlinear):
    cfg = resolve_interpolations(load_yaml(f"configs/dataset/{name}.yaml"))
    cfg["bids_path"] = str(crop_tree)
    if cfg["seed_path"] is not None:
        cfg["seed_path"] = str(crop_tree / "derivatives" / "seeds")
    gen = cfg.pop("generator")
    for k in ARTIFACTS:
        gen.pop(k)
    gen["device"] = "cpu"
    gen["shape"] = [CROP] * 3
    gen["spatial_deform"]["size"] = [CROP] * 3
    gen["spatial_deform"]["nonlinear_transform"] = nonlinear
    ds = instantiate(cfg, generator=instantiate(gen))
    assert len(ds) == 1
    first = ds.sample_with_meta(0)
    img, lab = first["image"], first["label"]
    assert img.shape == (1, CROP, CROP, CROP) and np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 1.0
    seg_in = tnifti.load_ras(ds.segm_paths[0]).data
    assert set(np.unique(lab)) <= set(np.unique(seg_in))
    again = ds.sample_with_meta(0, genparams=first["generation_params"])
    np.testing.assert_array_equal(again["image"], img)
    np.testing.assert_array_equal(again["label"], lab)
