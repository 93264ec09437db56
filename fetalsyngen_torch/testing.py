"""Procedural test data (copies of ``fetalsyngen_tpu.testing``'s builders).

Numpy only; the same seed or rng gives the same arrays and files as the JAX
package's functions, so both packages can be driven on identical inputs.
:func:`build_bids_tree` writes a mini-BIDS tree with the layout of the
in-repo ``data/`` fixture (``sub-*/anat/*_T2w.nii.gz``, ``*_dseg.nii.gz``,
``derivatives/seeds/subclasses_N/sub-*/anat/*_mlabel_M.nii.gz``), so the
dataset API runs without external data.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE_SHAPE = (64, 64, 64)
FIXTURE_SUBJECTS = ("sub-aaa", "sub-bbb")
FIXTURE_N_SUBCLASSES = (1, 2)


def make_phantom(rng: np.random.Generator, shape=FIXTURE_SHAPE):
    """Sphere-in-sphere phantom: seg labels 0..7, plausible T2w-ish image."""
    zz = np.stack(
        np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    )
    r = np.sqrt((zz**2).sum(0))
    seg = np.zeros(shape, dtype=np.int16)
    seg[r < 0.9] = 1  # CSF
    seg[r < 0.7] = 2  # GM
    seg[r < 0.5] = 3  # WM
    seg[r < 0.2] = 4  # deep
    img = (seg.astype(np.float32) * 60 + rng.normal(0, 5, shape)).clip(0, 255)
    return img.astype(np.float32), seg


def build_bids_tree(
    root: Path, rng: np.random.Generator | None = None, shape=FIXTURE_SHAPE, subjects=FIXTURE_SUBJECTS
) -> Path:
    """Write a complete mini-BIDS tree (images, dseg, seed derivative tree)
    of ``subjects``, each a phantom of its own."""
    from .io import nifti

    rng = rng or np.random.default_rng(7)
    affine = np.diag([0.5, 0.5, 0.5, 1.0])
    for sub in subjects:
        anat = root / sub / "anat"
        anat.mkdir(parents=True, exist_ok=True)
        img, seg = make_phantom(rng, shape)
        nifti.save(anat / f"{sub}_T2w.nii.gz", img, affine)
        nifti.save(anat / f"{sub}_dseg.nii.gz", seg, affine)
        for n_sub in FIXTURE_N_SUBCLASSES:
            for mlabel in range(1, 5):
                sdir = root / "derivatives" / "seeds" / f"subclasses_{n_sub}" / sub / "anat"
                sdir.mkdir(parents=True, exist_ok=True)
                # seeds for meta-label m live in [10*m, 10*m + n_sub)
                seed = np.zeros(shape, dtype=np.int8)
                region = seg == mlabel
                labels = 10 * mlabel + rng.integers(0, n_sub, size=int(region.sum()))
                seed[region] = labels.astype(np.int8)
                nifti.save(sdir / f"{sub}_dseg_mlabel_{mlabel}.nii.gz", seed, affine)
    return root


def scanner_ab_case(cube: int = 128, ns_grid: int = 32):
    """Deterministic single-stack scanner geometry for A/B tests (copy of
    ``fetalsyngen_tpu.testing.scanner_ab_case``, built with the port's host
    modules): a blurred box phantom (96^3) and its mask, a production-scale
    gap (gap_vox = 4) with recorded-trajectory motion. Returns the phantom,
    the stack geometry and the scalars :func:`run_scanner_ab` takes."""
    from scipy.ndimage import gaussian_filter

    from .generator.artifacts import scanner as sc
    from .generator.artifacts.motion import sample_motion
    from .generator.artifacts.transforms import random_init_stack_transforms

    rng = np.random.default_rng(11)
    shape = (96, 96, 96)
    base = np.zeros(shape, np.float32)
    base[20:76, 24:72, 22:74] = 100.0
    vol = gaussian_filter(
        base + rng.normal(0, 5, shape).astype(np.float32) * (base > 0), 1.0
    ).astype(np.float32)
    mask = (vol > 5).astype(np.float32)

    res, res_s, thick, gap = 0.5, 0.7, 2.0, 2.0
    rs, gap_vox = res_s / res, gap / res
    ns = min(int(max(shape) * res / gap) + 2, ns_grid)
    t_init = random_init_stack_transforms(ns, gap, False, 3.0, rng)
    t_target = sample_motion(np.arange(ns) * 1.0, rng).compose(t_init)
    mats_vox = t_target.matrix(True).copy()
    mats_vox[:, :, 3] /= res
    geo = sc._stack_geometry(t_init.matrix(True)[0, :, :3], mats_vox, shape, ns, cube, ns_grid)
    z0 = float((cube - 1) / 2.0 - (ns - 1) / 2.0 * gap_vox)
    inv = sc.decompose_affine_paeth_host(geo["Minv"], -geo["Minv"] @ geo["t_stack"], cube)
    return dict(
        shape=shape, vol=vol, mask=mask, res=res, rs=rs, gap_vox=gap_vox,
        thick=thick, ns=ns, z0=z0, geo=geo, mats_vox=mats_vox, inv=inv,
        sig=(sc.GAUSSIAN_FWHM * thick / res, sc.SINC_FWHM * rs, sc.SINC_FWHM * rs),
        sig_rec=(sc.GAUSSIAN_FWHM * thick / res, sc.SINC_FWHM * rs),
    )


def run_scanner_ab(case, cube: int = 128, ns_grid: int = 32, device="cpu"):
    """One acquisition and reconstruction of :func:`scanner_ab_case` through
    the port's per-stack functions on ``device``, with the JAX package's
    ``run_scanner_ab`` settings (validity threshold 0.15, no gamma, noise or
    voids). Returns numpy (slices, valid, value, weight)."""
    import torch

    from .generator.artifacts import scanner as sc
    from .generator.artifacts.draws import make_generator

    s = case
    f32 = torch.float32

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), dtype=f32, device=device)

    slices, valid = sc._acquire_one(
        sc._pad_centered(dev(s["vol"]), cube), sc._pad_centered(dev(s["mask"]), cube),
        sc._fwd_tensors(s["geo"]["fwd"], device), dev(s["geo"]["G"]),
        sc._f32(s["rs"]), sc._f32(s["gap_vox"]), sc._f32(s["z0"]), dev(s["sig"]),
        sc._f32(0.15), s["ns"], 1.0, False, 0.0, 0.0, sc._f32(0.1), cube, ns_grid,
        sc.draw_slice_artifacts(make_generator(0, device), ns_grid, cube, device),
    )
    v_s, w_s = sc._recon_one(
        slices, valid, dev(s["geo"]["G"]), sc._f32(s["rs"]), sc._f32(s["gap_vox"]),
        sc._f32(s["z0"]), dev(s["sig_rec"]), sc._fwd_tensors(s["inv"], device),
        cube, ns_grid, s["shape"],
    )
    return tuple(t.cpu().numpy() for t in (slices, valid, v_s, w_s))


def phantom_seeds_and_seg(shape=(256, 256, 256), seed: int = 0):
    """Procedural (seeds, segmentation) pair shaped like real preprocessed data.

    Concentric-ellipsoid anatomy with per-meta-label subcluster seeds in the
    reference's label layout (meta-label m -> labels ``10*m .. 10*m+2``,
    ``rand_gmm.py:77``) and a FeTA-like 0..7 segmentation.
    """
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    scales = 0.8 + 0.2 * rng.random(3)  # random ellipsoid radii per call
    r = np.sqrt(sum((g / s) ** 2 for g, s in zip(grids, scales)))

    seg = np.zeros(shape, dtype=np.int16)
    radii = [0.95, 0.8, 0.62, 0.45, 0.3, 0.18, 0.08]
    for lab, rad in enumerate(radii, start=1):
        seg[r < rad] = lab

    # meta-label partition: skull/extra (4), CSF (1), GM (2), WM (3)
    meta = np.zeros(shape, dtype=np.int16)
    meta[(seg == 1) | (seg == 4)] = 1
    meta[(seg == 2) | (seg == 6)] = 2
    meta[(seg == 3) | (seg == 5) | (seg == 7)] = 3
    meta[(r >= 0.95) & (r < 1.05)] = 4

    seeds = np.zeros(shape, dtype=np.int16)
    mask = meta > 0
    sub = rng.integers(0, 3, size=int(mask.sum()))  # three subclusters per meta-label
    seeds[mask] = (10 * meta[mask] + sub).astype(np.int16)
    return seeds, seg
