"""The port's seed-preparation path against the JAX package's on the same
inputs: ``io.native.save_gz_batch`` and ``io.nifti.save_batch``, the
Gaussian mixture of ``scripts/gmm.py`` against scikit-learn's, the
``generate_seeds``, ``resample`` and ``resize_seeds`` scripts, the
walkthrough and the console scripts.

The mixture's bars (iterations, lower bound 1e-5 relative, means and
variances 1e-4 relative, labels 1e-4 of the voxels) hold against
scikit-learn with its M-step sums accumulated in float64
(``accurate_sums``): scikit-learn sums ``nk`` along axis 0 of an (N, k)
float32 array, which numpy does row after row in float32, and its BLAS dots
over N in float32 too, which moves its own fit beyond those bars
(``test_sklearn_float32_sums_move_its_own_fit``); the port's float32 sums are
accurate. Against scikit-learn as it is (float32 throughout), the k-means++
picks, the iterations, each init's lower bound and the winning init are held.
"""

import functools
import gzip
import shutil
import sys
import tomllib
import warnings
from pathlib import Path

import numpy as np
import pytest
import sklearn.mixture
import torch
from sklearn.cluster import kmeans_plusplus as sk_kmeans_plusplus
from sklearn.mixture import _gaussian_mixture as sk_gm

from fetalsyngen_torch.io import native, nifti
from fetalsyngen_torch.scripts import generate_seeds as gs
from fetalsyngen_torch.scripts import gmm, resample, resize_seeds
from fetalsyngen_torch.testing import build_bids_tree
from fetalsyngen_tpu.io import native as jnative
from fetalsyngen_tpu.io import nifti as jnifti
from fetalsyngen_tpu.scripts import generate_seeds as jgs
from fetalsyngen_tpu.scripts import resample as jresample
from fetalsyngen_tpu.scripts import resize_seeds as jresize_seeds

REPO = Path(__file__).resolve().parent.parent
ANAT = REPO / "data" / "sub-sta21" / "anat"
T2W = ANAT / "sub-sta21_rec-irtk_T2w.nii.gz"
DSEG = ANAT / "sub-sta21_rec-irtk_T2w_dseg.nii.gz"
COMMITTED = str(REPO / "data" / "derivatives" / "seeds" / "subclasses_{n}" / "sub-sta21" / "anat")
CROP = 48
KS = (2, 6, 10)
LB_RTOL = 1e-5
MOMENT_RTOL = 1e-4
LABEL_SHARE = 1e-4
ITER_TOL_BAND = 1e-6  # iterations may differ by one where the last |Δ| is this close to tol


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def subject():
    """``data/sub-sta21`` as ``generate_seeds`` decodes it (feta map)."""
    return gs.load_subject(T2W, DSEG, "feta")


def _meta(image, segm, label_map=gs.FETA2META):
    meta = np.zeros(segm.shape, dtype=np.int16)
    for a, b in label_map.items():
        meta[segm == a] = b
    meta[(segm == 0) & (image != 0)] = 4
    return meta


@pytest.fixture(scope="module")
def crop(subject):
    """A 48^3 crop of the subject around its labels' centroid: (image, segm)."""
    image, segm, _ = subject
    c = np.round(np.argwhere(segm > 0).mean(0)).astype(int)
    sl = tuple(slice(ci - CROP // 2, ci - CROP // 2 + CROP) for ci in c)
    return np.ascontiguousarray(image[sl]), np.ascontiguousarray(segm[sl])


@pytest.fixture(scope="module")
def crop_values(crop):
    """Each meta-label's intensities on the crop (float32, 93 to 43,425 values)."""
    image, segm = crop
    meta = _meta(image, segm)
    return {m: image[meta == m] for m in range(1, 5)}


def _accurate_params(X, resp, reg_covar, covariance_type, xp=None):
    """scikit-learn's M-step (``_estimate_gaussian_parameters``, full
    covariances of one feature) with its three sums over the samples
    accumulated in float64 and rounded to the data's dtype; every other
    operation as it is."""
    r64 = resp.astype(np.float64)
    nk = r64.sum(axis=0).astype(resp.dtype) + 10 * np.finfo(resp.dtype).eps
    means = (r64.T @ X.astype(np.float64)).astype(X.dtype) / nk[:, None]
    cov = np.empty((len(nk), 1, 1), dtype=X.dtype)
    for k in range(len(nk)):
        diff = X - means[k]
        s = (r64[:, k] * diff.T.astype(np.float64)) @ diff.astype(np.float64)
        cov[k] = s.astype(X.dtype) / nk[k] + reg_covar
    return nk, means, cov


@pytest.fixture
def accurate_sums(monkeypatch):
    monkeypatch.setattr(sk_gm, "_estimate_gaussian_parameters", _accurate_params)


def _sk_fit(x, **kw):
    """scikit-learn's ``GaussianMixture(**kw).fit_predict(x[:, None])``: the
    model and the labels."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ConvergenceWarning
        sk = sklearn.mixture.GaussianMixture(**kw)
        return sk, sk.fit_predict(x[:, None])


def _check_iterations(n_iter, sk):
    """The port's iterations equal scikit-learn's, or differ by one where
    scikit-learn's |Δ| at the earlier of the two lies within
    ITER_TOL_BAND of tol."""
    if n_iter == sk.n_iter_:
        return
    assert abs(n_iter - sk.n_iter_) == 1, (n_iter, sk.n_iter_)
    hist = [-np.inf] + list(sk.lower_bounds_)
    i = min(n_iter, sk.n_iter_)
    assert abs(abs(hist[i] - hist[i - 1]) - gmm.TOL) <= ITER_TOL_BAND, (n_iter, sk.n_iter_, hist)


def _check_fit(em, i, labels, sk, sk_labels):
    """Init ``i`` of the port's EM against one scikit-learn fit under the bars."""
    _check_iterations(int(em.n_iter[i]), sk)
    lb = float(em.lower_bound[i])
    assert abs(lb - sk.lower_bound_) <= LB_RTOL * abs(sk.lower_bound_), (lb, sk.lower_bound_)
    np.testing.assert_allclose(em.means[i].numpy(), sk.means_.ravel(), rtol=MOMENT_RTOL)
    np.testing.assert_allclose(em.variances[i].numpy(), sk.covariances_.ravel(), rtol=MOMENT_RTOL)
    assert np.mean(labels != sk_labels) <= LABEL_SHARE


def _pinned_init(x, k, seed):
    """One init's starting parameters from its k-means++ picks, in the forms
    both sides take: weights that sum to 1 exactly (equal ones; they cancel
    in the first E-step), means, and Cholesky precisions as scikit-learn
    derives them from ``precisions_init`` (sqrt of the float32 square)."""
    xt = torch.from_numpy(x)
    _, means, prec = gmm.init_params(xt, torch.from_numpy(gmm.kmeans_plusplus(x, k, seed))[None])
    w = np.round(np.full(k, 1 / k) * 2**20) / 2**20
    w[-1] = 1 - w[:-1].sum()
    precisions = (prec[0].numpy() ** 2).astype(np.float32)
    return w.astype(np.float32), means[0].numpy(), precisions


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------


def _volumes(n=18):
    """``n`` small volumes of the writers' dtypes with their affines (more
    than one chunk of 16)."""
    rng = np.random.default_rng(3)
    dtypes = (np.int8, np.int16, np.float32)
    datas = [(rng.normal(size=(12, 10, 14)) * 40).astype(dtypes[i % 3]) for i in range(n)]
    affines = [np.diag([0.5 + 0.1 * i, 0.5, 0.7, 1.0]) + np.eye(4, k=3) * i for i in range(n)]
    return datas, affines


def _same_files(a, b):
    """Two NIfTI files decode to the same voxels, dtype and affine, and their
    uncompressed bytes (header included) are equal."""
    ia, ib = nifti.load(a), jnifti.load(b)
    assert ia.data.dtype == ib.data.dtype
    np.testing.assert_array_equal(ia.data, ib.data)
    np.testing.assert_array_equal(ia.affine, ib.affine)
    opener = gzip.open if str(a).endswith(".gz") else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_save_gz_batch_matches_jax(tmp_path):
    datas, affines = _volumes(5)
    headers = [nifti._prep_save(d, a) for d, a in zip(datas, affines)]
    assert [h for _, h in headers] == [jnifti._prep_save(d, a)[1] for d, a in zip(datas, affines)]
    paths = [str(tmp_path / f"t{i}.nii.gz") for i in range(5)]
    jpaths = [str(tmp_path / f"j{i}.nii.gz") for i in range(5)]
    assert native.save_gz_batch(paths, [h for _, h in headers], [d for d, _ in headers], level=1)
    assert jnative.save_gz_batch(jpaths, [h for _, h in headers], [d for d, _ in headers], level=1)
    for p, q in zip(paths, jpaths):
        _same_files(p, q)


@pytest.mark.parametrize("ext", [".nii.gz", ".nii"])
def test_save_batch_matches_jax(ext, tmp_path):
    """Native (gzip) and sequential (a plain ``.nii`` path) writes equal the
    JAX package's; 18 files span two chunks."""
    datas, affines = _volumes()
    names = [f"v{i}{ext}" for i in range(len(datas))]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    nifti.save_batch([tmp_path / "t" / n for n in names], datas, affines)
    jnifti.save_batch([tmp_path / "j" / n for n in names], datas, affines)
    for n in names:
        _same_files(tmp_path / "t" / n, tmp_path / "j" / n)


def test_save_batch_without_native_library_says_why(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and ``build_error`` holds its
    message; ``save_batch`` then writes sequentially, the same bytes."""
    datas, affines = _volumes(4)
    paths = [tmp_path / f"n{i}.nii.gz" for i in range(4)]
    nifti.save_batch(paths, datas, affines)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    seq = [tmp_path / f"s{i}.nii.gz" for i in range(4)]
    nifti.save_batch(seq, datas, affines)
    assert not native.available() and "no-such-compiler" in native.build_error()
    for p, q in zip(paths, seq):
        _same_files(q, p)


# ---------------------------------------------------------------------------
# the Gaussian mixture
# ---------------------------------------------------------------------------


def _repeated(n=20000):
    """Integer-valued data with many repeats: ties in every potential."""
    rng = np.random.default_rng(11)
    return np.round(rng.gamma(3.0, 40.0, size=n)).astype(np.float32)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("data", ["meta1", "meta2", "meta3", "meta4", "repeated"])
def test_kmeans_plusplus_matches_sklearn(data, k, crop_values):
    """Five seeds, and five inits drawn in turn from one ``RandomState``:
    scikit-learn's indices exactly."""
    x = _repeated() if data == "repeated" else crop_values[int(data[-1])]
    for seed in range(5):
        np.testing.assert_array_equal(
            gmm.kmeans_plusplus(x, k, seed), sk_kmeans_plusplus(x[:, None], k, random_state=seed)[1]
        )
    rs, rs_sk = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(gmm.N_INIT):
        np.testing.assert_array_equal(
            gmm.kmeans_plusplus(x, k, rs), sk_kmeans_plusplus(x[:, None], k, random_state=rs_sk)[1]
        )


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", [1, 2, 3])
def test_em_with_pinned_init_matches_sklearn(m, k, crop_values, accurate_sums):
    """The EM from one init pinned on both sides (``weights_init``,
    ``means_init``, ``precisions_init``) under the bars, for three seeds' picks."""
    x = crop_values[m]
    xt = torch.from_numpy(x)
    for seed in range(3):
        w, means, precisions = _pinned_init(x, k, seed)
        prec = torch.from_numpy(np.sqrt(precisions))[None]
        em = gmm.fit_em(xt, torch.from_numpy(w)[None], torch.from_numpy(means)[None], prec)
        labels = gmm._e_step(xt, em.weights, em.means, em.prec)[1][0].argmax(-1).numpy()
        sk, sk_labels = _sk_fit(x, n_components=k, weights_init=w, means_init=means[:, None],
                                precisions_init=precisions[:, None, None])
        _check_fit(em, 0, labels, sk, sk_labels)


def test_sklearn_float32_sums_move_its_own_fit(crop_values):
    """Why the moments are held against ``accurate_sums``: from the same
    pinned inits, scikit-learn's float32 sums alone move its variances by
    more than the 1e-4 bar, while its iterations and lower bounds stay
    within theirs."""
    x = crop_values[2]
    worst = 0.0
    for k in (6, 10):
        for seed in range(3):
            w, means, precisions = _pinned_init(x, k, seed)
            kw = dict(n_components=k, weights_init=w, means_init=means[:, None],
                      precisions_init=precisions[:, None, None])
            plain, _ = _sk_fit(x, **kw)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sk_gm, "_estimate_gaussian_parameters", _accurate_params)
                accurate, _ = _sk_fit(x, **kw)
            assert plain.n_iter_ == accurate.n_iter_
            assert abs(plain.lower_bound_ - accurate.lower_bound_) <= LB_RTOL * abs(accurate.lower_bound_)
            rel = np.abs(plain.covariances_ - accurate.covariances_) / accurate.covariances_
            worst = max(worst, float(rel.max()))
    assert worst > MOMENT_RTOL


@pytest.mark.parametrize("k", KS)
def test_fit_predict_matches_sklearn(k, crop_values):
    """``fit_predict`` with one ``random_state`` on both sides: every init's
    iterations and lower bound (scikit-learn's inits refitted one by one from
    one ``RandomState``, in turn), the same winning init, its moments and the
    labels under the bars; against scikit-learn as it is (float32 sums) the
    iterations, lower bounds and winner still agree."""
    x = crop_values[2]
    for seed in (0, 1):
        fit = gmm.fit_predict(x, k, random_state=seed, device="cpu")
        for sums in ("float64", "float32"):
            with pytest.MonkeyPatch.context() as mp:
                if sums == "float64":
                    mp.setattr(sk_gm, "_estimate_gaussian_parameters", _accurate_params)
                rs = np.random.RandomState(seed)
                per_init = [_sk_fit(x, n_components=k, init_params="k-means++", random_state=rs)[0]
                            for _ in range(gmm.N_INIT)]
                sk, sk_labels = _sk_fit(x, n_components=k, n_init=gmm.N_INIT, init_params="k-means++",
                                        random_state=seed)
            for i, one in enumerate(per_init):
                _check_iterations(int(fit.em.n_iter[i]), one)
                assert abs(float(fit.em.lower_bound[i]) - one.lower_bound_) <= LB_RTOL * abs(one.lower_bound_)
            assert gmm.best_init([one.lower_bound_ for one in per_init]) == fit.best
            assert sk.lower_bound_ == per_init[fit.best].lower_bound_
            if sums == "float64":
                _check_fit(fit.em, fit.best, fit.labels.numpy(), sk, sk_labels)


def test_gmm_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        gmm.fit_predict(np.arange(10, dtype=np.float32), 2, random_state=0, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        gs.main(["--bids_path", ".", "--out_path", ".", "--annotation", "feta"])


# ---------------------------------------------------------------------------
# generate_seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("annotation", ["feta", "dhcp"])
def test_split_labels_one_subclass_matches_jax(annotation):
    """Full 256^3 ``sub-sta21``: voxel-identical to the JAX script for both
    annotations. The committed ``subclasses_1`` tree differs from the feta
    map's output on exactly the 23,943 voxels of segmentation label 4 (the
    ventricles), which the committed tree puts in the skull class 4 and the
    feta map in meta-label 1."""
    image, segm, _ = gs.load_subject(T2W, DSEG, annotation)
    jimage, jsegm = image.copy(), segm.copy()
    got = gs.split_labels(image, segm, 1, gs.FETA2META if annotation == "feta" else gs.DHCP2META, device="cpu")
    want = jgs.split_labels(jimage, jsegm, 1, jgs.FETA2META if annotation == "feta" else jgs.DHCP2META)
    assert got.keys() == want.keys() == {1, 2, 3, 4}
    for m in got:
        assert got[m].dtype == want[m].dtype == np.int8
        np.testing.assert_array_equal(got[m], want[m])
    if annotation == "feta":
        label4 = segm == 4
        assert int(label4.sum()) == 23943
        stem = "sub-sta21_rec-irtk_T2w_dseg_mlabel_{m}.nii.gz"
        for m in got:
            committed = nifti.load(Path(COMMITTED.format(n=1)) / stem.format(m=m)).data
            differ = got[m] != committed
            assert int(differ.sum()) == (23943 if m in (1, 4) else 0)
            assert not (differ & ~label4).any()


@pytest.mark.parametrize("k", [2, 6])
def test_split_labels_matches_jax_with_seeded_mixture(k, crop, accurate_sums, monkeypatch):
    """At ``subclasses > 1`` on the crop: the JAX script with the same
    ``random_state`` patched into ``sklearn.mixture.GaussianMixture``; each
    meta-label's labels within the label bar, the same labels in use."""
    image, segm = crop
    seed = 3
    monkeypatch.setattr(sklearn.mixture, "GaussianMixture",
                        functools.partial(sklearn.mixture.GaussianMixture, random_state=seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jgs.split_labels(image, segm, k, jgs.FETA2META)
    got = gs.split_labels(image, segm, k, gs.FETA2META, device="cpu", random_state=seed)
    meta = _meta(image, segm)
    for m in range(1, 5):
        assert got[m].dtype == np.int8
        assert np.mean(got[m][meta == m] != want[m][meta == m]) <= LABEL_SHARE
        np.testing.assert_array_equal(got[m][meta != m], want[m][meta != m])
        assert set(np.unique(got[m][meta == m])) <= set(range(10 * m, 10 * m + k))


def test_subsplit_label_with_fewer_voxels_than_clusters(crop):
    image, segm = crop
    mask = np.zeros(segm.shape, dtype=bool)
    mask.flat[[5, 900, 4000]] = True
    got = gs.subsplit_label(image, mask, 30, 6, device="cpu", random_state=0)
    np.testing.assert_array_equal(got, jgs.subsplit_label(image, mask, 30, 6))
    assert got.dtype == np.int16 and set(np.unique(got)) == {0, 30}


def _tree_files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*.nii.gz"))


def test_generate_seeds_main_writes_the_jax_tree(tmp_path, accurate_sums, monkeypatch):
    """``main`` on a ``build_bids_tree`` tree (two subjects, 32^3) against the
    JAX script's ``process_subject`` for each (subject, subclasses) task, both
    drawing from numpy's global ``RandomState`` seeded alike: the same files;
    ``subclasses_1`` identical; ``subclasses_2`` int8 with the same affines,
    each meta-label's labels within the bar."""
    bids = build_bids_tree(tmp_path / "bids", shape=(32, 32, 32))
    shutil.rmtree(bids / "derivatives")
    np.random.seed(5)
    gs.main(["--bids_path", str(bids), "--out_path", str(tmp_path / "port"), "--max_subclasses", "2",
             "--annotation", "feta", "--workers", "2", "--device", "cpu"])
    np.random.seed(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for sub in sorted(bids.glob("sub-*")):
            img, seg = (str(next(sub.glob(f"anat/*_{s}.nii.gz"))) for s in ("T2w", "dseg"))
            for n in (1, 2):
                jgs.process_subject((img, seg, n, jgs.FETA2META, str(tmp_path / "jax"), sub.name, "", "feta"))
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax") and len(files) == 16
    for rel in files:
        a, b = nifti.load(tmp_path / "port" / rel), jnifti.load(tmp_path / "jax" / rel)
        assert a.data.dtype == b.data.dtype == np.int8
        np.testing.assert_array_equal(a.affine, b.affine)
        if rel.parts[0] == "subclasses_1":
            _same_files(tmp_path / "port" / rel, tmp_path / "jax" / rel)
        else:
            m = int(rel.name[-8])
            region = b.data != 0
            np.testing.assert_array_equal(a.data != 0, region)
            assert np.mean(a.data[region] != b.data[region]) <= LABEL_SHARE
            assert set(np.unique(a.data[region])) <= {10 * m, 10 * m + 1}


# ---------------------------------------------------------------------------
# resample, resize_seeds
# ---------------------------------------------------------------------------


def _run_jax_main(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    main()


def test_resample_main_matches_jax(tmp_path, monkeypatch):
    """0.6 mm and a 40^3 target on a 32^3 tree at 0.5 mm (its T2w, dseg and
    seeds under ``derivatives`` alike): every written file equal."""
    bids = build_bids_tree(tmp_path / "bids", shape=(32, 32, 32))
    args = ["--bids_path", str(bids), "--res", "0.6", "--target_size", "40", "40", "40"]
    resample.main([*args, "--out_path", str(tmp_path / "port")])
    _run_jax_main(jresample.main, [*args, "--out_path", str(tmp_path / "jax")], monkeypatch)
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax") and len(files) == 4
    for rel in files:
        _same_files(tmp_path / "port" / rel, tmp_path / "jax" / rel)
        assert nifti.load(tmp_path / "port" / rel).data.shape == (40, 40, 40)


def test_resize_seeds_main_matches_jax(tmp_path, monkeypatch):
    bids = build_bids_tree(tmp_path / "bids", shape=(24, 24, 24))
    seeds = bids / "derivatives" / "seeds"
    # widen the seeds first, so the cast has work to do
    for p in seeds.rglob("*.nii.gz"):
        img = nifti.load(p)
        nifti.save(p, img.data.astype(np.int16), img.affine)
    shutil.copytree(seeds, tmp_path / "port")
    shutil.copytree(seeds, tmp_path / "jax")
    resize_seeds.main([str(tmp_path / "port")])
    _run_jax_main(jresize_seeds.main, [str(tmp_path / "jax")], monkeypatch)
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax") and len(files) == 16
    for rel in files:
        _same_files(tmp_path / "port" / rel, tmp_path / "jax" / rel)
        assert nifti.load(tmp_path / "port" / rel).data.dtype == np.int8


# ---------------------------------------------------------------------------
# the walkthrough and the console scripts
# ---------------------------------------------------------------------------


def test_walkthrough_on_cpu(tmp_path):
    from fetalsyngen_torch.examples import generator

    out = generator.main(["--device", "cpu", "--shape", "32", "--out", str(tmp_path)])
    for name in ("synth_train", "real_train"):
        img = out[name]["image"]
        assert img.shape == (1, 32, 32, 32) and np.isfinite(img).all()
        assert img.min() >= 0.0 and img.max() <= 1.0
    assert out["testing"]["image"].shape == out["reversed"]["image"].shape == (1, 32, 32, 32)
    for f in ("synth_image.nii.gz", "synth_label.nii.gz", "real_aug_image.nii.gz"):
        assert nifti.load(tmp_path / f).data.shape == (32, 32, 32)


def test_console_scripts_resolve_to_the_port():
    import importlib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    port = {
        "fsg-torch-test": "fetalsyngen_torch.test:main",
        "fsg-torch-test-dl": "fetalsyngen_torch.test_dl:main",
        "fsg-torch-generate-seeds": "fetalsyngen_torch.scripts.generate_seeds:main",
        "fsg-torch-resample": "fetalsyngen_torch.scripts.resample:main",
        "fsg-torch-resize-seeds": "fetalsyngen_torch.scripts.resize_seeds:main",
    }
    jax = {
        "fsg-test": "fetalsyngen_tpu.test:main",
        "fsg-test-dl": "fetalsyngen_tpu.test_dl:main",
        "fsg-generate-seeds": "fetalsyngen_tpu.scripts.generate_seeds:main",
        "fsg-resample": "fetalsyngen_tpu.scripts.resample:main",
        "fsg-resize-seeds": "fetalsyngen_tpu.scripts.resize_seeds:main",
    }
    assert scripts == {**jax, **port}
    for target in port.values():
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func))
