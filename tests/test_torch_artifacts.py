"""The SR-quality artifacts and their ops: the port against the JAX package.

The port's copies of the host-only modules (``transforms``, ``motion`` with
its ``motion_traj.npz``, ``psf``) must equal the originals exactly. The voxel
ops (``morphology``, ``noise``) and the three quality artifacts run the same
numpy inputs through both packages; the device draws of the port are the
JAX package's own draws, made with ``jax.random`` on its key path
(``fold_in`` tags, ``split``) and handed in, since torch cannot reproduce
threefry. Masks and picked centers must agree exactly, fields within 1e-5 and
images within 1e-4 of their scale (sums taken in another order).
"""

import os
import zlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fetalsyngen_tpu.generator.artifacts as jart
import fetalsyngen_torch.generator.artifacts as tart
from fetalsyngen_tpu.generator.artifacts import motion as jmotion
from fetalsyngen_tpu.generator.artifacts import psf as jpsf
from fetalsyngen_tpu.generator.artifacts import quality as jq
from fetalsyngen_tpu.generator.artifacts import transforms as jtf
from fetalsyngen_tpu.ops import morphology as jmorph
from fetalsyngen_tpu.ops import noise as jnoise
from fetalsyngen_torch.generator.artifacts import motion as tmotion
from fetalsyngen_torch.generator.artifacts import psf as tpsf
from fetalsyngen_torch.generator.artifacts import quality as tq
from fetalsyngen_torch.generator.artifacts import transforms as ttf
from fetalsyngen_torch.ops import morphology as tmorph
from fetalsyngen_torch.ops import noise as tnoise
from fetalsyngen_torch.testing import phantom_seeds_and_seg

# The suite runs six workers on the host's cores: torch's default of one
# intra-op thread per core oversubscribes them, and the port's CPU tests ran
# five times slower with it.
torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 8) // 4)))

SHAPE = (48, 48, 48)


def _t(x):
    return torch.from_numpy(np.array(x))


def _phantom(shape=SHAPE, seed=1):
    """(image in [0, 1] f32, labels 0..7) of the procedural phantom."""
    from scipy.ndimage import gaussian_filter

    _, seg = phantom_seeds_and_seg(shape, seed=seed)
    img = gaussian_filter((seg > 0) * 0.5 + (seg > 2) * 0.4, 1.5).astype(np.float32)
    return img, seg.astype(np.int32)


def _close(got, want, rel=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


# --- copies of the host-only modules ----------------------------------------


def test_motion_trajectories_file_is_a_byte_copy():
    src = Path(jart.__file__).parent / "motion_traj.npz"
    dst = Path(tart.__file__).parent / "motion_traj.npz"
    assert dst.read_bytes() == src.read_bytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_sample_motion_matches_jax(seed):
    ts = np.arange(23) * 1.7
    a = jmotion.sample_motion(ts, np.random.default_rng(seed)).matrix()
    b = tmotion.sample_motion(ts, np.random.default_rng(seed)).matrix()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("restricted, txy", [(False, 3.0), (True, 0.0)])
def test_transforms_match_jax(restricted, txy):
    ja, ta = (m.random_init_stack_transforms(15, 2.5, restricted, txy, np.random.default_rng(4))
              for m in (jtf, ttf))
    np.testing.assert_array_equal(ta.matrix(), ja.matrix())
    np.testing.assert_array_equal(ta.axisangle(), ja.axisangle())
    np.testing.assert_array_equal(ttf.reset_transform(ta).matrix(), jtf.reset_transform(ja).matrix())
    jm = jmotion.sample_motion(np.arange(15.0), np.random.default_rng(9))
    tm = ttf.RigidTransform(jm.matrix(False), trans_first=False)
    np.testing.assert_array_equal(tm.compose(ta).matrix(), jm.compose(ja).matrix())
    np.testing.assert_array_equal(ta.inv().matrix(), ja.inv().matrix())
    np.testing.assert_array_equal(ta[3].matrix(True), ja[3].matrix(True))
    ax = ja.axisangle()
    np.testing.assert_array_equal(ttf.axisangle2mat(ax), jtf.axisangle2mat(ax))
    np.testing.assert_array_equal(ttf.mat2axisangle(ja.matrix()), jtf.mat2axisangle(ja.matrix()))
    np.testing.assert_array_equal(ttf.random_angle(5, restricted, np.random.default_rng(2)),
                                  jtf.random_angle(5, restricted, np.random.default_rng(2)))
    for n, k in ((10, 2), (23, 4), (7, 7)):
        assert ttf.interleave_index(n, k) == jtf.interleave_index(n, k)


@pytest.mark.parametrize("ratio, kind", [((1, 1, 3), "gaussian"), ((1.5, 1.5, 2.0), "sinc")])
def test_psf_matches_jax(ratio, kind):
    assert (tpsf.GAUSSIAN_FWHM, tpsf.SINC_FWHM) == (jpsf.GAUSSIAN_FWHM, jpsf.SINC_FWHM)
    np.testing.assert_array_equal(tpsf.get_psf(res_ratio=ratio, psf_type=kind),
                                  jpsf.get_psf(res_ratio=ratio, psf_type=kind))
    assert tpsf.resolution2sigma(ratio) == jpsf.resolution2sigma(ratio)
    assert tpsf.resolution2sigma(2.0, isotropic=True) == jpsf.resolution2sigma(2.0, isotropic=True)


# --- morphology and noise -----------------------------------------------------


def _mask(shape=(40, 36, 44), seed=3):
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.int32)
    m[8:30, 10:26, 12:36] = 1
    m[rng.random(shape) < 0.02] = 1
    return m


@pytest.mark.parametrize("k", [3, 5, 7])
def test_morphology_matches_jax(k):
    m = _mask()
    np.testing.assert_array_equal(tmorph.box_sum(_t(m), k).numpy(), np.asarray(jmorph.box_sum(jnp.asarray(m), k)))
    np.testing.assert_array_equal(tmorph.erode(_t(m), k).numpy(), np.asarray(jmorph.erode(jnp.asarray(m), k)))
    np.testing.assert_array_equal(tmorph.dilate(_t(m), k).numpy(), np.asarray(jmorph.dilate(jnp.asarray(m), k)))


@pytest.mark.parametrize("radius", [1, 3, 6])
def test_ball_dilate_matches_jax(radius):
    m = _mask(seed=radius)
    got = tmorph.ball_dilate(_t(m), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmorph.ball_dilate(jnp.asarray(m), radius)))


def _jax_perlin_uniforms(key, res):
    """JAX's ``_perlin_noise_3d_impl`` draws: (theta, phi) uniforms over 2 pi."""
    k1, k2 = jax.random.split(key)
    return tuple(_t(jax.random.uniform(k, tuple(res))) for k in (k1, k2))


def _jax_fractal_uniforms(key, shape, res, octaves, lacunarity=2, max_octaves=4):
    lattices = tnoise.fractal_lattices(shape, res, octaves, lacunarity, max_octaves)
    return [_jax_perlin_uniforms(jax.random.fold_in(key, o), lat) for o, lat in enumerate(lattices)]


@pytest.mark.parametrize("shape, res", [((32, 32, 32), (2, 2, 2)), ((48, 32, 64), (3, 2, 4))])
def test_perlin_matches_jax(shape, res):
    key = jax.random.PRNGKey(zlib.crc32(str(shape).encode()))
    got = tnoise.perlin_noise_3d(shape, res, _jax_perlin_uniforms(key, res))
    _close(got, jnoise.perlin_noise_3d(key, shape, res), 1e-5)


@pytest.mark.parametrize("res, octaves", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_fractal_matches_jax(res, octaves):
    shape = SHAPE
    key = jax.random.PRNGKey(octaves)
    want = jnoise.fractal_noise_3d(
        key, shape, (res,) * 3, octaves=jnp.int32(octaves), persistence=0.5, lacunarity=2,
        increase=0.25, max_octaves=4,
    )
    got = tnoise.fractal_noise_3d(
        shape, (res,) * 3, _jax_fractal_uniforms(key, shape, (res,) * 3, octaves), 0.5, 2, 0.25
    )
    _close(got, want, 1e-5)


def test_mog_matches_jax():
    rng = np.random.default_rng(8)
    centers = rng.uniform(0, 40, (12, 3)).astype(np.float32)
    sigmas = rng.uniform(2, 9, (12, 1)).astype(np.float32)
    valid = rng.random(12) < 0.7
    got = tnoise.mog_3d((40, 36, 44), _t(centers), _t(sigmas), _t(valid))
    _close(got, jnoise.mog_3d((40, 36, 44), centers, sigmas, jnp.asarray(valid)), 1e-5)


@pytest.mark.parametrize("n_valid", [5, 20])
def test_masked_random_centers_match_jax(n_valid):
    m = _mask(seed=11)
    key = jax.random.PRNGKey(n_valid)
    jc, jv = jq.masked_random_centers(key, jnp.asarray(m), 20, n_valid)
    u = _t(jax.random.uniform(key, (m.size,)))
    tc, tv = tq.masked_random_centers(u, _t(m), 20, n_valid)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    pick = np.asarray(jv)
    assert {tuple(c) for c in tc.numpy()[pick]} == {tuple(c) for c in np.asarray(jc)[pick]}
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# --- the three quality artifacts, with JAX's draws handed in ----------------


def test_blur_cortex_matches_jax():
    img, seg = _phantom()
    key = jax.random.PRNGKey(21)
    art = dict(prob=1.0, cortex_label=2, nblur_min=50, nblur_max=200)
    want, jmeta = jq.BlurCortex(**art)(img, seg, rng=np.random.default_rng(3), key=key)
    u = _t(jax.random.uniform(key, (img.size,), minval=1e-7))
    got, tmeta = tq.BlurCortex(**art)(img, seg, rng=np.random.default_rng(3), seed=0, draws={"u": u})
    assert tmeta == jmeta
    _close(got, want)
    assert not np.allclose(np.asarray(want), img)


def _struct_noise(sc_module, merge_type):
    mp = sc_module.StructNoiseMergeParams(
        merge_type, gauss_nloc_min=5, gauss_nloc_max=15, gauss_sigma_mu=25, gauss_sigma_std=5,
        perlin_res_list=[1, 2], perlin_octaves_list=[1, 2, 4], perlin_persistence=0.5,
        perlin_lacunarity=2, perlin_increase_size=0.1,
    )
    return sc_module.StructNoise(prob=1.0, wm_label=3, std_min=0.2, std_max=0.4, merge_params=mp)


@pytest.mark.parametrize("merge_type, seed", [("perlin", 0), ("perlin", 4), ("gaussian", 1)])
def test_struct_noise_matches_jax(merge_type, seed):
    img, seg = _phantom()
    key = jax.random.PRNGKey(30 + seed)
    want, jmeta = _struct_noise(jq, merge_type)(img, seg, rng=np.random.default_rng(seed), key=key)
    nmax = 5
    nkey = jax.random.fold_in(key, 1)
    pyramid = [
        _t(jax.random.normal(jax.random.fold_in(nkey, k), cur)) if nmax - k <= jmeta["nstages"] else None
        for k, (cur, _) in enumerate(tq._pyramid_shapes(SHAPE, nmax))
    ]
    draws = {"pyramid": pyramid}
    if merge_type == "perlin":
        r = jmeta["res"]
        draws["perlin"] = _jax_fractal_uniforms(jax.random.fold_in(key, 2), SHAPE, (r, r, r), jmeta["octave"])
    else:
        draws["centers"] = _t(jax.random.uniform(jax.random.fold_in(key, 3), (img.size,)))
    got, tmeta = _struct_noise(tq, merge_type)(img, seg, rng=np.random.default_rng(seed), seed=0, draws=draws)
    assert tmeta == jmeta
    _close(got, want)
    assert not np.allclose(np.asarray(want), img)


@pytest.mark.parametrize("seed", [2, 7])
def test_simulated_boundaries_matches_jax(seed):
    """Halo and fuzzy boundaries on (prob 1 each): the mask exact, the image
    equal to the masked input."""
    img, seg = _phantom()
    key = jax.random.PRNGKey(seed)
    art = dict(prob_no_mask=0.0, prob_if_mask_halo=1.0, prob_if_mask_fuzzy=1.0)
    want, jmeta = jq.SimulatedBoundaries(**art)(img, seg, rng=np.random.default_rng(seed), key=key)
    # the JAX call's own fuzzy-round count: replay its host draws
    rng = np.random.default_rng(seed)
    rng.random(), rng.random(), rng.random()
    rng.integers(5, 15)
    n_fuzzy = int(rng.integers(2, 5))
    keeps = [_t(jax.random.uniform(jax.random.fold_in(key, 10 + r), SHAPE) < 0.1) for r in range(n_fuzzy)]
    centers = _t(jax.random.uniform(jax.random.fold_in(key, 20), (img.size,)))
    got, tmeta = tq.SimulatedBoundaries(**art)(
        img, seg, rng=np.random.default_rng(seed), seed=0, draws={"keep": keeps, "centers": centers}
    )
    assert tmeta == jmeta == {"no_mask_on": False, "halo_on": True, "fuzzy_on": True}
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > (img * (seg > 0) != 0).sum()  # the halo grew the mask


def test_artifacts_gate_off_and_pins():
    """With the gate off the volume passes through; a pin replaces its draw
    and leaves the later host draws as they were."""
    img, seg = _phantom()
    out, meta = tq.BlurCortex(0.0, 2, 50, 200)(_t(img), seg, rng=np.random.default_rng(0))
    assert meta == {"nblur": None} and torch.equal(out, _t(img))
    sn = _struct_noise(tq, "perlin")
    _, a = sn(img, seg, rng=np.random.default_rng(5), seed=1)
    _, b = sn(img, seg, genparams={"nstages": 2}, rng=np.random.default_rng(5), seed=1)
    assert b["nstages"] == 2 and b["noise_std"] == a["noise_std"] and b["res"] == a["res"]
