"""The stream's SR-artifact chain: the port against the JAX package on the CPU.

Every function of ``fetalsyngen_torch.generator.artifacts.batched`` (and the
scanner's stream-only stages it runs) takes the same numpy inputs as its
JAX counterpart, with JAX's own draws handed in through ``Draws(given=...)``:
torch cannot replay threefry, so the tests derive each draw on JAX's key
path (``fold_in(key, 77)``, then 301 blur, 302 struct noise, 303 motion, 304
boundaries; inside motion ``100 + k`` per stack, ``200 + k`` for the removed
slices, 305 for the merge weight; ``10 + r`` for the fuzzy rounds). Masks,
flags and packs must agree exactly, images within 1e-4 of their scale; a
whole motion engine also within 1e-4, outside the voxels whose recon weight
sits at the 1e-2 threshold (a discontinuity: ROADMAP §3), whose share is
counted and bounded. The JAX side runs as its stream does with
``FSG_STREAM_BF16=0`` (no bf16 scope).
"""

import os

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from fetalsyngen_tpu.data.datasets import FetalSynthDataset as JaxDataset
from fetalsyngen_tpu.generator import model as jmodel
from fetalsyngen_tpu.generator.artifacts import batched as jba
from fetalsyngen_tpu.generator.artifacts import quality as jq
from fetalsyngen_tpu.generator.artifacts import scanner as jsc
from fetalsyngen_tpu.ops import rand as jrand
from fetalsyngen_tpu.ops import warp as jw
from fetalsyngen_tpu.parallel import input_pipeline as jpipe
from fetalsyngen_torch.convert import fields_from_numpy, params_from_numpy
from fetalsyngen_torch.data.datasets import FetalSynthDataset
from fetalsyngen_torch.generator import model as tmodel
from fetalsyngen_torch.generator.artifacts import batched as tba
from fetalsyngen_torch.generator.artifacts import quality as tq
from fetalsyngen_torch.generator.artifacts import scanner as tsc
from fetalsyngen_torch.ops import noise as tnoise
from fetalsyngen_torch.ops import rand as trand
from fetalsyngen_torch.ops import warp as tw
from fetalsyngen_torch.parallel import input_pipeline as tstream
from fetalsyngen_torch.testing import build_bids_tree, phantom_seeds_and_seg

# six workers share the host's cores (see tests/test_torch_artifacts.py)
torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 8) // 4)))

SHAPE = (32, 32, 32)
CUBE, NSG = 64, 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=1e-4, scale=None, where=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if scale is None else scale
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-30))


def _phantom(shape=SHAPE, seed=1):
    from scipy.ndimage import gaussian_filter

    _, seg = phantom_seeds_and_seg(shape, seed=seed)
    img = gaussian_filter((seg > 0) * 60.0 + (seg > 2) * 40.0, 1.5).astype(np.float32) + 5.0
    return img, seg.astype(np.int32)


def _u(key, shape, **kw):
    return _t(jax.random.uniform(key, shape, **kw))


def _fractal(key, shape, r, octave, max_octaves):
    """JAX's fractal-noise uniforms: per octave ``fold_in(key, o)``, split
    into (theta, phi)."""
    out = []
    for o, lat in enumerate(tnoise.fractal_lattices(shape, (r,) * 3, octave, 2, max_octaves)):
        k1, k2 = jax.random.split(jax.random.fold_in(key, o))
        out.append((_u(k1, lat), _u(k2, lat)))
    return out


# ---------------------------------------------------------------------------
# ops/rand
# ---------------------------------------------------------------------------


def _jax_uniforms(key, k, shape):
    return [jax.random.uniform(jax.random.fold_in(key, j), shape, minval=1e-12) for j in range(k)]


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_gamma_int_matches_jax(k):
    key = jax.random.PRNGKey(k)
    want = jrand.gamma_int(key, k, (50, 3))
    got = trand.gamma_int([_t(u) for u in _jax_uniforms(key, k, (50, 3))])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    np.testing.assert_allclose(trand.gamma_int([_t(u) for u in _jax_uniforms(key, k, (3,))]).numpy(),
                               np.asarray(jrand.gamma_fast(key, k, (3,))), rtol=2e-6)


def test_beta_and_poisson_match_jax():
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    want = jrand.beta_int(key, 2, 5, (160, 1))
    got = trand.beta_int([_t(u) for u in _jax_uniforms(k1, 2, (160, 1))],
                         [_t(u) for u in _jax_uniforms(k2, 5, (160, 1))])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for lam, kmax in ((100.0, 224), (8.0, 64)):
        keys = jax.random.split(jax.random.PRNGKey(int(lam)), 64)
        want = [int(jrand.poisson_icdf(k, lam, kmax=kmax)) for k in keys]
        got = [int(trand.poisson_icdf(_u(k, ()), lam, kmax)) for k in keys]
        assert got == want


@pytest.mark.parametrize("a", [0.5, 2.5, 3])
def test_gamma_fast_law(a):
    """The port's own gamma draws (Marsaglia-Tsang for a non-integer shape,
    the product form for an integer) against scipy's law."""
    g = trand.gamma_fast(torch.Generator().manual_seed(11), a, (20000,), "cpu").numpy()
    assert stats.kstest(g, stats.gamma(a).cdf).pvalue > 1e-3


def test_beta_and_poisson_laws():
    b = trand.draw_beta_int(torch.Generator().manual_seed(5), 2, 5, (20000,), "cpu").numpy()
    assert stats.kstest(b, stats.beta(2, 5).cdf).pvalue > 1e-3
    u = torch.rand(20000, generator=torch.Generator().manual_seed(6))
    k = trand.poisson_icdf(u, 8.0, 64).numpy()
    counts = np.bincount(k, minlength=30)[:30]
    want = stats.poisson(8.0).pmf(np.arange(30)) * len(k)
    assert stats.chisquare(counts[2:20], want[2:20] * counts[2:20].sum() / want[2:20].sum()).pvalue > 1e-3


# ---------------------------------------------------------------------------
# morphology with a host radius
# ---------------------------------------------------------------------------


def _mask(shape=(30, 34, 28), seed=3):
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.int32)
    m[8:20, 10:22, 9:18] = 1
    m[rng.random(shape) < 0.01] = 1
    return m


@pytest.mark.parametrize("max_radius", [3, 14])
def test_sq_edt_matches_jax(max_radius):
    m = _mask(seed=max_radius)
    want = np.asarray(jba.sq_edt(jnp.asarray(m), max_radius))
    got = tba.sq_edt(_t(m), max_radius)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    for r in (1, max_radius // 2, max_radius):
        want = np.asarray(jba.ball_dilate_traced(jnp.asarray(m), jnp.int32(r), max_radius))
        np.testing.assert_array_equal(tba.ball_dilate_traced(_t(m), r, max_radius).numpy(), want)
        np.testing.assert_array_equal(tba.ball_dilate_traced(_t(m), r, r).numpy(), want)


def test_dilate1_matches_jax():
    m = _mask(seed=9).astype(np.int8)
    np.testing.assert_array_equal(tba._dilate1(_t(m)).numpy(), np.asarray(jba._dilate1(jnp.asarray(m))))


# ---------------------------------------------------------------------------
# the three quality artifacts, JAX's draws handed in
# ---------------------------------------------------------------------------


def _bc(mod, prob):
    return mod.BlurCortex(prob=prob, cortex_label=2, nblur_min=50, nblur_max=200)


def _sn(mod, merge_type, prob):
    mp = mod.StructNoiseMergeParams(
        merge_type, gauss_nloc_min=5, gauss_nloc_max=15, gauss_sigma_mu=25, gauss_sigma_std=5,
        perlin_res_list=[1, 2], perlin_octaves_list=[1, 2, 4], perlin_persistence=0.5,
        perlin_lacunarity=2, perlin_increase_size=0.1,
    )
    return mod.StructNoise(prob=prob, wm_label=3, std_min=0.2, std_max=0.4, merge_params=mp)


def _sb(mod, no_mask=0.0, halo=1.0, fuzzy=1.0):
    return mod.SimulatedBoundaries(prob_no_mask=no_mask, prob_if_mask_halo=halo, prob_if_mask_fuzzy=fuzzy)


def _blur_draws(key, bc, n):
    kg, kn, ks, kc, kb = jax.random.split(key, 5)
    return {
        "blur.on": bool(jax.random.uniform(kg) < bc.prob),
        "blur.nblur": int(jax.random.randint(kn, (), bc.nblur_min, bc.nblur_max)),
        "blur.std_blurs": _t(jrand.gamma_fast(kb, bc.std_blur_shape, (3,))),
        "blur.sigmas": _t(jrand.gamma_fast(ks, bc.sigma_gamma_loc, (bc.MAX_BLUR, 3))),
        "blur.u": _u(kc, (n,), minval=1e-7),
    }


def _struct_draws(key, sn, shape):
    kg, kn, kstd, k1, k2, k3, ksig = jax.random.split(key, 7)
    nstages = int(jax.random.randint(kn, (), sn.nstages_min, sn.nstages_max))
    nmax = sn.nstages_max
    d = {
        "struct.on": bool(jax.random.uniform(kg) < sn.prob),
        "struct.nstages": nstages,
        "struct.noise_std": float(sn.std_min + (sn.std_max - sn.std_min) * jax.random.uniform(kstd)),
        "struct.pyramid": [
            _t(jax.random.normal(jax.random.fold_in(k1, k), cur)) if nmax - k <= nstages else None
            for k, (cur, _) in enumerate(tq._pyramid_shapes(shape, nmax))
        ],
    }
    mp = sn.merge_params
    if mp.merge_type == "perlin":
        ridx = int(jax.random.randint(k2, (), 0, len(mp.perlin_res_list)))
        oidx = int(jax.random.randint(k3, (), 0, len(mp.perlin_octaves_list)))
        d.update({"struct.res": ridx, "struct.octave": oidx,
                  "struct.perlin": _fractal(ksig, shape, mp.perlin_res_list[ridx], mp.perlin_octaves_list[oidx],
                                            max(mp.perlin_octaves_list))})
    else:
        d.update({"struct.nloc": int(jax.random.randint(k2, (), mp.gauss_nloc_min, mp.gauss_nloc_max)),
                  "struct.centers": _u(k3, shape), "struct.sigmas": _t(jax.random.normal(ksig, (sn.MAX_LOC, 1)))})
    return d


def _bound_draws(key, sb, shape):
    knm, kh, kf, khr, kn1, kn2, kn3, kc, kbeta = jax.random.split(key, 9)
    n_fuzzy = int(jax.random.randint(kn1, (), 2, jba.MAX_FUZZY_ROUNDS + 1))
    d = {
        "bound.no_mask": bool(jax.random.uniform(knm) < sb.prob_no_mask),
        "bound.halo": bool(jax.random.uniform(kh) < sb.prob_halo),
        "bound.fuzzy": bool(jax.random.uniform(kf) < sb.prob_fuzzy),
        "bound.radius": int(jax.random.randint(khr, (), 5, jba.MAX_HALO_RADIUS + 1)),
        "bound.n_fuzzy": n_fuzzy,
        "bound.n_centers": min(int(jrand.poisson_icdf(kn2, 100.0, kmax=224)), sb.MAX_CENTERS),
        "bound.base_sigma": max(int(jrand.poisson_icdf(kn3, 8.0, kmax=64)), 1),
        "bound.centers": _u(kc, shape),
        "bound.beta": _t(jrand.beta_int(kbeta, 2, 5, (sb.MAX_CENTERS, 1))),
    }
    for r in range(n_fuzzy):
        d[f"bound.keep.{r}"] = _t(jax.random.uniform(jax.random.fold_in(key, 10 + r), shape) < 0.1)
    return d


def _gate(g):
    return None if g is None else jnp.int32(g)


# (probability, pin): drawn on, drawn off, drawn on but pinned off, drawn
# off but pinned on
GATES = [(1.0, None), (0.0, None), (1.0, 0), (0.0, 1)]


@pytest.mark.parametrize("prob, gate", GATES)
def test_blur_cortex_t_matches_jax(prob, gate):
    img, seg = _phantom()
    key = jax.random.PRNGKey(21)
    want = np.asarray(jba.blur_cortex_t(key, jnp.asarray(img), jnp.asarray(seg), _bc(jq, prob), gate=_gate(gate)))
    d = tba.Draws(0, "cpu", given=_blur_draws(key, _bc(jq, prob), img.size))
    got = tba.blur_cortex_t(_t(img), _t(seg), _bc(tq, prob), d, gate)
    _close(got, want)
    on = prob > 0 if gate is None else gate > 0
    assert np.allclose(want, img) != on


@pytest.mark.parametrize("merge_type, prob, gate", [("perlin", *g) for g in GATES] + [("gaussian", 1.0, None)])
def test_struct_noise_t_matches_jax(merge_type, prob, gate):
    img, seg = _phantom()
    key = jax.random.PRNGKey(31)
    sn_j = _sn(jq, merge_type, prob)
    want = np.asarray(jba.struct_noise_t(key, jnp.asarray(img), jnp.asarray(seg), sn_j, gate=_gate(gate)))
    d = tba.Draws(0, "cpu", given=_struct_draws(key, sn_j, SHAPE))
    got = tba.struct_noise_t(_t(img), _t(seg), _sn(tq, merge_type, prob), d, gate)
    _close(got, want)
    on = prob > 0 if gate is None else gate > 0
    assert np.allclose(want, img) != on


@pytest.mark.parametrize("probs, gate, seed", [
    ((0.0, 1.0, 1.0), None, 2), ((0.0, 1.0, 1.0), None, 7), ((0.0, 0.0, 1.0), None, 4),
    ((1.0, 1.0, 1.0), None, 1), ((1.0, 1.0, 0.0), 1, 3), ((0.0, 1.0, 1.0), 0, 5),
])
def test_boundaries_t_matches_jax(probs, gate, seed):
    """The mask exact: halo and fuzzy drawn on, fuzzy alone, no mask drawn,
    no mask pinned away (the halo alone), the masking pinned off."""
    img, seg = _phantom()
    key = jax.random.PRNGKey(seed)
    sb_j = _sb(jq, *probs)
    want = np.asarray(jba.boundaries_t(key, jnp.asarray(img), jnp.asarray(seg), sb_j, gate=_gate(gate)))
    d = tba.Draws(0, "cpu", given=_bound_draws(key, sb_j, SHAPE))
    got = tba.boundaries_t(_t(img), _t(seg), _sb(tq, *probs), d, gate)
    np.testing.assert_array_equal(got.numpy(), want)
    masked = (probs[0] == 0.0) if gate is None else gate == 1
    assert np.array_equal(want, img) != masked


def test_pre_and_post_motion_use_jax_tags():
    """apply_pre_motion / apply_post_motion: the JAX chain's keys fold in 301,
    302 and 304 under the artifact key; all gates pinned on."""
    img, seg = _phantom(seed=2)
    ka = jax.random.fold_in(jax.random.PRNGKey(8), 77)
    qa_j = jba.QualityArtifacts(_bc(jq, 0.0), _sn(jq, "perlin", 0.0), _sb(jq, 1.0, 1.0, 1.0))
    qa_t = tba.QualityArtifacts(_bc(tq, 0.0), _sn(tq, "perlin", 0.0), _sb(tq, 1.0, 1.0, 1.0))
    gates = np.array([1, 1, 1], np.int32)
    mid = jba.apply_pre_motion(ka, jnp.asarray(img), jnp.asarray(seg), qa_j, gates=jnp.asarray(gates))
    want = np.asarray(jba.apply_post_motion(ka, mid, jnp.asarray(seg), qa_j, gates=jnp.asarray(gates)))
    given = {**_blur_draws(jax.random.fold_in(ka, 301), qa_j.blur_cortex, img.size),
             **_struct_draws(jax.random.fold_in(ka, 302), qa_j.struct_noise, SHAPE),
             **_bound_draws(jax.random.fold_in(ka, 304), qa_j.boundaries, SHAPE)}
    d = tba.Draws(0, "cpu", given=given)
    got = tba.apply_post_motion(tba.apply_pre_motion(_t(img), _t(seg), qa_t, d, gates), _t(seg), qa_t, d, gates)
    _close(got, want)


# ---------------------------------------------------------------------------
# the motion engine
# ---------------------------------------------------------------------------


def _motion(sc, merge, prob=1.0, tiers=(CUBE,), kb=2, noise=0.05, void=0.3, merge_type="perlin"):
    """``tests/test_batched_artifacts.py``'s tiny motion config (gap >= 2
    voxels), with slice noise, voids and the merge on."""
    return sc.SimulateMotion(
        prob=prob, tiers=tiers, ns_grid=NSG,
        scanner_params=sc.ScannerParams(
            1.0, 1.5, 2.0, 1.0, 1.5, 1.0, 1.5, 1, kb, 200, 0, noise, 1, 1, void, 0.5, 0.05, None, False, 0.0,
        ),
        recon_params=sc.ReconParams(
            0.5, 0.1, 0.5, 1.0, 0.5, 0.5, 0.1, 0.4, 1.0,
            merge(merge_type, perlin_res_list=[1, 2], perlin_octaves_list=[1, 2], perlin_persistence=0.5,
                  perlin_lacunarity=2, perlin_increase_size=0.25, gauss_ngaussians_min=2, gauss_ngaussians_max=4),
        ),
    )


def _motions(**kw):
    return _motion(jsc, jq.ReconMergeParams, **kw), _motion(tsc, tq.ReconMergeParams, **kw)


def _packs(seed, B, cube, small=None, genparams=None, shape=SHAPE, **kw):
    sm_j, sm_t = _motions(**kw)
    want = jba.pack_motion(np.random.default_rng(seed), B, shape, 0.5, sm_j, cube, NSG, small_cube=small,
                           genparams=genparams, with_record=True)
    got = tba.pack_motion(np.random.default_rng(seed), B, shape, 0.5, sm_t, cube, NSG, small_cube=small,
                          genparams=genparams, with_record=True)
    return want, got, sm_j, sm_t


# the small frame at 32^3 in a 32 buffer: rs 1.7, gap 3.6 voxels
SMALL_PINS = {"resolution_slice": 0.85, "gap": 1.8}


@pytest.mark.parametrize("cube, small, genparams, prob", [
    (CUBE, None, None, 0.6), ((64, 96), None, None, 1.0), (CUBE, 32, SMALL_PINS, 1.0),
    (CUBE, None, {"resolution_slice": 0.7, "slice_thickness": 1.2, "gap": 1.25}, 0.0),
    (CUBE, None, {"apply": False}, 1.0), (CUBE, None, {"apply": True}, 0.0),
])
def test_pack_motion_matches_jax(cube, small, genparams, prob):
    want, got, _, _ = _packs(4, 5, cube, small, genparams, prob=prob)
    assert set(got) == set(want)
    for k in want:
        if k == "_record":
            assert set(got[k]) == set(want[k])
            for r in want[k]:
                np.testing.assert_array_equal(got[k][r], want[k][r])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if small is not None:
        assert got["small"].all()
    if genparams == {"apply": False}:
        assert not got["motion_on"].any()


def test_resolution_slice_fac_pin_is_absolute_mm():
    """A deliberate difference (ROADMAP §3): the port's stream takes a pinned
    ``resolution_slice_fac`` as mm, as its host path does; the JAX stream
    multiplies it by the resolution. Pinned as ``resolution_slice`` the two
    packs agree."""
    _, got, _, sm_t = _packs(2, 3, CUBE, genparams={"resolution_slice_fac": 0.7})
    np.testing.assert_array_equal(got["_record"]["resolution_slice"], np.float32(0.7))
    want, _, _, _ = _packs(2, 3, CUBE, genparams={"resolution_slice_fac": 0.7})
    np.testing.assert_array_equal(want["_record"]["resolution_slice"], np.float32(0.35))
    same, _, _, _ = _packs(2, 3, CUBE, genparams={"resolution_slice": 0.7})
    for k in got:
        if k != "_record":
            np.testing.assert_array_equal(got[k], same[k], err_msg=k)
    # the host path's Scanner takes the same pin as mm
    data = {"resolution": 0.5}
    tsc.Scanner(sm_t.scanner_args).get_resolution(data, np.random.default_rng(0), {"resolution_slice_fac": 0.7})
    assert data["resolution_slice"] == 0.7


def _row_j(pack, b):
    return {k: jnp.asarray(v[b]) for k, v in pack.items() if not k.startswith("_")}


def _stack_args(row, k):
    return (int(row["q_idx"][k]), _t(row["angles"][k]), torch.tensor(row["wscale"][k]), _t(row["wdelta"][k]))


@pytest.mark.parametrize("small", [False, True])
def test_valid_coarse_matches_jax(small):
    _, seg = _phantom()
    pack, _, _, _ = _packs(6, 3, CUBE, 32 if small else None, SMALL_PINS if small else None)
    cube = 32 if small else CUBE
    mask_p = (np.pad(seg > 0, [((cube - s) // 2, cube - s - (cube - s) // 2) for s in SHAPE])).astype(np.float32)
    cm_j = jsc._coarse_mask(jnp.asarray(mask_p))
    cm_t = tsc._coarse_mask(_t(mask_p))
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))
    flags = []
    for b in range(3):
        for k in range(2):
            r = tba.row_of(pack, b)
            want = jsc._valid_coarse(cm_j, jnp.int32(r["q_idx"][k]), jnp.asarray(r["angles"][k]),
                                     jnp.float32(r["wscale"][k]), jnp.asarray(r["wdelta"][k]), jnp.asarray(r["G"][k]),
                                     jnp.float32(r["scal"][k][0]), jnp.int32(r["ns"]), cube, NSG, zoom_first=small)
            got = tsc._valid_coarse(cm_t, *_stack_args(r, k), _t(r["G"][k]), float(r["scal"][k][0]), int(r["ns"]),
                                    cube, NSG, zoom_first=small)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            flags.append(got.numpy())
    assert 0 < np.sum(flags) < np.size(flags)


def _smooth(cube, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    v = np.zeros((cube,) * 3, np.float32)
    c = cube // 4
    v[c:-c, c + 2:-c, c - 3:-c + 1] = 100.0
    return gaussian_filter(v + 10 * rng.random(v.shape), 1.5).astype(np.float32)


@pytest.mark.parametrize("out_size, seed", [(None, 0), (48, 1), (32, 2)])
def test_warp_rigid_zoom_first_matches_jax(out_size, seed):
    rng = np.random.default_rng(seed)
    from scipy.spatial.transform import Rotation

    cube = 64
    A = (1.0 + 0.3 * seed) * Rotation.random(random_state=seed).as_matrix()
    t = rng.uniform(-3, 3, 3) + (cube - 1) / 2.0 - A @ np.full(3, ((out_size or cube) - 1) / 2.0)
    q, ang, scl, dlt = jw.decompose_affine_paeth_host(A, t, cube)
    v = _smooth(cube, seed)
    S = out_size or cube
    post = tuple(rng.random((S, S)).astype(np.float32) / S for _ in range(3)) if seed else None
    perm = (1, 2, 0) if seed else None
    want = jw.warp_rigid_zoom_first(jnp.asarray(v), q, jnp.asarray(ang), jnp.float32(scl), jnp.asarray(dlt),
                                    out_size=out_size, post=None if post is None else tuple(map(jnp.asarray, post)),
                                    out_perm=perm)
    got = tw.warp_rigid_zoom_first(_t(v), q, _t(ang), torch.tensor(scl), _t(dlt), out_size=out_size,
                                   post=None if post is None else tuple(map(_t, post)), out_perm=perm)
    _close(got, want)


@pytest.mark.parametrize("split", [None, 0.0, 1.0])
@pytest.mark.parametrize("pair", [False, True])
def test_extract_pair_matches_jax(split, pair):
    """The extraction, single-operand or paired, exact or dz-split (flag 0:
    the exact tables in the split program)."""
    r = tba.row_of(_packs(7, 1, CUBE)[0], 0)
    G = r["G"][0]
    rs, gap, z0 = float(r["rs"]), float(r["gap_vox"]), float(r["z0"])
    c_ss = (CUBE - 1) / 2.0
    Wv = _smooth(CUBE, 3)
    Wm = (_smooth(CUBE, 4) > 50).astype(np.float32)
    dz_j, dv_j, du_j = jsc._slice_coef_tables(jnp.asarray(G), jnp.float32(rs), c_ss, jnp.float32(z0),
                                              jnp.float32(gap), NSG)
    kw = {} if split is None else {"split_dz": jnp.float32(split)}
    jx, jm = jsc._extract_pair(jnp.asarray(Wv), jnp.asarray(Wm) if pair else None, jnp.float32(gap),
                               jnp.float32(z0), dz_j, dv_j, du_j, CUBE, NSG, **kw)
    dz, dv, du = tsc._slice_coef_tables(_t(G), rs, c_ss, z0, gap, NSG)
    tx, tm = tsc._extract_pair(_t(Wv), _t(Wm) if pair else None, gap, z0, dz, rs, c_ss, dv, du, CUBE, NSG,
                               False if split is None else split)
    _close(tx, jx)
    if pair:
        _close(tm, jm)
    else:
        assert tm is None and jm is None


def test_slice_artifacts_fast_matches_jax():
    rng = np.random.default_rng(2)
    n, h = 12, 32
    slices = rng.random((n, h, h)).astype(np.float32)
    valid = (np.arange(n) < 9).astype(np.float32)
    key = jax.random.PRNGKey(5)
    args = (np.float32(1.3), True, np.float32(0.05), np.float32(0.6), np.float32(0.1))
    want = jsc._slice_artifacts(key, jnp.asarray(slices), jnp.asarray(valid), *(jnp.asarray(a) for a in args),
                                fast=True)
    k1, _, k3, k4 = jax.random.split(key, 4)
    draws = dict(noise=_t(jax.random.normal(k1, (n, h, h))), void_on=_u(k3, (n, 1, 1)), void=_u(k4, (6, n, 1, 1)))
    got = tsc._slice_artifacts(_t(slices), _t(valid), *(float(a) if not isinstance(a, bool) else a for a in args),
                               **draws, fast=True)
    _close(got, want)


@pytest.mark.parametrize("cube, split, coarse", [(CUBE, 1.0, False), (CUBE, 0.0, False), (128, None, True),
                                                 (128, 1.0, True)])
def test_recon_one_matches_jax(cube, split, coarse):
    """The reconstruction with the dz-split and with the coarse weight chain
    (cube 128: pooled by 1, the recon frame by 2)."""
    pack, _, _, _ = _packs(8, 1, cube)
    r = tba.row_of(pack, 0)
    rng = np.random.default_rng(1)
    slices = (rng.random((NSG, cube, cube)) * 50).astype(np.float32)
    keep = (np.arange(NSG) < int(r["ns"])).astype(np.float32) * (rng.random(NSG) > 0.2)
    k = 0
    rs, gap, z0 = float(r["rs"]), float(r["gap_vox"]), float(r["z0"])
    inv = (int(r["qinv"][k]), r["iang"][k], r["iscl"][k], r["idlt"][k])
    cinv = (int(r["cqinv"][k]), r["ciang"][k], r["ciscl"][k], r["cidlt"][k])
    kw = {} if split is None else {"split_dz": jnp.float32(split)}
    jv, jw_ = jsc._recon_one(
        jnp.asarray(slices), jnp.asarray(keep), jnp.asarray(r["Grec"][k]), jnp.float32(rs), jnp.float32(gap),
        jnp.float32(z0), jnp.asarray(r["sig_rec"]), jnp.int32(inv[0]), jnp.asarray(inv[1]), jnp.float32(inv[2]),
        jnp.asarray(inv[3]), cube, NSG, SHAPE, **kw,
        coarse_inv=(jnp.int32(cinv[0]), jnp.asarray(cinv[1]), jnp.float32(cinv[2]), jnp.asarray(cinv[3]))
        if coarse else None,
    )
    tv, tw_ = tsc._recon_one(
        _t(slices), _t(keep), _t(r["Grec"][k]), rs, gap, z0, _t(r["sig_rec"]),
        (inv[0], _t(inv[1]), torch.tensor(inv[2]), _t(inv[3])), cube, NSG, SHAPE,
        split_dz=False if split is None else split,
        coarse_inv=(cinv[0], _t(cinv[1]), torch.tensor(cinv[2]), _t(cinv[3])) if coarse else None,
    )
    _close(tv, jv)
    _close(tw_, jw_)


def _slice_given(key, k, ns_grid, S):
    k1, _, k3, k4 = jax.random.split(jax.random.fold_in(key, 100 + k), 4)
    return {"noise": _t(jax.random.normal(k1, (ns_grid, S, S))), "void_on": _u(k3, (ns_grid, 1, 1)),
            "void": _u(k4, (6, ns_grid, 1, 1))}


def test_acquire_one_small_matches_jax():
    pack, _, sm_j, _ = _packs(3, 1, CUBE, 32, SMALL_PINS)
    r = tba.row_of(pack, 0)
    assert r["small"]
    S, k = 32, 1
    img, seg = _phantom()
    vol_p = _smooth(S, 5)
    cm = (np.pad(seg > 0, 0)).astype(np.float32)
    sp = sm_j.scanner_args
    key = jax.random.PRNGKey(4)
    skey = jax.random.fold_in(key, 100 + k)
    th, gm, gon, sg = (float(x) for x in r["scal"][k])
    js, jv = jba._acquire_one_small(
        jnp.asarray(vol_p), jnp.int32(r["q_idx"][k]), jnp.asarray(r["angles"][k]), jnp.float32(r["wscale"][k]),
        jnp.asarray(r["wdelta"][k]), jnp.asarray(r["G"][k]), jnp.float32(r["gap_vox"]), jnp.float32(r["z0"]),
        jnp.asarray(r["sig"]), jnp.float32(th), jnp.int32(r["ns"]), skey, jnp.float32(gm), jnp.asarray(gon > 0.5),
        jnp.float32(sg), sp.prob_void, sp.slice_noise_threshold, S, NSG, jsc._coarse_mask(jnp.asarray(cm)),
        split_dz=jnp.float32(r["dz_ok"][k]),
    )
    ts, tv = tba._acquire_one_small(
        _t(vol_p), _stack_args(r, k), _t(r["G"][k]), float(r["gap_vox"]), float(r["z0"]), _t(r["sig"]), th,
        int(r["ns"]), gm, gon > 0.5, sg, float(np.float32(sp.prob_void)), float(np.float32(sp.slice_noise_threshold)),
        S, NSG, tsc._coarse_mask(_t(cm)), _slice_given(key, k, NSG, S), float(r["dz_ok"][k]),
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(ts, js)


def _motion_given(key, row, cube, small, mp, shape):
    """JAX's motion draws for one sample: every attempt stack's slice draws
    and removal uniforms, and the merge weight's."""
    S = small if bool(row["small"]) and small else cube
    d = {}
    for k in range(len(row["q_idx"])):
        d[f"motion.slices.{k}"] = _slice_given(key, k, NSG, S)
        d[f"motion.rm.{k}"] = _u(jax.random.fold_in(key, 200 + k), (NSG,))
    kmw = jax.random.fold_in(key, 305)
    if mp.merge_type == "perlin":
        d["motion.merge"] = _fractal(kmw, shape, mp.perlin_res_list[int(row["mres_idx"])], int(row["octave"]),
                                     max(mp.perlin_octaves_list))
    else:
        d["motion.merge"] = _u(kmw, shape)
    return d


def _threshold_band(trace, smooth):
    """The voxels whose recon weight sits at the 1e-2 threshold (where a
    rounding may flip it), grown by one voxel when the box smooth ran."""
    w = trace["weight"].numpy()
    band = np.abs(w - 1e-2) < 1e-4
    if smooth:
        from scipy.ndimage import binary_dilation

        band = binary_dilation(band, np.ones((3, 3, 3), bool))
    return band


@pytest.mark.parametrize("variant", ["big", "split", "small", "coarse", "gaussian"])
def test_motion_t_matches_jax(variant):
    """One whole engine run per variant: the exact big-frame engine, the
    dz-split, the small px frame (zoom-first warp, cube 32), the coarse weight
    chain (cube 128) and the Gaussian merge weight."""
    cube = 128 if variant == "coarse" else CUBE
    small = 32 if variant == "small" else None
    pins = SMALL_PINS if variant == "small" else {"gap": 1.5} if variant == "split" else {"apply": True}
    merge_type = "gaussian" if variant == "gaussian" else "perlin"
    pack, _, sm_j, sm_t = _packs(5 if variant == "split" else 12, 1, cube, small, pins, merge_type=merge_type)
    row = tba.row_of(pack, 0)
    img, seg = _phantom()
    key = jax.random.PRNGKey(9)
    kw = dict(small_cube=small, split_dz=variant in ("split", "small"), coarse_w=variant == "coarse")
    want = np.asarray(jba.motion_t(key, jnp.asarray(img), jnp.asarray(seg), _row_j(pack, 0), sm_j, SHAPE, cube,
                                   NSG, **kw))
    d = tba.Draws(0, "cpu", given=_motion_given(key, row, cube, small, sm_j.recon_args.merge_params, SHAPE))
    trace = {}
    got = tba.motion_t(_t(img), _t(seg), row, sm_t, SHAPE, cube, NSG, d, trace=trace, **kw).numpy()
    assert trace["accepted"], "no stack accepted"
    if variant == "split":
        assert any(row["dz_ok"][k] for k in trace["accepted"])
    band = _threshold_band(trace, bool(row["smooth_on"]))
    assert band.mean() < 0.01, band.mean()
    _close(got, want, where=~band)
    assert not np.allclose(want, img)


def test_motion_off_and_acceptance():
    """A motion-off row passes the volume through; the acceptance keeps
    stacks in order up to ``num_stacks``, drops empty ones and stops at the
    overflowing one."""
    _, _, _, sm_t = _packs(1, 1, CUBE)
    pack = tba.pack_motion(np.random.default_rng(0), 1, SHAPE, 0.5, sm_t, CUBE, NSG, genparams={"apply": False})
    img, seg = _phantom()
    out = tba.motion_t(_t(img), _t(seg), tba.row_of(pack, 0), sm_t, SHAPE, CUBE, NSG, tba.Draws(0, "cpu"))
    assert torch.equal(out, _t(img))
    assert tba.accept_stacks([0, 5, 3, 4], 2, 200) == [1, 2]
    assert tba.accept_stacks([5, 0, 196, 3], 6, 200) == [0]
    assert tba.accept_stacks([5, 194, 3], 6, 200) == [0, 1]
    assert tba.accept_stacks([0, 0], 2, 200) == []


# ---------------------------------------------------------------------------
# the whole stream batch against the JAX stream
# ---------------------------------------------------------------------------

LABELS = [0] + list(range(10, 50))
GEN_CLASSES = [0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))
FORCED = {"blur_cortex": {"apply": True}, "struct_noise": {"apply": True}, "boundaries": {"apply": True},
          "simulate_motion": {"apply": True}}


def _generator(mod, qmod, smod, merge, **kw):
    arts = dict(
        blur_cortex=_bc(qmod, 0.4), struct_noise=_sn(qmod, "perlin", 0.4), boundaries=_sb(qmod, 0.5, 0.5, 0.5),
        simulate_motion=_motion(smod, merge, prob=0.4),
    )
    return mod.FetalSynthGen(
        shape=SHAPE, resolution=(0.5, 0.5, 0.5),
        intensity_generator=mod.ImageFromSeeds(1, 2, LABELS, GEN_CLASSES),
        spatial_deform=mod.SpatialDeformation(20, 0.02, 0.1, SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=mod.RandResample(0.9, 0.5, 1.5), bias_field=mod.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=mod.RandNoise(0.9, 5, 15), gamma=mod.RandGamma(0.9, 0.1), seed=0, **arts, **kw,
    )


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_bids_tree(tmp_path_factory.mktemp("bids_art"), shape=SHAPE)


@pytest.fixture(scope="module")
def ds(root):
    gen = _generator(tmodel, tq, tsc, tq.ReconMergeParams, device="cpu")
    return FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))


@pytest.fixture(scope="module")
def jds(root):
    gen = _generator(jmodel, jq, jsc, jq.ReconMergeParams)
    return JaxDataset(str(root), gen, str(root / "derivatives" / "seeds"))


def _jax_chain_given(sub, B, pack, stream):
    """JAX's artifact draws of each batch element (``split(sub, B)``, then
    ``fold_in(key, 77)`` and each artifact's tag)."""
    qa = stream._qa
    given = []
    for b, key in enumerate(jax.random.split(jnp.asarray(sub), B)):
        ka = jax.random.fold_in(key, 77)
        row = {k: v[b] for k, v in pack.items()}
        g = {**_blur_draws(jax.random.fold_in(ka, 301), qa.blur_cortex, int(np.prod(SHAPE))),
             **_struct_draws(jax.random.fold_in(ka, 302), qa.struct_noise, SHAPE),
             **_bound_draws(jax.random.fold_in(ka, 304), qa.boundaries, SHAPE)}
        if row["motion_on"]:
            g.update(_motion_given(jax.random.fold_in(ka, 303), row, stream.cube, stream.small_cube,
                                   stream._sm.recon_args.merge_params, SHAPE))
        given.append(g)
    return given


def test_stream_batch_matches_jax(ds, jds, monkeypatch):
    """All four artifacts forced on: the same pack and names as the JAX
    stream from the same seed, and the port's batch program with JAX's core
    and artifact draws gives JAX's images (1e-4 outside the recon-threshold
    band) and labels."""
    from test_torch_stream import _jax_draws

    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    B = 2
    jstream = jpipe.SyntheticStream(jds, batch_size=B, seed=0, prefetch=False, genparams={"artifact_params": FORCED})
    jbatch = next(iter(jstream))
    meta = jbatch["meta"]
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=0, prefetch=False, genparams={"artifacts": FORCED})
    batch = next(iter(stream))
    assert batch["name"] == jbatch["name"]
    assert set(batch["meta"]["pack"]) == set(meta["pack"])
    for k, v in meta["pack"].items():
        np.testing.assert_array_equal(batch["meta"]["pack"][k], v, err_msg=k)
    for k, v in meta["scanner"].items():
        np.testing.assert_array_equal(batch["meta"]["scanner"][k], v, err_msg=k)
    assert meta["pack"]["motion_on"].all()

    params, fields, u = _jax_draws(meta["sub"], jstream.cfg, B)
    draws = [tba.Draws(0, "cpu", given=g) for g in _jax_chain_given(meta["sub"], B, meta["pack"], jstream)]
    traces = []
    banks = stream._banks_for(meta["resident"])
    chain = stream.make_chain({"pack": meta["pack"]}, draws=draws, traces=traces)
    image, label = tstream.batch_program(*banks, torch.tensor(meta["subj"]), torch.tensor(u),
                                         params_from_numpy(params), fields_from_numpy(**fields), stream.cfg,
                                         stream._lo, chain)
    want = np.asarray(jbatch["image"])
    np.testing.assert_array_equal(label.numpy(), np.asarray(jbatch["label"]))
    for b in range(B):
        band = _threshold_band(traces[b], bool(meta["pack"]["smooth_on"][b])) if traces[b].get("weight") is not None \
            else np.zeros(SHAPE, bool)
        assert band.mean() < 0.01
        _close(image[b], want[b], where=~band)
    assert not np.allclose(image.numpy(), batch["image"].numpy())  # the port's own draws differ


@pytest.mark.parametrize("kw, env", [({}, {}), ({"cube": (64, 96)}, {"FSG_SMALL_TIER": "0"}),
                                     ({"small_tier": False, "dz_split": False}, {"FSG_COARSE_W": "0"})])
def test_stream_geometry_matches_jax(root, kw, env, monkeypatch):
    """``cube``, ``ns_grid``, ``small_cube`` and the mode flags equal the JAX
    stream's for the same dataset, with the default tiers (384/512/640) and
    the environment overrides."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    gens = []
    for mod, qmod, smod in ((tmodel, tq, tsc), (jmodel, jq, jsc)):
        g = _generator(mod, qmod, smod, qmod.ReconMergeParams, **({"device": "cpu"} if mod is tmodel else {}))
        sm = g.artifacts["simulate_motion"]
        sm.tiers, sm.ns_grid = (128, 256, 384), 128
        gens.append(g)
    t = tstream.SyntheticStream(FetalSynthDataset(str(root), gens[0], str(root / "derivatives" / "seeds")), **kw)
    j = jpipe.SyntheticStream(JaxDataset(str(root), gens[1], str(root / "derivatives" / "seeds")), **kw)
    for a in ("cube", "cubes", "ns_grid", "small_cube", "dz_split", "coarse_w"):
        assert getattr(t, a) == getattr(j, a), a


def _equal(a, b):
    return torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"]) and a["name"] == b["name"]


def _batches(stream, n):
    it = iter(stream)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_stream_replay_and_prefetch(ds):
    """The stream with artifacts at the config's probabilities: a batch
    replays bit for bit on the same stream and a fresh one; prefetch on and
    off give the same batches; the chain reads validity once a batch."""
    on = _batches(tstream.SyntheticStream(ds, batch_size=2, seed=3, prefetch=True), 2)
    before = tba.COUNTS["transfers"]
    off = _batches(tstream.SyntheticStream(ds, batch_size=2, seed=3, prefetch=False), 2)
    assert tba.COUNTS["transfers"] - before == sum(bool(b["meta"]["pack"]["motion_on"].any()) for b in off)
    assert all(_equal(a, b) for a, b in zip(on, off))
    meta = off[1]["meta"]
    assert set(meta) == {"seeds", "u", "resident", "subj", "batch_size", "pack", "scanner"}
    fresh = tstream.SyntheticStream(ds, batch_size=2, seed=99, prefetch=False)
    assert _equal(fresh.replay_batch(meta), off[1])
    assert all(np.isfinite(b["image"].numpy()).all() and float(b["image"].max()) <= 1.0 for b in off)
