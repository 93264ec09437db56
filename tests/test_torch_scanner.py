"""The motion artifact's engine: the port against the JAX package on the CPU.

- the quarter-turn table and both host decompositions: exact;
- ``warp_rigid_pair_traced`` at cube 64 and 128 for several
  ``decompose_affine_paeth_host`` geometries, with and without the post
  operators, ``out_perm`` and ``out_shape``: within 1e-4 of the input scale;
- the scanner's stages on ``scanner_ab_case(cube=128, ns_grid=32)``: the
  port's per-stack acquisition and reconstruction against JAX's
  ``_acquire_stack``/``_recon_stack`` (``run_scanner_ab``), validity flags
  equal, slices, value and weight within 1e-4 of their scale; and
  ``_slice_artifacts`` with JAX's own draws handed in;
- a whole ``SimulateMotion`` call at 64^3 (tier 128, ns_grid 32) from the
  same ``rng_seed``, device noise off: the same metadata, the volume within
  1e-4 of its scale.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.spatial.transform import Rotation

import fetalsyngen_tpu.generator.artifacts.scanner as jsc
import fetalsyngen_tpu.ops.warp as jw
import fetalsyngen_torch.generator.artifacts.scanner as tsc
import fetalsyngen_torch.ops.warp as tw
from fetalsyngen_tpu import testing as jtesting
from fetalsyngen_tpu.generator.artifacts.quality import ReconMergeParams as JMerge
from fetalsyngen_torch import testing as ttesting
from fetalsyngen_torch.generator.artifacts.quality import ReconMergeParams as TMerge


# The suite runs six workers on the host's cores: torch's default of one
# intra-op thread per core oversubscribes them, and the port's CPU tests ran
# five times slower with it.
torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 8) // 4)))


def _close(got, want, rel=1e-4, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_quarter_table_matches_jax():
    assert tw._QUARTER_OPS == jw._QUARTER_OPS
    np.testing.assert_array_equal(tw._QUARTER_STACK, jw._QUARTER_STACK)
    vol = np.arange(5**3, dtype=np.float32).reshape(5, 5, 5)
    for idx in range(24):
        np.testing.assert_array_equal(tw.quarter_matrix(idx), jw.quarter_matrix(idx))
        got = tw.apply_quarter_turn(torch.from_numpy(vol), idx).numpy()
        np.testing.assert_array_equal(got, np.asarray(jw.apply_quarter_turn(jnp.asarray(vol), idx)))


def _geometry(seed, cube, scale=1.0):
    rng = np.random.default_rng(seed)
    A = scale * Rotation.random(random_state=seed).as_matrix()
    t = rng.uniform(-4, 4, 3) + (cube - 1) / 2.0 - A @ np.full(3, (cube - 1) / 2.0)
    return A, t


@pytest.mark.parametrize("seed", range(4))
def test_host_decompositions_match_jax(seed):
    A, t = _geometry(seed, 96, scale=1.0 + 0.1 * seed)
    for got, want in zip(tw.decompose_affine_paeth_host(A, t, 96), jw.decompose_affine_paeth_host(A, t, 96)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    R = Rotation.random(random_state=seed + 10).as_matrix()
    got = tw.decompose_rigid_host(R, t, (47.5,) * 3, (31.5,) * 3)
    want = jw.decompose_rigid_host(R, t, (47.5,) * 3, (31.5,) * 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _smooth_volume(cube, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    v = np.zeros((cube,) * 3, np.float32)
    c = cube // 4
    v[c:-c, c + 2:-c, c - 3:-c + 1] = 100.0
    return gaussian_filter(v + 10 * rng.random(v.shape), 1.5).astype(np.float32)


@pytest.mark.parametrize(
    "cube, seed, extras",
    [(64, 0, False), (64, 1, True), (64, 2, False), (128, 3, True)],
)
def test_warp_rigid_pair_matches_jax(cube, seed, extras):
    """Rotations of every octant, isotropic scales 0.9-1.3; with ``extras``
    the acquisition's form: blur/scale post operators, ``out_perm`` and (for
    the second operand's map) a smaller ``out_shape`` run separately."""
    A, t = _geometry(seed, cube, scale=0.9 + 0.1 * seed)
    q, ang, scl, dlt = jw.decompose_affine_paeth_host(A, t, cube)
    va, vb = _smooth_volume(cube, seed), (_smooth_volume(cube, seed + 7) > 50).astype(np.float32)
    kw_j, kw_t = {}, {}
    if extras:
        rng = np.random.default_rng(seed)
        post = [rng.random((cube, cube)).astype(np.float32) / cube for _ in range(3)]
        kw_j = dict(post_a=tuple(jnp.asarray(p) for p in post), post_b=(None, jnp.asarray(post[1]), None),
                    out_perm=(1, 2, 0))
        kw_t = dict(post_a=tuple(torch.from_numpy(p) for p in post),
                    post_b=(None, torch.from_numpy(post[1]), None), out_perm=(1, 2, 0))
    ja, jb = jw.warp_rigid_pair_traced(jnp.asarray(va), jnp.asarray(vb), q, jnp.asarray(ang),
                                       jnp.float32(scl), jnp.asarray(dlt), **kw_j)
    ta, tb = tw.warp_rigid_pair_traced(torch.from_numpy(va), torch.from_numpy(vb), q, torch.from_numpy(ang),
                                       torch.tensor(scl), torch.from_numpy(dlt), **kw_t)
    _close(ta, ja, scale=float(np.abs(va).max()))
    _close(tb, jb, scale=1.0)
    if extras:
        out_shape = (cube - 16, cube - 8, cube - 24)
        ja, _ = jw.warp_rigid_pair_traced(jnp.asarray(va), None, q, jnp.asarray(ang), jnp.float32(scl),
                                          jnp.asarray(dlt), out_shape=out_shape)
        ta, tnone = tw.warp_rigid_pair_traced(torch.from_numpy(va), None, q, torch.from_numpy(ang),
                                              torch.tensor(scl), torch.from_numpy(dlt), out_shape=out_shape)
        assert tnone is None
        _close(ta, ja, scale=float(np.abs(va).max()))


@pytest.fixture(scope="module")
def ab_runs():
    jcase, tcase = jtesting.scanner_ab_case(128, 32), ttesting.scanner_ab_case(128, 32)
    return jcase, tcase, jtesting.run_scanner_ab(jcase, 128, 32), ttesting.run_scanner_ab(tcase, 128, 32)


def test_scanner_ab_case_matches_jax(ab_runs):
    jcase, tcase, _, _ = ab_runs
    for k in ("vol", "mask", "mats_vox", "sig", "sig_rec", "z0", "ns"):
        np.testing.assert_array_equal(np.asarray(tcase[k]), np.asarray(jcase[k]))
    for k in ("G", "M", "Minv", "t_stack"):
        np.testing.assert_array_equal(tcase["geo"][k], jcase["geo"][k])
    for g, w in zip((*tcase["geo"]["fwd"], *tcase["inv"]), (*jcase["geo"]["fwd"], *jcase["inv"])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("stage", ["slices", "valid", "value", "weight"])
def test_scanner_stages_match_jax(ab_runs, stage):
    _, _, jout, tout = ab_runs
    i = ("slices", "valid", "value", "weight").index(stage)
    if stage == "valid":
        np.testing.assert_array_equal(tout[i], jout[i])
        assert 0 < tout[i].sum() < len(tout[i])
    else:
        _close(tout[i], jout[i])


def test_void_grid_is_jax_linspace():
    """The void grid: the port's ``arange(h) - (h-1)/2`` is the exact
    half-integer grid; ``jnp.linspace`` is within an ulp of it, a few
    entries an ulp off (a difference from JAX, ROADMAP §3)."""
    for h in (32, 128, 384, 640):
        want = np.asarray(jnp.linspace(-(h - 1) / 2, (h - 1) / 2, h))
        got = (torch.arange(h, dtype=torch.float32) - (h - 1) / 2).numpy()
        np.testing.assert_array_equal(got, np.arange(h) - (h - 1) / 2)
        np.testing.assert_array_less(np.abs(got - want), np.spacing(np.float32(h)) + 1e-12)


@pytest.mark.parametrize("gamma_on", [False, True])
def test_slice_artifacts_match_jax(gamma_on):
    """Gamma, Rician noise and voids, JAX's draws handed in (split(key, 4):
    the normals from the first key, the void gates from the third, the void
    shapes from the fourth)."""
    rng = np.random.default_rng(int(gamma_on))
    n, h = 12, 64
    slices = rng.random((n, h, h)).astype(np.float32)
    valid = (np.arange(n) < 9).astype(np.float32)
    key = jax.random.PRNGKey(5)
    args = (np.float32(1.3), gamma_on, np.float32(0.05), np.float32(0.6), np.float32(0.1))
    want = jsc._slice_artifacts(key, jnp.asarray(slices), jnp.asarray(valid), *(jnp.asarray(a) for a in args))
    k1, _, k3, k4 = jax.random.split(key, 4)
    draws = dict(
        noise=torch.from_numpy(np.array(jax.random.normal(k1, (2, n, h, h)))),
        void_on=torch.from_numpy(np.array(jax.random.uniform(k3, (n, 1, 1)))),
        void=torch.from_numpy(np.array(jax.random.uniform(k4, (6, n, 1, 1)))),
    )
    got = tsc._slice_artifacts(torch.from_numpy(slices), torch.from_numpy(valid),
                               *(float(a) if not isinstance(a, bool) else a for a in args), **draws)
    _close(got, want)
    assert (np.asarray(draws["void_on"]) < 0.6).any()


def _motion(sc, merge):
    return sc.SimulateMotion(
        prob=1.0, tiers=(128,), ns_grid=32,
        scanner_params=sc.ScannerParams(
            resolution_slice_fac_min=0.5, resolution_slice_fac_max=2, resolution_slice_max=1.5,
            slice_thickness_min=1.5, slice_thickness_max=3.5, gap_min=1.5, gap_max=5.5,
            min_num_stack=2, max_num_stack=3, max_num_slices=250, noise_sigma_min=0,
            noise_sigma_max=0.0, TR_min=1, TR_max=2, prob_void=0.0, prob_gamma=0.5, gamma_std=0.05,
        ),
        recon_params=sc.ReconParams(
            prob_misreg_slice=0.5, slices_misreg_ratio=0.1, prob_misreg_stack=0.5, txy=3.0,
            prob_smooth=0.5, prob_rm_slices=0.5, rm_slices_min=0.1, rm_slices_max=0.4, prob_merge=0.0,
            merge_params=merge("perlin", perlin_res_list=[1, 2], perlin_octaves_list=[1, 2, 4],
                               perlin_persistence=0.5, perlin_lacunarity=2, perlin_increase_size=0.25),
        ),
    )


def test_simulate_motion_matches_jax():
    """The same ``rng_seed`` draws the same geometry in both packages: the
    host stream is numpy in the same order. Device noise is off (sigma 0,
    no voids, no merge), so the volumes compare."""
    from scipy.ndimage import gaussian_filter

    _, seg = ttesting.phantom_seeds_and_seg((64, 64, 64), seed=1)
    out = gaussian_filter((seg > 0).astype(np.float32) * 100 + (seg > 2) * 80, 1.5).astype(np.float32)
    want, jmeta = _motion(jsc, JMerge)(out, seg.astype(np.int32), genparams={"rng_seed": 5, "rng_key": [0, 7]},
                                       resolution=(0.5, 0.5, 0.5))
    got, tmeta = _motion(tsc, TMerge)(out, seg.astype(np.int32), genparams={"rng_seed": 5, "device_seed": 7},
                                      resolution=(0.5, 0.5, 0.5))
    assert tmeta.pop("device_seed") == 7 and jmeta.pop("rng_key") == [0, 7]
    assert tmeta == jmeta and tmeta["nstacks"] >= 2
    _close(got, want)
    assert not np.allclose(got.numpy(), out)


@pytest.mark.parametrize("res_r", [0.7, 0.35])
def test_gt_to_recon_matches_jax(res_r):
    """The ground truth on a recon grid of another spacing (a standalone
    ``Scanner`` with ``resolution_recon != resolution``): the volume within
    1e-4, the labels exact, the same extent."""
    _, seg = ttesting.phantom_seeds_and_seg((40, 36, 44), seed=2)
    vol = _smooth_volume(48, 1)[:40, :36, :44].copy()
    jv, js, je = jsc._gt_to_recon(jnp.asarray(vol), jnp.asarray(seg, jnp.float32), 0.5, res_r)
    tv, ts, te = tsc._gt_to_recon(torch.from_numpy(vol), torch.from_numpy(seg.astype(np.float32)), 0.5, res_r)
    assert te == je
    _close(tv, jv)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
