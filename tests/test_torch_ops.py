"""The port's ops against the JAX package's, on the same numpy inputs.

Each port function takes a batch of 2; each sample is compared with one call
of the JAX function. Float results agree to ``rtol=1e-5`` (summation order
and FMA contraction differ between XLA:CPU and PyTorch); integer results and
nearest-mode labels agree exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalsyngen_tpu.ops import affine as jaffine
from fetalsyngen_tpu.ops import interp as jinterp
from fetalsyngen_tpu.ops import linops as jlinops
from fetalsyngen_tpu.ops import numerics as jnumerics
from fetalsyngen_tpu.ops import warp as jwarp
from fetalsyngen_torch.ops import affine, interp, linops, numerics, warp

RTOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _affines(rng, B=2):
    rot = rng.uniform(-20, 20, (B, 3)).astype(np.float32) / 180.0 * np.float32(np.pi)
    sh = rng.uniform(-0.02, 0.02, (B, 3)).astype(np.float32)
    sc = (1 + rng.uniform(-0.1, 0.1, (B, 3))).astype(np.float32)
    return rot, sh, sc


def test_floor_div_exact():
    rng = np.random.default_rng(0)
    b = rng.uniform(0.5, 1.5, 4000).astype(np.float32)
    a = np.float32(128.0) * np.ones_like(b)
    # f64-law boundary cases (ops/numerics.py:6-11): 22/1.1f and 24/1.2f
    a = np.concatenate([a, np.float32([22.0, 24.0, 128.0, 12.0])])
    b = np.concatenate([b, np.float32([1.1, 1.2, 0.5, 0.6])])
    port = numerics.floor_div_exact(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jnumerics.floor_div_exact(a, b)))
    np.testing.assert_array_equal(port, np.floor(a.astype(np.float64) / b).astype(np.int32))
    assert port[-4] == 19  # f32 division alone rounds 22/1.1f up to 20


def test_make_affine_matrix_and_ul():
    rot, sh, sc = _affines(np.random.default_rng(1))
    A = affine.make_affine_matrix(_t(rot), _t(sh), _t(sc))
    U, L = warp.ul_decompose(A)
    for b in range(2):
        jA = np.asarray(jaffine.make_affine_matrix(rot[b], sh[b], sc[b]))
        np.testing.assert_allclose(A[b].numpy(), jA, **RTOL)
        jU, jL = jwarp.ul_decompose(jA)
        np.testing.assert_allclose(U[b].numpy(), np.asarray(jU), **RTOL)
        np.testing.assert_allclose(L[b].numpy(), np.asarray(jL), **RTOL)
    np.testing.assert_allclose((U @ L).numpy(), A.numpy(), **RTOL)


def test_centered_grid():
    for port, ref in zip(affine.centered_grid((3, 4, 5), "cpu"), jaffine.centered_grid((3, 4, 5))):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "in_valid, out_valid, oob_zero", [(None, None, False), ((7, 12), None, False), (None, (5, 9), True)]
)
def test_interp_matrix(in_valid, out_valid, oob_zero):
    factor = np.float32([0.7, 1.6])
    coords = interp.zoom_coords(14, _t(factor))
    port = linops.interp_matrix(
        coords, 12,
        in_valid=None if in_valid is None else _t(np.int32(in_valid)),
        out_valid=None if out_valid is None else _t(np.int32(out_valid)),
        oob_zero=oob_zero,
    )
    for b in range(2):
        jc = jinterp.zoom_coords(14, jnp.float32(factor[b]))
        np.testing.assert_array_equal(coords[b].numpy(), np.asarray(jc))
        ref = jlinops.interp_matrix(
            jc, 12,
            in_valid=None if in_valid is None else jnp.int32(in_valid[b]),
            out_valid=None if out_valid is None else jnp.int32(out_valid[b]),
            oob_zero=oob_zero,
        )
        np.testing.assert_allclose(port[b].numpy(), np.asarray(ref), **RTOL)


def test_toeplitz_blur_matrix():
    sigma = np.float32([0.0, 1.3])
    port = linops.toeplitz_blur_matrix(_t(sigma), 16, 4)
    for b in range(2):
        ref = jlinops.toeplitz_blur_matrix(jnp.float32(sigma[b]), 16, 4)
        np.testing.assert_allclose(port[b].numpy(), np.asarray(ref), **RTOL)
    np.testing.assert_array_equal(port[0].numpy(), np.eye(16, dtype=np.float32))


def test_gaussian_blur_mm():
    rng = np.random.default_rng(3)
    vol = rng.random((2, 10, 12, 14), np.float32)
    stds = np.float32([[0.0, 0.8, 1.7], [1.1, 0.0, 0.4]])
    port = linops.gaussian_blur_mm(_t(vol), _t(stds), 5)
    for b in range(2):
        ref = jlinops.gaussian_blur_mm(jnp.asarray(vol[b]), jnp.asarray(stds[b]), 5)
        np.testing.assert_allclose(port[b].numpy(), np.asarray(ref), **RTOL)


def test_zoom_mm():
    rng = np.random.default_rng(4)
    small = rng.standard_normal((2, 6, 6, 6)).astype(np.float32)
    in_shape = np.int32([[3, 4, 6], [5, 2, 4]])
    out_shape = (16, 12, 20)
    factor = np.float32(out_shape) / in_shape.astype(np.float32)
    port = linops.zoom_mm(_t(small), out_shape, _t(factor), in_shape=_t(in_shape))
    for b in range(2):
        ref = jlinops.zoom_mm(
            jnp.asarray(small[b]), out_shape, jnp.asarray(factor[b]), in_shape=jnp.asarray(in_shape[b])
        )
        np.testing.assert_allclose(port[b].numpy(), np.asarray(ref), **RTOL)


@pytest.mark.parametrize("out_order", ["ijk", "ikj", "kji", "jik", "kij"])
def test_row_affine_matmul_pair(out_order):
    rng = np.random.default_rng(5)
    I, J, S = 6, 10, 12
    xa = rng.random((2, I, J, S), np.float32)
    xb = rng.integers(0, 8, (2, I, J, S)).astype(np.float32)
    slope = np.float32([0.93, 1.08])
    amount = np.float32([0.31, -0.47])
    bias = np.float32([0.6, -1.2])
    oa, ob = warp._row_affine_matmul_pair(
        _t(xa), _t(xb), _t(slope), _t(amount), _t(bias), out_order=out_order
    )
    for b in range(2):
        ja, jb = jwarp._row_affine_matmul_pair(
            jnp.asarray(xa[b]), jnp.asarray(xb[b]), jnp.float32(slope[b]), jnp.float32(amount[b]),
            jnp.float32(bias[b]), (False, True), out_order=out_order,
        )
        np.testing.assert_allclose(oa[b].numpy(), np.asarray(ja), **RTOL)
        np.testing.assert_array_equal(ob[b].numpy(), np.asarray(jb))


@pytest.mark.parametrize("J, S", [(5, 11), (9, 16)])
def test_shear_matrices(J, S):
    """Both operator stacks, including rows that clamp at either edge."""
    slope, amount, bias = np.float32([1.0, 0.93]), np.float32([0.25, -0.6]), np.float32([0.0, 2.5])
    c_fix = (J - 1) / 2.0
    lin, near = warp._shear_matrices(J, S, _t(amount), _t(bias), c_fix, _t(slope))
    assert lin.shape == near.shape == (2, J, S, S)
    for b in range(2):
        ref = jwarp._shear_matrices(
            J, S, S, jnp.float32(amount[b]), jnp.float32(bias[b]), c_fix, (False, True),
            slope=jnp.float32(slope[b]),
        )
        np.testing.assert_allclose(lin[b].numpy(), np.asarray(ref[False]), **RTOL)
        np.testing.assert_array_equal(near[b].numpy(), np.asarray(ref[True]))
    np.testing.assert_array_equal(near.sum(-1).numpy(), 1.0)


def test_warp_affine_field_pair():
    """The full six-pass pair warp from full-resolution fields (CPU hat path)."""
    rng = np.random.default_rng(7)
    shape = (12, 10, 14)
    va = rng.random((2, *shape), np.float32)
    vb = rng.integers(0, 8, (2, *shape)).astype(np.int32)
    rot, sh, sc = _affines(rng)
    A = np.stack([np.asarray(jaffine.make_affine_matrix(rot[b], sh[b], sc[b])) for b in range(2)])
    t = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    F = rng.uniform(-2, 2, (3, 2, *shape)).astype(np.float32)
    oa, ob = warp.warp_affine_field_pair(_t(va), _t(vb), _t(A), _t(t), _t(F[0]), _t(F[1]), _t(F[2]))
    assert ob.dtype == torch.int32
    for b in range(2):
        ja, jb = jwarp.warp_affine_field_pair(
            jnp.asarray(va[b]), jnp.asarray(vb[b]), jnp.asarray(A[b]), jnp.asarray(t[b]),
            *(jnp.asarray(F[c, b]) for c in range(3)),
        )
        np.testing.assert_allclose(oa[b].numpy(), np.asarray(ja), **RTOL)
        np.testing.assert_array_equal(ob[b].numpy(), np.asarray(jb))


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("field", [False, True])
def test_warp_affine_separable(field, nearest):
    """The single-volume warps (every pass a K2 plain pass): the five-pass
    affine warp and the six-pass affine + field warp, image within 1e-5,
    labels exactly."""
    rng = np.random.default_rng(9 + 2 * field + nearest)
    shape = (12, 10, 14)
    vol = rng.random((2, *shape), np.float32)
    if nearest:
        vol = rng.integers(0, 8, (2, *shape)).astype(np.float32)
    rot, sh, sc = _affines(rng)
    A = np.stack([np.asarray(jaffine.make_affine_matrix(rot[b], sh[b], sc[b])) for b in range(2)])
    t = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    F = rng.uniform(-2, 2, (3, 2, *shape)).astype(np.float32)
    if field:
        out = warp.warp_affine_field_separable(
            _t(vol), _t(A), _t(t), _t(F[0]), _t(F[1]), _t(F[2]), nearest=nearest
        )
    else:
        out = warp.warp_affine_separable(_t(vol), _t(A), _t(t), nearest=nearest)
    assert out.shape == (2, *shape) and out.dtype == torch.float32
    for b in range(2):
        args = (jnp.asarray(vol[b]), jnp.asarray(A[b]), jnp.asarray(t[b]))
        if field:
            ref = jwarp.warp_affine_field_separable(
                *args, *(jnp.asarray(F[c, b]) for c in range(3)), nearest=nearest
            )
        else:
            ref = jwarp.warp_affine_separable(*args, nearest=nearest)
        if nearest:
            np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_trilinear_and_nearest_interp():
    rng = np.random.default_rng(8)
    shape = (7, 8, 9)
    vol = rng.random((2, *shape), np.float32)
    lab = rng.integers(0, 8, (2, *shape)).astype(np.int32)
    xyz = [rng.uniform(-1, s, (2, *shape)).astype(np.float32) for s in shape]
    lin = interp.trilinear_interp(_t(vol), *map(_t, xyz))
    near = interp.nearest_interp(_t(lab), *map(_t, xyz))
    for b in range(2):
        args = [jnp.asarray(c[b]) for c in xyz]
        ref_lin = jinterp.trilinear_interp(jnp.asarray(vol[b]), *args)
        np.testing.assert_allclose(lin[b].numpy(), np.asarray(ref_lin), **RTOL)
        ref_near = jinterp.nearest_interp(jnp.asarray(lab[b]), *args)
        np.testing.assert_array_equal(near[b].numpy(), np.asarray(ref_near))
