"""The separable-warp surface of the port against the JAX package's, on the CPU.

The same numpy inputs (from a seed, B=2 at 32-48 voxels an axis) go through
the JAX function, one call per sample (its hat passes take ``_hat_pass_jnp``
on the CPU), and through the port's batch-first one (the kernels' plain
versions on CPU tensors):

- ``ops.blur`` (``gaussian_kernel_fixed``, ``gaussian_blur_3d``,
  ``blur_half_len``) and ``ops.interp`` (``interp_axis_linear``, ``zoom``
  with and without ``factor``/``in_shape``, ``trilinear_interp``'s
  ``default_value``): f32 within 1e-6 of the data scale (its largest
  magnitude; XLA sums the convolution in another order);
- ``hat_pass`` with ``out_len`` below and above S, ``hat_pass_pair`` in the
  four modes with and without ``out_len``, the three warps
  (``warp_affine_separable`` with an ``out_shape``,
  ``warp_affine_separable_pair`` in the four modes,
  ``warp_displacement_separable`` with displacements past ``FIELD_LIM``):
  images within 1e-5 of the data scale on smooth operands (XLA contracts
  the position polynomial into FMAs where the port does not, so an ulp of
  position times a white-noise row's jumps would exceed the bar), labels
  exactly;
- the bf16 forms under ``storage_scope`` against JAX's under its own
  ``storage_scope(jnp.bfloat16)``: labels exactly, images within two bf16
  ulps of the data scale (``tests/test_torch_precision.py``'s bar).
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fetalsyngen_tpu.ops.warp as W
from fetalsyngen_tpu.ops import affine as jaffine
from fetalsyngen_tpu.ops import blur as jblur
from fetalsyngen_tpu.ops import interp as jinterp
from fetalsyngen_tpu.ops import linops as jlinops
from fetalsyngen_torch.kernels import hat
from fetalsyngen_torch.ops import blur, interp, linops, warp

MODES = [(False, False), (False, True), (True, False), (True, True)]
SHAPE = (36, 40, 32)
OUT_SHAPE = (32, 44, 40)  # the U passes' OW: 40 > 32, 44 > 40, 32 < 36
BF16 = torch.bfloat16


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _smooth(rng, shape, scale):
    """A smooth random f32 volume in [0, scale]."""
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.random(shape), 2.0)
    return (scale * (x - x.min()) / (x.max() - x.min())).astype(np.float32)


def _labels(rng, shape):
    """Piecewise-constant labels 0..7 (a smooth field's levels)."""
    return np.floor(_smooth(rng, shape, 7.99)).astype(np.float32)


def _pair_volumes(rng, shape, modes):
    """A pair of B=2 volumes: labels where the mode is nearest, else a smooth
    image of scale 100."""
    return [np.stack([_labels(rng, shape) if m else _smooth(rng, shape, 100.0) for _ in range(2)]) for m in modes]


def _close(got, want):
    """Within 1e-6 of ``want``'s scale (its largest magnitude)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


def _ulps(a, b, scale) -> float:
    """max |a - b| in bf16 ulps of ``scale``."""
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))) / ulp)


def _hold(got, want, nearest, scale, bf16=False):
    """Labels exactly; images within 1e-5 of ``scale``, or (bf16) two bf16
    ulps of it."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if nearest:
        np.testing.assert_array_equal(got, want)
    elif bf16:
        assert _ulps(got, want, scale) <= 2.0
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def _affines(rng, shape, out_shape):
    """(B=2) near-identity affines from the deformation config's ranges, the
    output grid's centre mapped to the input's."""
    rot = (rng.uniform(-20, 20, (2, 3)) / 180.0 * np.pi).astype(np.float32)
    sh = rng.uniform(-0.02, 0.02, (2, 3)).astype(np.float32)
    sc = (1 + rng.uniform(-0.1, 0.1, (2, 3))).astype(np.float32)
    A = np.stack([np.asarray(jaffine.make_affine_matrix(rot[b], sh[b], sc[b])) for b in range(2)])
    c_in = (np.asarray(shape, np.float32) - 1) / 2
    c_out = (np.asarray(out_shape, np.float32) - 1) / 2
    t = (c_in - np.einsum("bij,j->bi", A, c_out) + rng.uniform(-1, 1, (2, 3))).astype(np.float32)
    return A, t


# ---------------------------------------------------------------------------
# ops.blur and ops.interp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half_len", [3, 8])
def test_gaussian_kernel_fixed(half_len):
    sigmas = np.array([0.0, 0.3, 1.0, 2.5], np.float32)
    got = blur.gaussian_kernel_fixed(_t(sigmas), half_len)
    assert got.shape == (4, 2 * half_len + 1)
    for i, s in enumerate(sigmas):
        _close(got[i].numpy(), jblur.gaussian_kernel_fixed(jnp.float32(s), half_len))
    assert torch.equal(blur.gaussian_kernel_fixed(0.0, half_len), got[0])


def test_gaussian_blur_3d():
    """Per-sample, per-axis stds, one of them 0 (the identity on that axis)."""
    rng = _rng("blur")
    vol = rng.random((2, 32, 36, 40), np.float32)
    stds = np.array([[1.2, 0.0, 2.0], [0.5, 1.7, 0.8]], np.float32)
    half_len = blur.blur_half_len(float(stds.max()))
    got = blur.gaussian_blur_3d(_t(vol), _t(stds), half_len)
    for b in range(2):
        want = np.asarray(jblur.gaussian_blur_3d(jnp.asarray(vol[b]), jnp.asarray(stds[b]), half_len))
        _close(got[b].numpy(), want)
    # the banded-matmul production form computes the same blur
    np.testing.assert_allclose(got.numpy(), linops.gaussian_blur_mm(_t(vol), _t(stds), half_len).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.0, 0.2, 1.0, 2.34, 4.0, 5.0])
def test_blur_half_len(sigma):
    assert blur.blur_half_len(sigma) == jblur.blur_half_len(sigma)


@pytest.mark.parametrize("in_size", ["none", "int", "per-sample"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_interp_axis_linear(axis, in_size):
    """Coordinates past both edges; the logical extent as the whole axis, an
    int, or one per sample (each sample against JAX's with its own)."""
    rng = _rng(f"axis-{axis}-{in_size}")
    x = rng.random((2, 12, 14, 16, 3), np.float32)
    n = x.shape[1 + axis]
    coords = rng.uniform(-2.0, n + 2.0, (2, 20)).astype(np.float32)
    sizes = {"none": [None, None], "int": [n - 3, n - 3], "per-sample": [n - 2, n - 5]}[in_size]
    arg = None if in_size == "none" else sizes[0] if in_size == "int" else _t(np.array(sizes, np.int32))
    got = interp.interp_axis_linear(_t(x), _t(coords), axis, arg)
    for b in range(2):
        size = None if sizes[b] is None else jnp.int32(sizes[b])
        want = jinterp.interp_axis_linear(jnp.asarray(x[b]), jnp.asarray(coords[b]), axis, size)
        _close(got[b].numpy(), want)


@pytest.mark.parametrize("kind", ["default", "factor", "in_shape"])
def test_zoom(kind):
    """``zoom`` to another grid: the default factors, given per-sample
    factors, and a logical input extent in the buffer's corner. Smooth
    operands: JAX's default factors are constants of its jitted ``zoom``,
    and XLA turns the division by them into a product by their reciprocal,
    an ulp off the coordinates (times a white-noise row's jumps, 30 ulps of
    the value)."""
    rng = _rng(f"zoom-{kind}")
    x = np.stack([_smooth(rng, (32, 36, 40), 1.0) for _ in range(2)])
    out_shape = (40, 30, 48)
    factor = in_shape = None
    if kind != "default":
        factor = rng.uniform(0.8, 1.3, (2, 3)).astype(np.float32)
    if kind == "in_shape":
        in_shape = np.array([[28, 36, 33], [32, 30, 40]], np.int32)
    got = interp.zoom(_t(x), out_shape, None if factor is None else _t(factor),
                      None if in_shape is None else _t(in_shape))
    assert got.shape == (2, *out_shape)
    for b in range(2):
        want = jinterp.zoom(jnp.asarray(x[b]), out_shape, None if factor is None else jnp.asarray(factor[b]),
                            None if in_shape is None else jnp.asarray(in_shape[b]))
        _close(got[b].numpy(), want)
    if kind == "in_shape":  # the banded-matmul production form computes the same zoom
        mm = linops.zoom_mm(_t(x), out_shape, _t(factor), _t(in_shape))
        np.testing.assert_allclose(got.numpy(), mm.numpy(), rtol=1e-5, atol=1e-6)


def test_trilinear_default_value():
    rng = _rng("trilinear-default")
    shape = (7, 8, 9)
    vol = rng.random((2, *shape), np.float32)
    xyz = [rng.uniform(-2, s + 1, (2, *shape)).astype(np.float32) for s in shape]
    for default in (-1.5, _t(np.array([3.0, -7.0], np.float32)).reshape(2, 1, 1, 1)):
        got = interp.trilinear_interp(_t(vol), *map(_t, xyz), default_value=default)
        for b in range(2):
            d = default if isinstance(default, float) else float(default[b])
            want = jinterp.trilinear_interp(jnp.asarray(vol[b]), *(jnp.asarray(c[b]) for c in xyz), d)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
            assert (got[b].numpy() == d).sum() > 0


# ---------------------------------------------------------------------------
# the hat passes with out_len and per-operand modes
# ---------------------------------------------------------------------------


def _coefs(rng, S, OW):
    """(2, 4) per-sample coefficients: row terms, a lane slope above S / OW
    and a negative bias, so positions span the row and pass both edges."""
    return np.stack([rng.uniform(-0.2, 0.2, 2), rng.uniform(-0.2, 0.2, 2), (S / OW) * rng.uniform(1.15, 1.25, 2),
                     rng.uniform(-4, -2, 2)], 1).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("OW", [20, 45])
def test_hat_pass_out_len(OW, nearest, bf16):
    """K2's plain version writing OW != S lanes (below and above S = 32)."""
    rng = _rng(f"hat-ow-{OW}-{nearest}-{bf16}")
    D, H, S = 6, 10, 32
    x = np.stack([_labels(rng, (D, H, S)) if nearest else _smooth(rng, (D, H, S), 100.0) for _ in range(2)])
    coefs = _coefs(rng, S, OW)
    tx = _t(x).to(BF16) if bf16 else _t(x)
    got = hat.hat_pass(tx, _t(coefs), None, nearest, out_len=OW)
    assert got.shape == (2, D, H, OW) and got.dtype == tx.dtype
    pos = hat.positions(_t(coefs), D * H, H, OW)
    assert bool((pos <= 0).any()) and bool((pos >= S - 1).any())
    with jlinops.storage_scope(jnp.bfloat16 if bf16 else None):
        for b in range(2):
            want = W.hat_pass(jnp.asarray(x[b]), tuple(np.float32(c) for c in coefs[b]), None, (D, H, S),
                              W.MAXSPAN_U, nearest, out_len=OW)
            _hold(got[b], want.astype(jnp.float32), nearest, 100.0, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("OW", [None, 24, 41])
@pytest.mark.parametrize("modes", MODES, ids=lambda m: "".join("n" if v else "l" for v in m))
def test_hat_pass_pair_modes(modes, OW, bf16):
    """K1's plain version in the four (first, second) modes, per-sample
    coefficients without a displacement, OW = S (32) or another length."""
    rng = _rng(f"pair-{modes}-{OW}-{bf16}")
    D, H, S = 6, 10, 32
    xa, xb = _pair_volumes(rng, (D, H, S), modes)
    coefs = _coefs(rng, S, OW or S)
    ta, tb = (_t(v).to(BF16) if bf16 else _t(v) for v in (xa, xb))
    oa, ob = hat.hat_pass_pair(ta, tb, _t(coefs), None, modes[1], out_len=OW, nearest_a=modes[0])
    assert oa.shape == ob.shape == (2, D, H, OW or S)
    with jlinops.storage_scope(jnp.bfloat16 if bf16 else None):
        for b in range(2):
            ja, jb = W.hat_pass_pair(jnp.asarray(xa[b]), jnp.asarray(xb[b]), tuple(np.float32(c) for c in coefs[b]),
                                     None, (D, H, S), W.MAXSPAN_U, out_len=OW, modes=modes)
            _hold(oa[b], ja.astype(jnp.float32), modes[0], 100.0, bf16)
            _hold(ob[b], jb.astype(jnp.float32), modes[1], 100.0, bf16)


def test_hat_pass_pair_per_slice_bf16():
    """K1's per-slice linear pair on bf16 rows (the scanner's in-plane form)
    against JAX's under its storage scope."""
    rng = _rng("pair-slice-bf16")
    D, H, S = 8, 12, 40
    xa, xb = _pair_volumes(rng, (D, H, S), (False, False))
    coefs = np.stack([np.zeros((2, D)), rng.uniform(-0.1, 0.1, (2, D)), rng.uniform(0.9, 1.1, (2, D)),
                      rng.uniform(-3, 3, (2, D))], -1).astype(np.float32)
    oa, ob = hat.hat_pass_pair(_t(xa).to(BF16), _t(xb).to(BF16), _t(coefs), None, nearest_b=False)
    with jlinops.storage_scope(jnp.bfloat16):
        for b in range(2):
            ja, jb = W.hat_pass_pair(jnp.asarray(xa[b]), jnp.asarray(xb[b]), jnp.asarray(coefs[b]), None, (D, H, S),
                                     128, modes=(False, False))
            _hold(oa[b], ja.astype(jnp.float32), False, 100.0, True)
            _hold(ob[b], jb.astype(jnp.float32), False, 100.0, True)


@pytest.mark.parametrize("nearest", [False, True])
def test_hat_pass_field_bf16(nearest):
    """K2's per-sample form with a displacement volume on bf16 rows."""
    rng = _rng(f"field-bf16-{nearest}")
    D, H, S = 6, 10, 32
    x = np.stack([_labels(rng, (D, H, S)) if nearest else _smooth(rng, (D, H, S), 100.0) for _ in range(2)])
    coefs = np.stack([rng.uniform(-0.5, 0.5, 2), np.zeros(2), np.ones(2), np.zeros(2)], 1).astype(np.float32)
    disp = np.stack([_smooth(rng, (D, H, S), 2 * W.FIELD_LIM) - W.FIELD_LIM for _ in range(2)])
    got = hat.hat_pass(_t(x).to(BF16), _t(coefs), _t(disp), nearest)
    with jlinops.storage_scope(jnp.bfloat16):
        for b in range(2):
            want = W.hat_pass(jnp.asarray(x[b]), tuple(np.float32(c) for c in coefs[b]), jnp.asarray(disp[b]),
                              (D, H, S), W.MAXSPAN_FIELD, nearest)
            _hold(got[b], want.astype(jnp.float32), nearest, 100.0, True)


def test_out_len_must_match_the_displacement():
    x = torch.zeros((1, 2, 3, 8))
    coefs = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="out_len=5 but the displacement has 8 lanes"):
        hat.hat_pass(x, coefs, torch.zeros((1, 2, 3, 8)), out_len=5)
    with pytest.raises(ValueError, match="out_len must be positive"):
        hat.hat_pass_pair(x, x, coefs, None, out_len=0)
    assert hat.hat_pass(x, coefs, out_len=11).shape == (1, 2, 3, 11)


# ---------------------------------------------------------------------------
# the warps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nearest", [False, True])
def test_warp_affine_separable_out_shape(nearest, bf16):
    """Five K2 passes onto another grid (OW below and above S across the U
    passes); ``maxspan`` is accepted and changes nothing."""
    rng = _rng(f"affine-{nearest}-{bf16}")
    vol = np.stack([_labels(rng, SHAPE) if nearest else _smooth(rng, SHAPE, 100.0) for _ in range(2)])
    A, t = _affines(rng, SHAPE, OUT_SHAPE)
    with linops.storage_scope(BF16 if bf16 else None):
        got = warp.warp_affine_separable(_t(vol), _t(A), _t(t), nearest, OUT_SHAPE)
        assert torch.equal(warp.warp_affine_separable(_t(vol), _t(A), _t(t), nearest, OUT_SHAPE, maxspan=300), got)
    assert got.shape == (2, *OUT_SHAPE) and got.dtype == torch.float32
    with jlinops.storage_scope(jnp.bfloat16 if bf16 else None):
        for b in range(2):
            want = W.warp_affine_separable(jnp.asarray(vol[b]), jnp.asarray(A[b]), jnp.asarray(t[b]), nearest,
                                           OUT_SHAPE)
            _hold(got[b], want, nearest, 100.0, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("modes", MODES, ids=lambda m: "".join("n" if v else "l" for v in m))
def test_warp_affine_separable_pair(modes, bf16):
    """Five K1 passes with shared positions in each pair of modes, onto
    another grid."""
    rng = _rng(f"affine-pair-{modes}-{bf16}")
    va, vb = _pair_volumes(rng, SHAPE, modes)
    A, t = _affines(rng, SHAPE, OUT_SHAPE)
    with linops.storage_scope(BF16 if bf16 else None):
        oa, ob = warp.warp_affine_separable_pair(_t(va), _t(vb), _t(A), _t(t), modes, OUT_SHAPE)
    assert oa.shape == ob.shape == (2, *OUT_SHAPE) and oa.dtype == (BF16 if bf16 else torch.float32)
    with jlinops.storage_scope(jnp.bfloat16 if bf16 else None):
        for b in range(2):
            ja, jb = W.warp_affine_separable_pair(jnp.asarray(va[b]), jnp.asarray(vb[b]), jnp.asarray(A[b]),
                                                  jnp.asarray(t[b]), modes, OUT_SHAPE)
            _hold(oa[b], ja.astype(jnp.float32), modes[0], 100.0, bf16)
            _hold(ob[b], jb.astype(jnp.float32), modes[1], 100.0, bf16)


def test_warp_affine_separable_pair_default_grid():
    """Without ``out_shape`` the pair keeps the input's grid and equals two
    single warps."""
    rng = _rng("affine-pair-default")
    va, vb = _pair_volumes(rng, SHAPE, (False, True))
    A, t = _affines(rng, SHAPE, SHAPE)
    oa, ob = warp.warp_affine_separable_pair(_t(va), _t(vb), _t(A), _t(t), (False, True))
    assert torch.equal(oa, warp.warp_affine_separable(_t(va), _t(A), _t(t)))
    assert torch.equal(ob, warp.warp_affine_separable(_t(vb), _t(A), _t(t), nearest=True))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nearest", [False, True])
def test_warp_displacement_separable(nearest, bf16):
    """Three K2 passes with a displacement volume; the smooth displacements
    reach past +-FIELD_LIM, so the clip acts."""
    rng = _rng(f"displacement-{nearest}-{bf16}")
    vol = np.stack([_labels(rng, SHAPE) if nearest else _smooth(rng, SHAPE, 100.0) for _ in range(2)])
    d = np.stack([np.stack([_smooth(rng, SHAPE, 48.0) - 24.0 for _ in range(2)]) for _ in range(3)])
    assert (np.abs(d) > W.FIELD_LIM).mean() > 0.01
    with linops.storage_scope(BF16 if bf16 else None):
        got = warp.warp_displacement_separable(_t(vol), *map(_t, d), nearest=nearest)
    assert got.shape == (2, *SHAPE) and got.dtype == torch.float32
    with jlinops.storage_scope(jnp.bfloat16 if bf16 else None):
        for b in range(2):
            want = W.warp_displacement_separable(jnp.asarray(vol[b]), *(jnp.asarray(c[b]) for c in d), nearest)
            _hold(got[b], want, nearest, 100.0, bf16)
