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
from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.generator.config import DeformCfg, GeneratorCfg, IntensityCfg
from fetalsyngen_torch.kernels import deform_mask, row_affine
from fetalsyngen_torch.ops import affine, interp, linops, numerics, warp
from fetalsyngen_torch.testing import phantom_seeds_and_seg

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


PASS_ORDERS = ["ikj", "kji", "jik", "kij", "ijk"]  # the pair warp's five passes
# (name, (I, J, S), slope, amount, bias) of the row-affine pass cases, B=2:
# positions between the taps; clamping at both ends; exact half-integers
# (rounded half to even) and integers; J != S both ways
ROW_AFFINE_CASES = [
    ("general", (6, 10, 12), (0.93, 1.08), (0.31, -0.47), (0.6, -1.2)),
    ("clamped", (3, 13, 9), (1.3, 0.7), (0.9, -1.4), (-3.0, 4.0)),
    ("half", (4, 9, 14), (1.0, 0.5), (0.0, 1.0), (0.5, 0.0)),
]
ROW_AFFINE_SCOPES = {
    "f32": lambda: linops.f32_scope(),
    "bf16": lambda: linops.storage_scope(torch.bfloat16),
    "default": lambda: linops.precision_scope(linops.DEFAULT),
}


def _row_affine_operands(shape, seed, rows="s", dtypes=(torch.float32, torch.int32)):
    """A (B=2, I, J, S) image in [0, 100) and labels 0..49 of ``dtypes``,
    contiguous along S (``rows`` "s") or along J (a permuted view, as the
    L-z peel reads the hat pass's output)."""
    g = torch.Generator().manual_seed(seed)
    I, J, S = shape
    base = (2, I, J, S) if rows == "s" else (2, I, S, J)
    xa = (100.0 * torch.rand(base, generator=g)).to(dtypes[0])
    xb = torch.randint(0, 50, base, generator=g).to(dtypes[1])
    if rows == "j":
        xa, xb = xa.permute(0, 1, 3, 2), xb.permute(0, 1, 3, 2)
    return xa, xb


def _row_affine_emulated(xa, xb, slope, amount, bias, out_order, form):
    """The row-affine kernel modelled on the CPU: ``row_affine.plan``'s tile
    slots and strides address the operands' storage and the contiguous
    output, and each output sample reads its two taps (one nearest) in the
    kernel's arithmetic and roundings."""
    f32, bf16 = torch.float32, torch.bfloat16
    xa, xb = row_affine._operands(xa, xb)
    B, _, J, S = xa.shape
    lay = row_affine.plan(xa.shape, xa.stride(), out_order)
    grid = torch.meshgrid(*(torch.arange(n) for n in lay["n"]), indexing="ij")
    bb = torch.arange(B).view(B, 1, 1, 1)
    j, k = (grid[lay[c]].to(f32)[None] for c in ("jslot", "kslot"))
    sl, am, bi = (v.view(B, 1, 1, 1) for v in (slope, amount, bias + amount * ((J - 1) / 2.0)))
    pos = torch.clamp(sl * k + am * (j - (J - 1) / 2.0) + bi, 0.0, S - 1.0)
    # the kernel's taps: s0 = min(floor(pos), S - 2) and s0 + 1, weights
    # without the operator's clamp and |.|
    f = torch.clamp(torch.floor(pos), max=S - 2.0)
    s0 = f.long()
    taps = (s0, s0 + 1, torch.round(pos).long())
    w = [1.0 - (pos - f), 1.0 - ((f + 1.0) - pos)]
    row = bb * lay["in_b"] + sum(g[None] * st for g, st in zip(grid, lay["is"]))

    def tap(x, s):
        flat = x.as_strided((x.untyped_storage().nbytes() // x.element_size(),), (1,), 0)
        return flat[row + s * lay["in_s"]].to(f32)

    a0, a1, bn = tap(xa, taps[0]), tap(xa, taps[1]), tap(xb, taps[2])
    if form != "f32":
        w, (a0, a1, bn) = [v.to(bf16).to(f32) for v in w], (v.to(bf16).to(f32) for v in (a0, a1, bn))
    out_dtype = bf16 if form == "bf16" else f32
    o = (bb * lay["out_b"] + sum(g[None] * st for g, st in zip(grid, lay["os"]))).flatten()
    outs = []
    for v in (w[0] * a0 + w[1] * a1, bn):
        out = torch.full((B * lay["out_b"],), float("nan"), dtype=out_dtype)
        out[o] = v.flatten().to(out_dtype)
        outs.append(out.view(lay["out_shape"]))
    return tuple(outs)


@pytest.mark.parametrize("rows", ["s", "j"])
@pytest.mark.parametrize("form", sorted(ROW_AFFINE_SCOPES))
@pytest.mark.parametrize("out_order", PASS_ORDERS)
def test_row_affine_kernel_model_matches_plain(out_order, form, rows):
    """The kernel's two-tap arithmetic, addressed as ``row_affine.plan``
    lays out its launch (operands contiguous along S, or along J as the L-z
    peel reads them), equals the banded-operator einsum in each scope's
    form: bit for bit where the operands are rounded to bf16 (two exact
    products, one rounding), labels always, the f32 image within f32
    rounding."""
    dtypes = (torch.float32, torch.int32) if rows == "s" else (torch.bfloat16, torch.bfloat16)
    for seed, (name, shape, slope, amount, bias) in enumerate(ROW_AFFINE_CASES):
        xa, xb = _row_affine_operands(shape, seed, rows, dtypes)
        coefs = [torch.tensor(v, dtype=torch.float32) for v in (slope, amount, bias)]
        with ROW_AFFINE_SCOPES[form]():
            pa, pb = warp._row_affine_matmul_pair(xa.float(), xb.float(), *coefs, out_order=out_order)
        ka, kb = _row_affine_emulated(xa, xb, *coefs, out_order, form)
        assert ka.shape == pa.shape and ka.dtype == pa.dtype == kb.dtype == pb.dtype, name
        assert torch.equal(kb, pb), name
        if form == "f32":
            torch.testing.assert_close(ka, pa, rtol=2**-22, atol=2**-22 * 100.0, msg=name)
        else:
            assert torch.equal(ka, pa), name


@pytest.mark.parametrize("storage", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("out_order", PASS_ORDERS)
def test_row_affine_pass_pair_cpu(out_order, storage):
    """On CPU tensors the wrapper is ``_row_affine_matmul_pair`` on the
    operands converted to f32 (f32 images and int32 labels, as the pair
    warp's first pass receives them), in and outside the storage scope."""
    for seed, (name, shape, slope, amount, bias) in enumerate(ROW_AFFINE_CASES):
        xa, xb = _row_affine_operands(shape, 10 + seed)
        coefs = [torch.tensor(v, dtype=torch.float32) for v in (slope, amount, bias)]
        with linops.storage_scope(storage):
            got = warp.row_affine_pass_pair(xa, xb, *coefs, out_order=out_order)
            want = warp._row_affine_matmul_pair(xa.float(), xb.float(), *coefs, out_order=out_order)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name


def test_row_affine_plan_of_the_pair_warp():
    """The five passes' launch plans at (D, H, W) = (5, 6, 7): reads along
    the input's contiguous axis (s as k; j for the L-z peel's transposed
    view) and writes along the output's, or straight from registers where
    the two coincide (the first half of U-x)."""
    B, D, H, W = 2, 5, 6, 7
    passes = [  # input (B, I, J, S) shape and strides, out_order -> slots
        ((B, D, H, W), (D * H * W, H * W, W, 1), "ikj", ("k", "j", "i")),
        ((B, D, W, H), (D * H * W, H * W, H, 1), "kji", ("k", "i", "j")),
        ((B, H, W, D), (D * H * W, W * D, D, 1), "jik", ("k", "i", "j")),
        ((B, W, H, D), (D * H * W, H * D, D, 1), "kij", ("k", "j", "i")),
        ((B, D, H, W), (D * H * W, H * W, 1, H), "ijk", ("j", "k", "i")),
    ]
    for shape, strides, order, slots in passes:
        lay = row_affine.plan(shape, strides, order)
        assert lay["slots"] == slots, order
        assert lay["out_shape"] == (B, *(dict(zip("ijk", shape[1:]))[c] for c in order))
        assert lay["os"][0] == 1 if order == "jik" else lay["os"][1] == 1
    with pytest.raises(ValueError, match="permutation"):
        row_affine.plan((B, D, H, W), (1, 1, 1, 1), "iik")


def test_warp_affine_field_pair_pre_takes_five_row_affine_passes(monkeypatch):
    """Each call of the pair warp runs its U passes and the L21 peel through
    ``row_affine_pass_pair``: five calls, the first on the operands as they
    arrive (f32 image, int32 labels)."""
    calls = []
    plain = warp.row_affine_pass_pair

    def counted(xa, xb, *args, **kw):
        calls.append((xa.dtype, xb.dtype, kw["out_order"]))
        return plain(xa, xb, *args, **kw)

    monkeypatch.setattr(warp, "row_affine_pass_pair", counted)
    rng = np.random.default_rng(7)
    shape = (12, 10, 14)
    va = _t(rng.random((2, *shape), np.float32))
    vb = _t(rng.integers(0, 8, (2, *shape)).astype(np.int32))
    A = torch.eye(3).expand(2, 3, 3) * 1.05
    F = [torch.zeros((2, *shape)) for _ in range(3)]
    warp.warp_affine_field_pair(va, vb, A, torch.zeros((2, 3)), *F)
    assert [c[2] for c in calls] == PASS_ORDERS
    assert calls[0][:2] == (torch.float32, torch.int32)


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


# ---------------------------------------------------------------------------
# the small-field pair warp's OOB mask and margin shift (kernels.deform_mask)
# ---------------------------------------------------------------------------

# per-sample size_F_small of a (B=3) batch: the 256^3 generator's range on
# each axis (8-16), and the 32^3 one's (1-3: one entry per operator row)
MASK_SIZES = {"8-16": [[8, 12, 16], [16, 9, 13], [11, 16, 8]], "1-3": [[1, 2, 3], [2, 2, 1], [3, 1, 2]]}


def _mask_case(shape, seed, sizes, dtype, buf=17):
    """The mask's operands as the pair warp forms them, for a batch of three:
    ``h_s = A F_small`` of a (3, 3, buf, buf, buf) field, affines of the
    generator's ranges with scalings to +-15%, but sample 0 a compression to
    85% with a field of std 0.5 (its margin shift leaves 0) and the others
    fields of std 4; c2 the centre as an expanded row; and a phantom
    image of ``dtype`` in the pair warp's output layout, (B, D, H, W) over
    (B, H, W, D) memory."""
    g = torch.Generator().manual_seed(seed)
    B = len(sizes)
    rot = (2 * torch.rand(B, 3, generator=g) - 1) * (20.0 / 180.0 * np.pi)
    sh = (2 * torch.rand(B, 3, generator=g) - 1) * 0.02
    sc = 1 + (2 * torch.rand(B, 3, generator=g) - 1) * 0.15
    rot[0], sc[0] = 0.0, 0.85
    A = affine.make_affine_matrix(rot, sh, sc)
    std = torch.tensor([0.5] + [4.0] * (B - 1)).view(B, 1, 1, 1, 1)
    h_s = torch.einsum("bij,bjxyz->bixyz", A, std * torch.randn(B, 3, buf, buf, buf, generator=g))
    c2 = torch.tensor([(s - 1) / 2.0 for s in shape]).expand(B, 3)
    seeds, _ = phantom_seeds_and_seg(shape, seed=seed)
    img = torch.stack([torch.from_numpy(seeds.astype(np.float32)) * (1.0 + b) + 1.0 for b in range(B)])
    a = img.to(dtype).permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    return h_s, torch.tensor(sizes, dtype=torch.int32), A, c2, a


def _fma(w1, x1, w0, x0):
    """fma(w1, x1, w0 * x0) in f32: the exact product plus the rounded one,
    rounded once (through f64, whose sum of the two is exact here)."""
    return (w1.double() * x1.double() + (w0 * x0).double()).float()


def _mask_taps(S, n, nbuf):
    """``csrc/deform_mask.cu``'s ``zoom_tap`` for every output index along an
    axis of S from (B,) logical extents ``n``: (B, S) taps z0, z1 (clamped
    into the buffer) and weights 1 - w, w."""
    nf = n.to(torch.float32)[:, None]
    factor = torch.tensor(float(S)) / nf
    delta = (1.0 - factor) / (2.0 * factor)
    coord = delta + torch.arange(S, dtype=torch.float32)[None] / factor
    hi = nf - 1.0
    c = torch.minimum(torch.maximum(coord, torch.zeros(())), hi)
    f = torch.minimum(torch.maximum(torch.floor(c), torch.zeros(())), hi - 1.0)
    w = c - f
    fi = f.long()
    return fi.clamp(0, nbuf - 1), (fi + 1).clamp(0, nbuf - 1), 1.0 - w, w


def _mask_model(h_s, size, A, c2, shape, margin_shift, a):
    """The two kernels modelled on the CPU: per sample the zoom of ``h_s``
    formed separably, two taps an axis in the order axis 0, 1, 2 as
    fma(w, x[f + 1], (1 - w) x[f]); ``v_r = (((A_r0 x + A_r1 y) + A_r2 z) +
    c2_r) + H_r``; the shift the floor of the clamped min, the mask of the
    clamped coordinates less it, and ``a`` zeroed outside it, written
    contiguous. Returns (shift, ok, out)."""
    B = h_s.shape[0]
    taps = [_mask_taps(shape[ax], size[:, ax], h_s.shape[2 + ax]) for ax in range(3)]
    grid = [torch.arange(s, dtype=torch.float32) - (s - 1) / 2.0 for s in shape]
    x, y, z = grid[0].view(-1, 1, 1), grid[1].view(1, -1, 1), grid[2].view(1, 1, -1)
    shift = torch.zeros(B, 3)
    ok = torch.ones((B, *shape), dtype=torch.bool)
    for b in range(B):
        (x0, x1, xw0, xw1), (y0, y1, yw0, yw1), (z0, z1, zw0, zw1) = ([t[b] for t in tp] for tp in taps)
        t0 = _fma(xw1.view(1, -1, 1, 1), h_s[b][:, x1], xw0.view(1, -1, 1, 1), h_s[b][:, x0])
        t1 = _fma(yw1.view(1, 1, -1, 1), t0[:, :, y1], yw0.view(1, 1, -1, 1), t0[:, :, y0])
        H = _fma(zw1, t1[..., z1], zw0, t1[..., z0])
        cs = []
        for r in range(3):
            v = ((A[b, r, 0] * x + A[b, r, 1] * y) + A[b, r, 2] * z + c2[b, r]) + H[r]
            last = float(shape[r] - 1)
            if margin_shift:
                shift[b, r] = torch.floor(torch.clamp(v.amin(), 0.0, last))
            cs.append(torch.clamp(v, 0.0, last))
        for r, c in enumerate(cs):
            cr = c - shift[b, r]
            ok[b] &= (cr > 0) & (cr <= shape[r] - 1)
    out = torch.zeros(a.shape, dtype=a.dtype)
    out[ok] = a[ok]
    return shift, ok, out


@pytest.mark.parametrize("sizes", sorted(MASK_SIZES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("margin", [True, False], ids=["shift", "noshift"])
@pytest.mark.parametrize("shape", [(32, 32, 32), (48, 40, 36)], ids=["32", "48x40x36"])
def test_deform_mask_kernel_model_matches_plain(shape, margin, dtype, sizes):
    """The mask kernels' arithmetic (the zoom of the small field formed on
    the fly, two taps an axis; the coordinates' association; the shift's
    clamped min; the mask; the masked image written contiguous) against
    the zoom-based composition ``pipeline.pair_mask_plain``: the shift
    identical, the mask on all but 1e-6 of the voxels, the image equal
    wherever the masks agree."""
    h_s, size, A, c2, a = _mask_case(shape, len(shape) + shape[0] + len(sizes), MASK_SIZES[sizes], dtype)
    shift, ok = tpipe.pair_mask_plain(h_s, size, A, c2, shape, margin)
    plain = torch.where(ok, a, 0.0)
    m_shift, m_ok, m_out = _mask_model(h_s, size, A, c2, shape, margin, a)
    assert torch.equal(m_shift, shift)
    if margin:
        assert bool((shift[0] > 0).all()) and bool((shift[1:] == 0).any())
    assert int((m_ok != ok).sum()) <= 1e-6 * ok.numel()
    assert 0 < int(ok.sum()) < ok.numel()
    agree = m_ok == ok
    assert m_out.is_contiguous() and m_out.dtype == plain.dtype == a.dtype
    assert torch.equal(m_out[agree], plain[agree])


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("margin", [True, False], ids=["shift", "noshift"])
def test_deform_mask_not_taken_on_the_cpu(monkeypatch, margin, flip):
    """``synth_core`` on CPU tensors runs the plain composition: the mask
    kernels are neither loaded nor counted; and the small-field pair warp's
    image equals ``pair_mask_plain``'s mask applied to the same warp's
    output, its labels that output's."""
    shape = (32, 32, 32)
    cfg = GeneratorCfg(shape=shape, resolution=(0.5, 0.5, 0.5),
                       intensity=IntensityCfg(1, 6, tuple([0] + list(range(10, 50))),
                                              tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))),
                       deform=DeformCfg(size=shape, margin_shift=margin))
    monkeypatch.setattr(deform_mask, "_kernels", lambda: pytest.fail("the CPU path loaded the mask kernels"))
    before = dict(deform_mask.LAUNCHES)
    seeds, seg = phantom_seeds_and_seg(shape, seed=4)
    seeds = torch.from_numpy(np.stack([seeds, seeds]).astype(np.int32))
    segs = torch.from_numpy(np.stack([seg, seg]).astype(np.int32))
    gens = tpipe.make_generators([11, 12], "cpu")
    p = tpipe.sample_params(gens, cfg, {"deform_apply": True, "flip": flip})
    f = tpipe.draw_fields(gens, cfg, "cpu")
    out, lab, _ = tpipe.synth_core(p, f, seeds, segs, cfg, stages=tpipe.STAGES_GENERATE)
    assert deform_mask.LAUNCHES == before
    assert out.shape == (2, *shape) and bool(torch.isfinite(out).all())
    assert set(torch.unique(lab).tolist()) <= set(np.unique(seg).tolist())

    warped = []
    pair_warp = tpipe.warp_affine_field_pair_pre
    monkeypatch.setattr(tpipe, "warp_affine_field_pair_pre", lambda *a: warped.append(pair_warp(*a)) or warped[-1])
    A = affine.make_affine_matrix(p.rotations, p.shears, p.scalings)
    c = torch.tensor([(s - 1) / 2.0 for s in shape]).expand(2, 3)
    img = 1.0 + seeds.to(torch.float32)
    got_a, got_b = tpipe._deform_pair_small_fields(p, f.nonlin, cfg, A, c, c, img, segs)
    assert deform_mask.LAUNCHES == before and len(warped) == 1
    h_s = torch.einsum("bij,bjxyz->bixyz", A, tpipe._small_field(p, f.nonlin))
    _, ok = tpipe.pair_mask_plain(h_s, p.size_F_small, A, c, shape, margin)
    assert 0 < int(ok.sum()) < ok.numel()
    assert torch.equal(got_a, torch.where(ok, warped[0][0], 0.0))
    assert torch.equal(got_b, warped[0][1].to(segs.dtype))
