"""Hat passes: the port's plain versions against the JAX package.

``fetalsyngen_torch.kernels.hat.hat_pass_pair_ref`` and ``hat_pass_ref``
(the CUDA kernels' references, and the wrappers' CPU paths) must reproduce
JAX ``hat_pass_pair`` and ``hat_pass`` on the CPU, which take
``_hat_pass_jnp``: labels exactly, the image to f32 rounding (XLA contracts
the lerp into an FMA, the port does not). For the paired pass, coefficients
and displacements are chosen so every product in the position polynomial is
exact, or has a single nonzero term (the main path's ``(L, 0, 1, 0)`` rows),
so positions agree bit for bit. The single pass is also held at the affine
warp's U-pass coefficients, general slopes with up to three nonzero
products.

One case runs the Pallas kernel itself in interpreter mode, at a shape no
other test file traces (a jit cache traced without interpreter mode would
otherwise be reused).
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fetalsyngen_tpu.ops.warp as W
from fetalsyngen_torch.kernels import hat

IMG_TOL = dict(atol=1e-5, rtol=1e-6)


def _jax_pair(xa, xb, coefs, disp, shape, OW=None, **kw):
    oa, ob = W.hat_pass_pair(
        jnp.asarray(xa), jnp.asarray(xb), tuple(np.float32(c) for c in coefs),
        jnp.asarray(disp), shape, W.MAXSPAN_FIELD, out_len=OW, modes=(False, True), **kw,
    )
    return np.asarray(oa), np.asarray(ob)


def _case(kind, rng):
    """(shape (D, H, S), OW, coefs (B, 4), disp (B, D, H, OW)) for a batch of 2."""
    D, H, S = 6, 10, 16
    OW = S
    if kind in ("ly", "lz", "x"):
        # main-path rows: (L, 0, 1, 0) with the field clipped to +-FIELD_LIM
        L = rng.uniform(-0.5, 0.5, 2).astype(np.float32) if kind != "x" else np.zeros(2, np.float32)
        coefs = np.stack([L, 0 * L, 0 * L + 1, 0 * L], 1)
        disp = rng.uniform(-W.FIELD_LIM, W.FIELD_LIM, (2, D, H, OW))
    elif kind == "half":
        # every position an exact half-integer: nearest rounds half to even
        coefs = np.array([[0, 0, 1, 0], [1, -1, 1, 0.5]], np.float32)
        disp = rng.integers(-8, 9, (2, D, H, OW)) + 0.5
    elif kind == "saturate":
        coefs = np.array([[0, 0, 1, 0], [0.5, 0.25, 1, -2]], np.float32)
        disp = rng.choice([-(S + 3.0), -0.25, 0.0, 0.75, S - 1.0, S + 3.0], (2, D, H, OW))
    elif kind == "ow":
        OW = 24
        coefs = np.array([[0.5, 0.25, 0.75, -1.5], [0, 0.125, 0.5, 0.25]], np.float32)
        disp = rng.integers(-24, 25, (2, D, H, OW)) / 8.0
    elif kind == "reverse":
        # lanes read backwards, rows shifted by exact binary fractions
        coefs = np.array([[0, 0, -1, S - 1], [0.25, -0.5, -1, S - 0.5]], np.float32)
        disp = rng.integers(-16, 17, (2, D, H, OW)) / 4.0
    return (D, H, S), OW, coefs.astype(np.float32), disp.astype(np.float32)


@pytest.mark.parametrize("kind", ["ly", "lz", "x", "half", "saturate", "ow", "reverse"])
def test_hat_pair_ref_matches_jax(kind):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    (D, H, S), OW, coefs, disp = _case(kind, rng)
    xa = rng.random((2, D, H, S), np.float32)
    xb = rng.integers(0, 8, (2, D, H, S)).astype(np.float32)
    oa, ob = hat.hat_pass_pair(
        torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(coefs),
        torch.from_numpy(disp),
    )
    assert oa.shape == ob.shape == (2, D, H, OW)
    for b in range(2):
        ja, jb = _jax_pair(xa[b], xb[b], coefs[b], disp[b], (D, H, S), OW=OW)
        np.testing.assert_allclose(oa[b].numpy(), ja, **IMG_TOL)
        np.testing.assert_array_equal(ob[b].numpy(), jb)


def test_half_integer_rounds_to_even():
    """Nearest mode at exact half-integer positions picks the even index."""
    S = 8
    x = torch.arange(S, dtype=torch.float32).expand(1, 1, 1, S).contiguous()
    disp = torch.full((1, 1, 1, S), 0.5)
    coefs = torch.tensor([[0.0, 0.0, 1.0, 0.0]])
    _, ob = hat.hat_pass_pair(x, x, coefs, disp)
    # pos = l + 0.5 -> even neighbour; l = 7 saturates at S - 1
    assert ob.flatten().tolist() == [0, 2, 2, 4, 4, 6, 6, 7]


@pytest.fixture
def interpret_kernels():
    old = W._INTERPRET
    W._INTERPRET = True
    yield
    W._INTERPRET = old


def test_hat_pair_ref_matches_pallas_interpret(interpret_kernels):
    """The Pallas kernel (interpreter mode) at a ``_v1_ok`` main-path geometry."""
    D, H, S = 4, 64, 128
    assert W._v1_ok(D * H, S, S, H, W.MAXSPAN_FIELD)
    rng = np.random.default_rng(11)
    xa = rng.random((D, H, S), np.float32)
    xb = rng.integers(0, 8, (D, H, S)).astype(np.float32)
    disp = rng.uniform(-W.FIELD_LIM, W.FIELD_LIM, (D, H, S)).astype(np.float32)
    coefs = np.array([0.3125, 0.0, 1.0, 0.0], np.float32)
    ja, jb = _jax_pair(
        xa, xb, coefs, disp, (D, H, S), unit_slope=True, tap_chunk=W.FIELD_TAP_CHUNK,
    )
    oa, ob = hat.hat_pass_pair(
        torch.from_numpy(xa[None]), torch.from_numpy(xb[None]),
        torch.from_numpy(coefs[None]), torch.from_numpy(disp[None]),
    )
    np.testing.assert_array_equal(ob[0].numpy(), jb)
    np.testing.assert_allclose(oa[0].numpy(), ja, **IMG_TOL)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        hat.hat_pass_pair(x, x, torch.zeros((1, 4), device="meta"), x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        hat.hat_pass(x, torch.zeros((1, 4), device="meta"))


def _bad_inputs(case):
    """(x, others, coefs, disp, ow_free) of a launch the wrappers' check
    refuses, one fault per ``case``."""
    x = torch.zeros((2, 3, 4, 8))
    coefs = torch.zeros((2, 4))
    return {
        "operand shape": (x, (torch.zeros((2, 3, 4, 9)),), coefs, None, True),
        "three-axis x": (x[0], (), coefs, None, False),
        "disp lanes": (x, (), coefs, torch.zeros((2, 3, 4, 9)), False),
        "disp rows": (x, (), coefs, torch.zeros((2, 3, 5, 8)), True),
        "table lead": (x, (), coefs, torch.zeros((2, 4, 8)), False),
        "coefs": (x, (), torch.zeros((3, 4)), None, False),
        "slice coefs": (x, (), torch.zeros((2, 4, 4)), None, False),
        "short rows": (torch.zeros((2, 3, 4, 1)), (), coefs, None, False),
        "long rows": (torch.zeros((1, 1, 1, 6145)), (), coefs[:1], None, False),
        "dtype": (x.double(), (), coefs, None, False),
        "coefs dtype": (x, (), coefs.double(), None, False),
        "disp device": (x, (), coefs, torch.zeros((2, 3, 4, 8), device="meta"), False),
        "strides": (x.transpose(1, 2).contiguous().transpose(1, 2), (), coefs, None, False),
        "operand strides": (x, (x.transpose(2, 3).contiguous().transpose(2, 3),), coefs, None, True),
    }[case]


_BAD = {
    "operand shape": (ValueError, "volumes must be equal"), "three-axis x": (ValueError, "volumes must be equal"),
    "disp lanes": (ValueError, r"disp must be \(B, D, H, 8\)"), "disp rows": (ValueError, r"disp must be \(B, D, H, OW\)"),
    "table lead": (ValueError, "disp must be"), "coefs": (ValueError, r"coefs must be \(2, 4\) or \(2, 3, 4\)"),
    "slice coefs": (ValueError, "coefs must be"), "short rows": (ValueError, "S=1 outside"),
    "long rows": (ValueError, "S=6145 outside"), "dtype": (TypeError, "x must be float32"),
    "coefs dtype": (TypeError, "coefs must be float32"), "disp device": (ValueError, "disp is on meta"),
    "strides": (ValueError, "x must be contiguous"), "operand strides": (ValueError, "operand 2 must be contiguous"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_wrapper_check_refuses(case):
    """The CUDA wrappers' check (``kernels.hat._check``) reads only shapes,
    dtypes, devices and strides, so it runs on CPU tensors: each fault is
    refused with its own message."""
    err, msg = _BAD[case]
    with pytest.raises(err, match=msg):
        hat._check(*_bad_inputs(case))


def test_wrapper_check_accepts_every_form():
    """The check passes each form a kernel has, and ``_form`` names the
    instantiated forms for one that has none."""
    x = torch.zeros((2, 3, 4, 8))
    per_sample, per_slice = torch.zeros((2, 4)), torch.zeros((2, 3, 4))
    volume, table = torch.zeros((2, 3, 4, 8)), torch.zeros((2, 3, 8))
    for others, coefs, disp, ow_free in (((), per_sample, None, False), ((), per_sample, volume, False),
                                         ((), per_sample, table, False), ((), per_slice, None, False),
                                         ((x,), per_sample, torch.zeros((2, 3, 4, 5)), True),
                                         ((x,), per_sample, torch.zeros((2, 3, 12)), True)):
        assert hat._check(x, others, coefs, disp, ow_free) is None
    assert hat._form(True, per_sample, volume, hat._SINGLE_FORMS, "hat_pass") == (True, 0, 1)
    assert hat._form(False, per_slice, None, hat._SINGLE_FORMS, "hat_pass") == (False, 1, 0)
    with pytest.raises(ValueError, match="hat_pass: no kernel for .* = \\(True, 0, 2\\)"):
        hat._form(True, per_sample, table, hat._SINGLE_FORMS, "hat_pass")
    with pytest.raises(ValueError, match="no kernel"):
        hat._form(False, per_slice, volume, hat._SINGLE_FORMS, "hat_pass")


def _single_case(kind, rng):
    """(shape (D, H, S), coefs (2, 4), disp (2, D, H, S) or None) for K2."""
    D, H, S = 6, 10, 16
    disp = None
    if kind in ("u_z", "u_y", "u_x"):
        # the affine warp's U passes: (0, 0, U22, t2), (0, U12, U11, t1),
        # (U01, U02, U00, t0) with the deformation config's ranges
        diag = rng.uniform(0.9, 1.1, 2)
        off = rng.uniform(-0.5, 0.5, (2, 2))
        t = rng.uniform(-3, 3, 2)
        zero = np.zeros(2)
        rows = {"u_z": (zero, zero), "u_y": (zero, off[:, 0]), "u_x": (off[:, 0], off[:, 1])}[kind]
        coefs = np.stack([*rows, diag, t], 1)
    elif kind in ("l_y", "l_z"):
        L = rng.uniform(-0.5, 0.5, (2, 2))
        cj = L[:, 1] if kind == "l_z" else 0 * L[:, 1]
        coefs = np.stack([L[:, 0], cj, np.ones(2), np.zeros(2)], 1)
    elif kind == "field":
        coefs = np.stack([rng.uniform(-0.5, 0.5, 2), np.zeros(2), np.ones(2), np.zeros(2)], 1)
        disp = rng.uniform(-W.FIELD_LIM, W.FIELD_LIM, (2, D, H, S))
    elif kind == "half":
        # every position an exact half-integer: nearest rounds half to even
        coefs = np.array([[0, 0, 1, 0], [1, -1, 1, 0.5]])
        disp = rng.integers(-8, 9, (2, D, H, S)) + 0.5
    elif kind == "half_rows":
        # half-integers from the coefficients alone, no displacement
        coefs = np.array([[0.5, 0, 1, 0], [0.25, -0.5, 1, 0.5]])
    elif kind == "saturate":
        coefs = np.array([[0, 0, 1, 0], [0.5, 0.25, 1, -2]])
        disp = rng.choice([-(S + 3.0), -0.25, 0.0, 0.75, S - 1.0, S + 3.0], (2, D, H, S))
    coefs = coefs.astype(np.float32)
    return (D, H, S), coefs, None if disp is None else disp.astype(np.float32)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize(
    "kind", ["u_z", "u_y", "u_x", "l_y", "l_z", "field", "half", "half_rows", "saturate"]
)
def test_hat_single_ref_matches_jax(kind, nearest):
    rng = np.random.default_rng(zlib.crc32(f"single-{kind}".encode()))
    (D, H, S), coefs, disp = _single_case(kind, rng)
    x = rng.random((2, D, H, S), np.float32)
    if nearest:
        x = rng.integers(0, 8, (2, D, H, S)).astype(np.float32)
    out = hat.hat_pass(
        torch.from_numpy(x), torch.from_numpy(coefs),
        None if disp is None else torch.from_numpy(disp), nearest,
    )
    assert out.shape == (2, D, H, S)
    for b in range(2):
        ref = np.asarray(W.hat_pass(
            jnp.asarray(x[b]), tuple(np.float32(c) for c in coefs[b]),
            None if disp is None else jnp.asarray(disp[b]), (D, H, S), W.MAXSPAN_U, nearest,
        ))
        if nearest:
            np.testing.assert_array_equal(out[b].numpy(), ref)
        else:
            np.testing.assert_allclose(out[b].numpy(), ref, **IMG_TOL)


def test_hat_single_half_integer_rounds_to_even():
    """Nearest mode at exact half-integer positions picks the even index,
    with the half-integer from the bias alone (no displacement)."""
    S = 8
    x = torch.arange(S, dtype=torch.float32).expand(1, 1, 1, S).contiguous()
    out = hat.hat_pass(x, torch.tensor([[0.0, 0.0, 1.0, 0.5]]), nearest=True)
    assert out.flatten().tolist() == [0, 2, 2, 4, 4, 6, 6, 7]
    lin = hat.hat_pass(x, torch.tensor([[0.0, 0.0, 1.0, 0.5]]))
    assert lin.flatten().tolist() == [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.0]


def _smooth(rng, shape, scale):
    """A smooth random f32 volume in [0, scale]."""
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.random(shape), 2.0)
    return (scale * (x - x.min()) / (x.max() - x.min())).astype(np.float32)


@pytest.fixture(scope="module")
def scanner_tables():
    """One stack's pass tables from the scanner's real geometry
    (``scanner_ab_case``: cube 128, ns_grid 32, recorded motion): the
    acquisition's lane-affine dz table and per-slice dv/du tables, the
    reconstruction's per-slice inverse tables and its lane-affine slice-axis
    table padded to 128 lanes."""
    from fetalsyngen_torch.generator.artifacts import scanner as sc
    from fetalsyngen_torch.testing import scanner_ab_case

    case = scanner_ab_case(128, 32)
    cube, ns_grid = 128, 32
    c_ss = (cube - 1) / 2.0
    G = torch.from_numpy(case["geo"]["G"])
    rs, gap, z0 = (sc._f32(case[k]) for k in ("rs", "gap_vox", "z0"))
    dz, dv, du = sc._slice_coef_tables(G, rs, c_ss, z0, gap, ns_grid)
    dz_tab = sc._dz_lane_table(dz, rs, c_ss, z0, gap, cube, ns_grid)
    idv, idu = sc._inplane_coef_tables(G, rs, c_ss, -1.0)
    dzr = sc._dzr_lane_table(G, rs, c_ss, z0, gap, ns_grid)
    assert dzr.shape == (3, 128) and not dzr[:, ns_grid:].any()
    return dict(dz=dz_tab, dv=dv, du=du, idv=idv, idu=idu, dzr=dzr, cube=cube, ns_grid=ns_grid)


@pytest.mark.parametrize("form", ["acquire_dz", "acquire_dv", "acquire_du", "recon_dz"])
def test_hat_pair_scanner_forms_match_jax(scanner_tables, form):
    """K1's (linear, linear) forms at the scanner's geometries: lane-affine
    with unit coefficients, and per-slice coefficients without a
    displacement (JAX runs each as two single passes). The operands are
    smooth, as the scanner's PSF-blurred volumes are: XLA contracts the
    position polynomial into FMAs where the port does not, and an ulp of
    position times a white-noise row's jumps would exceed the bar."""
    t = scanner_tables
    cube, ns = t["cube"], t["ns_grid"]
    shape = {"acquire_dz": (cube, cube, cube), "recon_dz": (cube, cube, 128)}.get(form, (ns, cube, cube))
    rng = np.random.default_rng(zlib.crc32(form.encode()))
    xa, xb = (_smooth(rng, shape, s) for s in (100.0, 1.0))
    if form.endswith("_dz"):
        tab = t["dz"] if form == "acquire_dz" else t["dzr"]
        coefs, disp = torch.tensor([[0.0, 0.0, 1.0, 0.0]]), tab[None].contiguous()
        jc, jd = (0.0, 0.0, 1.0, 0.0), jnp.asarray(tab.numpy())
    else:
        coefs, disp = t[form[-2:]][None].contiguous(), None
        jc, jd = jnp.asarray(coefs[0].numpy()), None
    oa, ob = hat.hat_pass_pair(torch.from_numpy(xa[None]), torch.from_numpy(xb[None]), coefs, disp, nearest_b=False)
    ja, jb = W.hat_pass_pair(jnp.asarray(xa), jnp.asarray(xb), jc, jd, shape, 128,
                             modes=(False, False), unit_slope=True)
    pos = hat._positions_of(coefs, 1, shape[0], shape[1], shape[2], disp)
    assert bool(((pos > 0) & (pos < shape[2] - 1)).any()) and bool((pos - torch.floor(pos) > 0).any())
    np.testing.assert_allclose(oa[0].numpy(), np.asarray(ja), rtol=0, atol=1e-5 * 100)
    np.testing.assert_allclose(ob[0].numpy(), np.asarray(jb), rtol=0, atol=1e-5)


@pytest.mark.parametrize("table", ["idu", "idv"])
def test_hat_single_scanner_forms_match_jax(scanner_tables, table):
    """K2's per-slice linear form at the reconstruction's in-plane passes."""
    t = scanner_tables
    shape = (t["ns_grid"], t["cube"], t["cube"])
    x = _smooth(np.random.default_rng(len(table)), shape, 100.0)
    coefs = t[table][None].contiguous()
    out = hat.hat_pass(torch.from_numpy(x[None]), coefs)
    ref = W.hat_pass(jnp.asarray(x), jnp.asarray(coefs[0].numpy()), None, shape, 128, False, unit_slope=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=0, atol=1e-5 * 100)


def test_lane_affine_and_per_slice_positions():
    """The plain positions of the new forms on exact binary fractions: the
    per-slice row of slice row_i, the lane-affine table added in JAX's
    association order."""
    D, H, OW = 3, 4, 5
    coefs = torch.tensor([[[0.0, 0.5, 1.0, 0.25], [0.0, -0.5, 1.0, 1.0], [0.0, 0.25, 0.5, 0.0]]])
    pos = hat.positions(coefs, D * H, H, OW)
    i, j, l = 2, 3, 4
    assert float(pos[0, i * H + j, l]) == 0.25 * j + 0.5 * l
    tab = torch.tensor([[[0.5] * OW, [-0.25] * OW, list(range(OW))]], dtype=torch.float32)
    pos = hat.positions(torch.tensor([[0.0, 0.0, 1.0, 0.0]]), D * H, H, OW, lane=tab)
    assert float(pos[0, i * H + j, l]) == l + (0.5 * i - 0.25 * j + l)


def test_hat_single_lane_affine_matches_jax():
    """K2's lane-affine linear form (a (B, 3, S) table) against JAX
    ``hat_pass`` with a (3, S) displacement, which takes ``_hat_pass_jnp``
    on the CPU. Smooth operands: XLA contracts the position polynomial into
    FMAs where the port does not (see the scanner forms above)."""
    D, H, S = 8, 12, 40
    rng = np.random.default_rng(7)
    x = _smooth(rng, (2, D, H, S), 100.0)
    coefs = np.array([[0.11, 0.07, 1.0, 0.3], [0.05, -0.1, 1.08, -3.0]], np.float32)
    table = (rng.normal(0, [[0.3], [0.3], [2.0]], (2, 3, S))).astype(np.float32)
    out = hat.hat_pass(torch.from_numpy(x), torch.from_numpy(coefs), torch.from_numpy(table))
    pos = hat.positions(torch.from_numpy(coefs), D * H, H, S, lane=torch.from_numpy(table))
    assert bool((pos <= 0).any()) and bool((pos >= S - 1).any())
    for b in range(2):
        ref = W.hat_pass(jnp.asarray(x[b]), tuple(np.float32(c) for c in coefs[b]), jnp.asarray(table[b]),
                         (D, H, S), W.MAXSPAN_U, False)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), rtol=0, atol=1e-5 * 100)


@pytest.mark.parametrize("coefs", [(0.11, 0.07, 1.0, 0.3), (0.05, 0.1, 1.08, -9.0), (0.25, -0.5, 1.0, 0.5)])
def test_hat_pair_nodisp_matches_jax(coefs):
    """K1's per-sample form without a displacement (linear image, nearest
    labels) against JAX ``hat_pass_pair(..., None, ...)``: the kernel
    probes' ``pair_l_nodisp`` and ``pair_u`` coefficients, and dyadic ones
    that put every position of odd rows on a half-integer. The image is
    smooth and held within 1e-5 of its scale; labels are exact wherever
    the position is not within 1e-4 of a half-integer (an FMA-contracted
    position can round the other way there)."""
    D, H, S = 8, 12, 40
    rng = np.random.default_rng(int(1000 * coefs[0]))
    xa = _smooth(rng, (D, H, S), 100.0)
    xb = np.floor(_smooth(rng, (D, H, S), 7.99)).astype(np.float32)
    c = np.array(coefs, np.float32)
    oa, ob = hat.hat_pass_pair(torch.from_numpy(xa[None]), torch.from_numpy(xb[None]), torch.from_numpy(c[None]), None)
    ja, jb = W.hat_pass_pair(jnp.asarray(xa), jnp.asarray(xb), tuple(c), None, (D, H, S), W.MAXSPAN_U)
    np.testing.assert_allclose(oa[0].numpy(), np.asarray(ja), rtol=0, atol=1e-5 * 100)
    r = np.arange(D * H)
    pos = (c[0] * (r // H) + c[1] * (r % H))[:, None].astype(np.float64) + c[2] * np.arange(S) + c[3]
    near_half = (np.abs(pos - np.floor(pos) - 0.5) < 1e-4).reshape(D, H, S)
    if coefs[0] == 0.25:
        assert near_half.sum() > 100
    np.testing.assert_array_equal(ob[0].numpy()[~near_half], np.asarray(jb)[~near_half])
    if coefs[0] == 0.25:  # exact products: the halves round to even in both
        np.testing.assert_array_equal(ob[0].numpy(), np.asarray(jb))
