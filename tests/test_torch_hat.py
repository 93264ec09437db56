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
