"""Kernel probes: the port's plain versions against the TPU probes.

``fetalsyngen_torch.kernels.probes`` holds the plain versions of K3-K7 (the
CUDA kernels' references, and the wrappers' CPU paths). Each is held here
against the Pallas kernel of its script run with ``interpret=True`` at a
small size:

- K5/K6 (``scripts/probe_blocktp.py``) and K7 (``make_kernel(v)`` of
  ``scripts/profile_kernel_variants.py``) are imported from the scripts.
  Importing them sets ``jax_compilation_cache_dir``; the fixture restores it.
- K3 and K4 are nested in ``main()`` of ``scripts/microbench_warp.py`` and
  cannot be imported; their bodies are copied below.

Tolerances: copies, staging, transposes and window reads are exact. A tap
sum is held within 1e-6 of the data's range: XLA contracts ``acc + w * x``
(and products in the position) into FMAs where the port rounds each
operation, which moves a result by an ulp of the sum, or by an ulp of the
position times the step between neighbouring values. K7's table and
coefficients are dyadic, so its positions are exact products and only the
sum rounds differently; K3's and K4's positions are not, so their rows are
smooth (neighbours differ by at most 0.01).
"""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import fetalsyngen_tpu.ops.warp as W
from fetalsyngen_torch.kernels import probes

REPO = Path(__file__).resolve().parent.parent
TAP_TOL = dict(rtol=0, atol=1e-6)  # times the data's range, which is 1 here

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scripts():
    """The three probe scripts, imported from their files; the JAX
    compilation cache directory they set is restored right after."""
    old = jax.config.jax_compilation_cache_dir
    mods = {}
    try:
        for name in ("microbench_warp", "probe_blocktp", "profile_kernel_variants"):
            spec = importlib.util.spec_from_file_location(f"_probe_{name}", REPO / "scripts" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    return mods


def _smooth_rows(rng, shape):
    """Rows in [0, 1] whose neighbours differ by at most 0.01."""
    k = np.arange(shape[-1])
    phase = rng.uniform(0, 2 * np.pi, shape[:-1] + (1,))
    return (0.5 + 0.5 * np.sin(0.02 * k + phase)).astype(np.float32)


def _spec(block, index):
    return pl.BlockSpec(block, index, memory_space=pltpu.VMEM)


# --- K5, K6 -------------------------------------------------------------------


def test_pair_copy_matches_pallas(scripts):
    """K5: ``_copy_kernel`` with ``pallas_copy``'s specs (probe_blocktp.py:40-54)."""
    m = scripts["probe_blocktp"]
    R, Wd, BR = 256, 128, 128
    rng = np.random.default_rng(0)
    xa, xb = (rng.normal(size=(R, Wd)).astype(np.float32) for _ in range(2))
    spec = _spec((BR, Wd), lambda r: (r, 0))
    ja, jb = pl.pallas_call(
        m._copy_kernel, out_shape=(jax.ShapeDtypeStruct((R, Wd), jnp.float32),) * 2,
        grid=(R // BR,), in_specs=[spec, spec], out_specs=(spec, spec), interpret=True,
    )(xa, xb)
    oa, ob = probes.pair_copy(torch.from_numpy(xa), torch.from_numpy(xb))
    np.testing.assert_array_equal(oa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ob.numpy(), np.asarray(jb))


def test_pair_transpose_matches_pallas(scripts):
    """K6: ``_tp_kernel`` with ``pallas_tp``'s specs (probe_blocktp.py:57-77)
    on a 256-row pair: (i, j, k) -> (i, k, j)."""
    m = scripts["probe_blocktp"]
    D, H, Wd, BR = 2, 128, 128, 64
    R, jpb = D * H, H // BR
    rng = np.random.default_rng(1)
    xa, xb = (rng.normal(size=(D, H, Wd)).astype(np.float32) for _ in range(2))
    in_spec = _spec((BR, Wd), lambda r: (r, 0))
    out_spec = _spec((Wd, BR), lambda r: (r // jpb, r % jpb))
    ja, jb = pl.pallas_call(
        m._tp_kernel, out_shape=(jax.ShapeDtypeStruct((D * Wd, H), jnp.float32),) * 2,
        grid=(R // BR,), in_specs=[in_spec, in_spec], out_specs=(out_spec, out_spec), interpret=True,
    )(xa.reshape(R, Wd), xb.reshape(R, Wd))
    oa, ob = probes.pair_transpose(torch.from_numpy(xa), torch.from_numpy(xb))
    np.testing.assert_array_equal(oa.numpy(), np.asarray(ja).reshape(D, Wd, H))
    np.testing.assert_array_equal(ob.numpy(), np.asarray(jb).reshape(D, Wd, H))
    np.testing.assert_array_equal(oa.numpy(), xa.transpose(0, 2, 1))


# --- K7 -------------------------------------------------------------------------


def _run_variant(m, variant, x2d, coefs, disp):
    """``run_variant`` (profile_kernel_variants.py:110-127) with interpret=True."""
    R = x2d.shape[0]
    return pl.pallas_call(
        m.make_kernel(variant),
        out_shape=jax.ShapeDtypeStruct((R, m.LB), jnp.float32),
        grid=(R // m.B,),
        in_specs=[
            pl.BlockSpec((1, 1, 4), lambda r: (0, 0, 0), memory_space=pltpu.SMEM),
            _spec((m.B, m.S), lambda r: (r, 0)),
            _spec((3, m.LB), lambda r: (0, 0)),
        ],
        out_specs=_spec((m.B, m.LB), lambda r: (r, 0)),
        scratch_shapes=[pltpu.VMEM((m.B, m.LB), jnp.float32), pltpu.VMEM((m.B, m.WIDTH), jnp.float32)],
        interpret=True,
    )(coefs, x2d, disp)


# (H, coefficients, table scale, rows): the script's case; a slice boundary
# (row_i 0..3) with general dyadic coefficients; a table wide enough to
# saturate rows at both edges and to reach the span budget
K7_CASES = {
    "script": (384, (0.0, 0.0, 1.0, 0.3), 0.02, 64),
    "slices": (32, (0.25, -0.125, 1.0, 0.3), 0.02, 128),
    "wide": (384, (0.0, 0.0, 1.0, 0.3), 0.5, 128),
}


@pytest.mark.parametrize("variant", probes.VARIANTS)
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_hat_variant_matches_pallas(scripts, monkeypatch, case, variant):
    """K7: every variant of ``make_kernel`` at the script's S = 384. The
    table is the script's normal draw rounded to multiples of 2^-12."""
    m = scripts["profile_kernel_variants"]
    H, coefs, scale, R = K7_CASES[case]
    monkeypatch.setattr(m, "H", H)
    rng = np.random.default_rng(variant + 10 * len(case))
    x2d = rng.random((R, m.S), np.float32)
    table = (np.round(rng.normal(0, scale, (3, m.LB)) * 4096) / 4096).astype(np.float32)
    c = np.array(coefs, np.float32)
    want = np.asarray(_run_variant(m, f"v{variant}", x2d, c[None, None], table))
    got = probes.hat_variant(torch.from_numpy(x2d.reshape(R // H or 1, min(R, H), m.S)),
                             torch.from_numpy(c), torch.from_numpy(table), variant)
    np.testing.assert_allclose(got.numpy().reshape(R, m.S), want, **TAP_TOL)
    *_, sat_lo, sat_hi, n0, span = probes.variant_geometry(
        torch.from_numpy(c), torch.from_numpy(table), variant, max(R // H, 1), min(R, H), m.S)
    if case == "wide":
        assert bool(sat_lo.any()) and bool(sat_hi.any())
        if variant in (0, 1, 2):
            assert int(span.max()) > 48


# --- K3: copied from scripts/microbench_warp.py:198-232 (the probe2_* body) ----


def _k3_call(S, BR, mode, ntaps):
    """The ``probe2_*`` pallas_call of microbench_warp.py:183-253 for one
    (R, S) pair, LB = 256 = S, with interpret=True."""
    LB = 256
    pad, width, WIN = W._win_geometry(S, LB)

    def probe_kernel(xa_ref, xb_ref, oa_ref, ob_ref, sa_ref, sb_ref, *, mode):
        if mode == "copy":
            oa_ref[:] = xa_ref[:] * 2.0
            ob_ref[:] = xb_ref[:] * 2.0
            return
        for x_ref, s_ref in ((xa_ref, sa_ref), (xb_ref, sb_ref)):
            xf = x_ref[:]
            s_ref[:, pad : pad + S] = xf
            s_ref[:, :pad] = jnp.broadcast_to(xf[:, :1], (BR, pad))
            s_ref[:, pad + S :] = jnp.broadcast_to(xf[:, S - 1 : S], (BR, width - pad - S))
        if mode == "stage":
            oa_ref[:] = sa_ref[:, pad : pad + S]
            ob_ref[:] = sb_ref[:, pad : pad + S]
            return
        r_blk = pl.program_id(0)
        rows = r_blk * BR + jax.lax.broadcasted_iota(jnp.int32, (BR, LB), 0)
        row_j = (rows % S).astype(jnp.float32)
        lanes_f = jax.lax.broadcasted_iota(jnp.int32, (BR, LB), 1).astype(jnp.float32)
        pos = 0.07 * row_j + lanes_f + 0.3
        n0 = jnp.int32(-1)
        base = pad + n0
        q = base // 128
        off = base - q * 128
        wa = sa_ref[:, pl.ds(pl.multiple_of(q * 128, 128), WIN)]
        wb = sb_ref[:, pl.ds(pl.multiple_of(q * 128, 128), WIN)]
        d0 = pos - lanes_f - n0.astype(jnp.float32) + off.astype(jnp.float32)
        acc_a = jnp.zeros((BR, LB), jnp.float32)
        acc_b = jnp.zeros((BR, LB), jnp.float32)
        for m in range(ntaps):
            wgt = jnp.maximum(0.0, 1.0 - jnp.abs(d0 - float(m)))
            acc_a = acc_a + wgt * wa[:, m : m + LB]
            acc_b = acc_b + wgt * wb[:, m : m + LB]
        oa_ref[:] = acc_a
        ob_ref[:] = acc_b

    def call(xa, xb):
        R = xa.shape[0]
        spec = _spec((BR, S), lambda r: (r, 0))
        return pl.pallas_call(
            lambda *refs: probe_kernel(*refs, mode=mode),
            out_shape=(jax.ShapeDtypeStruct((R, S), jnp.float32),) * 2,
            grid=(R // BR,), in_specs=[spec, spec], out_specs=(spec, spec),
            scratch_shapes=[pltpu.VMEM((BR, width), jnp.float32)] * 2,
            interpret=True,
        )(xa, xb)

    return call


# taps148: the TPU probe reads its window at the 128-aligned floor of pad +
# n0 = 255 and adds the remainder 127 to the tap position, so its taps m
# cover window offsets m - 127; the port's taps m cover offsets m from pad
# + n0 itself. Nonzero taps sit at offsets floor(rel + 1) and the next, in
# [1, 20] for rel = 0.07*row_j + 0.3 <= 18.15; 148 taps put them inside both
# windows ([-127, 20] and [0, 147]), where the two definitions agree.
@pytest.mark.parametrize("mode", ["copy", "stage", "taps148"])
def test_probe2_matches_pallas(mode):
    """K3 at R = 2 blocks of 128 rows, S = 256 (row_j = 0..255)."""
    S, BR = 256, 128
    ntaps = int(mode[4:]) if mode.startswith("taps") else 0
    rng = np.random.default_rng(len(mode))
    xa, xb = (_smooth_rows(rng, (2 * BR, S)) for _ in range(2))
    ja, jb = _k3_call(S, BR, re.sub(r"\d+", "", mode), ntaps)(xa, xb)
    oa, ob = probes.probe2(torch.from_numpy(xa[None, None]), torch.from_numpy(xb[None, None]),
                           re.sub(r"\d+", "", mode), ntaps)
    for got, want in ((oa, ja), (ob, jb)):
        want = np.asarray(want)
        if mode.startswith("taps"):
            assert np.abs(want).max() > 0.1
            np.testing.assert_allclose(got[0, 0].numpy(), want, **TAP_TOL)
        else:
            np.testing.assert_array_equal(got[0, 0].numpy(), want)


def test_probe2_taps_outside_the_window_is_zero():
    """With 8 taps the TPU probe's window (offsets -127..-120) holds no
    nonzero tap and returns zeros; the port's (offsets 0..7) samples the rows
    where rel + 1 < 7."""
    x = torch.from_numpy(_smooth_rows(np.random.default_rng(3), (1, 1, 256, 256)))
    out, _ = probes.probe2(x, x, "taps", 8)
    rel = 0.07 * np.arange(256) + 0.3
    near = rel + 1 < 6
    assert bool((out[0, 0, near] != 0).all()) and not bool(out[0, 0, rel > 8].any())


# --- K4: copied from scripts/microbench_warp.py:272-321 (the probe_* body) ----


def _k4_call(S, mode):
    """The ``probe_*`` pallas_call of microbench_warp.py:261-331 with BR =
    BLOCK_ROWS (warp.py:136), SUBR = 8 and PAD = warp.PAD (the script's
    ``W.BIG_ROWS`` and ``W.SUB`` no longer exist), with interpret=True."""
    BR, SUBR, PAD = W.BLOCK_ROWS, 8, W.PAD
    width = S + 2 * PAD + 128

    def probe_kernel(x_ref, o_ref, s_ref, *, mode):
        if mode == "copy":
            o_ref[:] = x_ref[:] * 2.0
            return
        s_ref[:, PAD : PAD + S] = x_ref[:]
        s_ref[:, :PAD] = jnp.broadcast_to(x_ref[:, :1], (BR, PAD))
        s_ref[:, PAD + S :] = jnp.broadcast_to(x_ref[:, S - 1 : S], (BR, width - PAD - S))
        if mode == "stage":
            o_ref[:] = s_ref[:, PAD : PAD + S]
            return
        n_lane = S // 128
        n_tiles = (BR // SUBR) * n_lane

        def tile(ti, c):
            si = ti // n_lane
            h = ti - si * n_lane
            row0 = pl.multiple_of(si * SUBR, SUBR)
            lane0 = pl.multiple_of(h * 128, 128)
            pos = (
                0.11 * jax.lax.broadcasted_iota(jnp.float32, (SUBR, 128), 0)
                + (lane0 + jax.lax.broadcasted_iota(jnp.int32, (SUBR, 128), 1)).astype(jnp.float32)
            )
            n0 = jnp.floor(jnp.min(pos - pos)).astype(jnp.int32)  # 0, but traced
            base = jnp.clip(PAD + lane0 + n0, 0, width - 384)
            q = base // 128
            off = base - q * 128
            win = s_ref[pl.ds(row0, SUBR), pl.ds(pl.multiple_of(q * 128, 128), 384)]
            if mode == "ladder":
                for b in range(7):
                    bit = ((off >> b) & 1) == 1
                    win = jnp.where(bit, pltpu.roll(win, 384 - (1 << b), 1), win)
                acc = win[:, 0:128]
            elif mode == "tiles":
                acc = win[:, 0:128] + 0.0 * pos
            else:  # sweep12: ladder + 12 taps
                for b in range(7):
                    bit = ((off >> b) & 1) == 1
                    win = jnp.where(bit, pltpu.roll(win, 384 - (1 << b), 1), win)
                d0 = pos - jnp.floor(pos)
                acc = jnp.zeros((SUBR, 128), jnp.float32)
                for m in range(12):
                    acc = acc + jnp.maximum(0.0, 1.0 - jnp.abs(d0 - float(m))) * win[:, m : m + 128]
            o_ref[pl.ds(row0, SUBR), pl.ds(lane0, 128)] = acc
            return c

        jax.lax.fori_loop(0, n_tiles, tile, 0)

    def call(x):
        R = x.shape[0]
        spec = _spec((BR, S), lambda r: (r, 0))
        return pl.pallas_call(
            lambda *refs: probe_kernel(*refs, mode=mode),
            out_shape=jax.ShapeDtypeStruct((R, S), jnp.float32),
            grid=(R // BR,), in_specs=[spec], out_specs=spec,
            scratch_shapes=[pltpu.VMEM((BR, width), jnp.float32)],
            interpret=True,
        )(x)

    return call


@pytest.mark.parametrize("mode", probes.SINGLE_MODES)
def test_probe_matches_pallas(mode):
    """K4 at R = 2 blocks of 64 rows, S = 256 (two 128-lane tiles)."""
    S = 256
    x = _smooth_rows(np.random.default_rng(len(mode)), (2 * W.BLOCK_ROWS, S))
    want = np.asarray(_k4_call(S, mode)(x))
    got = probes.probe(torch.from_numpy(x[None, None]), mode)[0, 0].numpy()
    if mode == "sweep12":
        np.testing.assert_allclose(got, want, **TAP_TOL)
        assert not np.array_equal(got, x)  # the sub-row fractions move it
    else:
        np.testing.assert_array_equal(got, want)


# --- K3's and K4's plain versions against numpy, at the GPU tests' odd shapes ---


ODD_ROWS = [(1, 3, 7), (2, 1, 1), (1, 5, 67)]  # (B, D, H): no whole tile, one row a volume, a partial tile


def _odd_data(shape, seed):
    """Normal f32 draws with -0.0 at every 7th element."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::7] = -0.0
    return x


def _np_taps(xr, idx, d0, ntaps):
    """sum over m < ntaps of max(0, 1 - |d0 - m|) * xr[..., clamp(idx + m)], in
    tap order; ``xr`` (B, R, S), ``idx`` and ``d0`` (R, S)."""
    S = xr.shape[-1]
    acc = np.zeros(xr.shape, np.float32)
    for m in range(ntaps):
        w = np.maximum(np.float32(0), np.float32(1) - np.abs(d0 - np.float32(m)))
        acc = acc + w * np.take_along_axis(xr, np.broadcast_to(np.clip(idx + m, 0, S - 1), xr.shape), axis=2)
    return acc


def _np_probe2(x, mode, ntaps):
    """K3 on one (B, D, H, S) operand: 2x, the row, or its taps at pos =
    (0.07*row_j + l) + 0.3 from n0 = -1 with the edge lanes clamped."""
    if mode == "copy":
        return x * np.float32(2)
    if mode == "stage":
        return x.copy()
    B, D, H, S = x.shape
    R = D * H
    rj = (np.arange(R) % H).astype(np.float32)[:, None]
    lanes = np.arange(S, dtype=np.float32)[None, :]
    pos = (np.float32(0.07) * rj + lanes) + np.float32(0.3)
    d0 = (pos - lanes) - np.float32(-1)
    idx = np.broadcast_to(np.arange(S) - 1, (R, S))
    return _np_taps(x.reshape(B, R, S), idx, d0, ntaps).reshape(x.shape)


def _np_probe(x, mode):
    """K4: 2x, the row, or reads of the TPU's padded row, padded[c] =
    x[clamp(c - 128)], at the window of pos = 0.11*(r % 8) + l."""
    if mode == "copy":
        return x * np.float32(2)
    if mode == "stage":
        return x.copy()
    B, D, H, S = x.shape
    R = D * H
    xr = x.reshape(B, R, S)
    sub = (np.arange(R) % 8).astype(np.float32)[:, None]
    lanes = np.broadcast_to(np.arange(S), (R, S))
    pos = np.float32(0.11) * sub + lanes.astype(np.float32)
    n0 = np.floor(pos - pos).astype(np.int64)
    lane0 = lanes // 128 * 128
    base = np.clip(128 + lane0 + n0, 0, S)  # the window's last start, width - 384, is S

    def padded(c):
        return np.take_along_axis(xr, np.broadcast_to(np.clip(c - 128, 0, S - 1), xr.shape), axis=2)

    if mode == "ladder":
        out = padded(base + lanes - lane0)
    elif mode == "tiles":
        out = padded(base // 128 * 128 + lanes - lane0) + np.float32(0) * pos
    else:
        out = _np_taps(xr, base + lanes - lane0 - 128, pos - np.floor(pos), 12)
    return out.reshape(x.shape)


@pytest.mark.parametrize("S", [5, 16, 256, 300])
@pytest.mark.parametrize("rows", ODD_ROWS)
def test_probe2_ref_matches_numpy(rows, S):
    """``probe2_ref`` bit for bit (signs of zero included) against the numpy
    statement, every mode and tap count of the GPU test."""
    xa, xb = _odd_data((*rows, S), S), _odd_data((*rows, S), S + 1)
    for mode, ntaps in (("copy", 0), ("stage", 0), ("taps", 1), ("taps", 8), ("taps", 13), ("taps", S + 128)):
        got = probes.probe2_ref(torch.from_numpy(xa), torch.from_numpy(xb), mode, ntaps)
        for g, x in zip(got, (xa, xb)):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), _np_probe2(x, mode, ntaps).view(np.uint32))


@pytest.mark.parametrize("S", [128, 384, 1024])
@pytest.mark.parametrize("rows", ODD_ROWS)
def test_probe_ref_matches_numpy(rows, S):
    """``probe_ref`` bit for bit against the numpy statement, every mode;
    stage keeps the inputs' -0.0, tiles' 0*pos turns it into +0."""
    x = _odd_data((*rows, S), S)
    for mode in probes.SINGLE_MODES:
        got = probes.probe_ref(torch.from_numpy(x), mode).numpy()
        want = _np_probe(x, mode)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        if mode in ("stage", "tiles"):
            assert np.signbit(want[want == 0]).any() == (mode == "stage")


def test_probe_wrappers_reject_other_devices():
    x = torch.zeros((1, 1, 2, 128), device="meta")
    for call in (lambda: probes.pair_copy(x, x), lambda: probes.pair_transpose(x, x),
                 lambda: probes.probe2(x, x, "copy"), lambda: probes.probe(x, "copy"),
                 lambda: probes.hat_variant(x[0], x[0, 0, 0, :4], x[0, 0, :, :], 0)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            call()


@pytest.mark.parametrize("case", ["shapes", "dtype", "strides", "devices", "aligned"])
def test_pair_copy_operands_refused(case):
    """K5's launch check runs on CPU tensors: equal shapes, f32, contiguous,
    one device, 16-byte aligned (a float's offset is 4 bytes off)."""
    x = torch.zeros((3, 5, 7))
    other, err, msg = {
        "shapes": (torch.zeros((3, 5, 8)), ValueError, "shapes .* differ"),
        "dtype": (x.double(), TypeError, "float32"),
        "strides": (x.transpose(0, 2).contiguous().transpose(0, 2), ValueError, "contiguous"),
        "devices": (torch.zeros((3, 5, 7), device="meta"), ValueError, "operands on meta and cpu"),
        "aligned": (torch.zeros(1 + 105)[1:].view(3, 5, 7), ValueError, "16-byte aligned"),
    }[case]
    with pytest.raises(err, match=msg):
        probes._copy_operands(x, other)


def test_pair_copy_operands_accepted():
    """Odd sizes pass K5's check as whole 16-byte units and a tail."""
    for n in (1, 3, 4, 105, 4099):
        assert probes._copy_operands(torch.zeros(n), torch.ones(n)) == divmod(n, 4)


def test_ring_profile_block_summary():
    """``ring_profile``'s reading of the ring blocks' records: end times from
    the first start, mean busy time, and the share of the walk waited."""
    from fetalsyngen_torch.probes import ring_profile

    rec = np.array([[1000, 6000, 10, 100], [3000, 9000, 30, 100], [2000, 4000, 20, 200]], dtype=np.uint64)
    s = ring_profile.block_summary(rec)
    assert s["ends_us"] == pytest.approx([3.0, 3.4, 5.0, 7.4, 8.0])
    assert s["spread"] == pytest.approx(5.0 / 8.0)
    assert s["busy_us"] == pytest.approx(13 / 3)
    assert s["wait"] == pytest.approx(60 / 400)


def test_bounds():
    """The least times the kernels are read against: bytes over 3.35 TB/s or
    f32 operations over 67 TFLOP/s, whichever is longer; a hat pass counts
    its operands, displacement, coefficients and outputs once each."""
    from fetalsyngen_torch.probes.timing import bound, hat_bound

    assert bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert bound(0, 67e9) == (pytest.approx(1.0), "operations")
    B, D, H, S = 1, 256, 256, 256
    n = B * D * H * S
    assert hat_bound(False, B, D, H, S, S) == (pytest.approx(1e3 * 4 * (2 * n + 4 * D) / 3.35e12), "bytes")
    vol, tab = torch.zeros((B, D, H, S)), torch.zeros((B, 3, S))
    assert hat_bound(False, B, D, H, S, S, vol, nearest=True)[0] == pytest.approx(1e3 * 4 * (3 * n + 4 * D) / 3.35e12)
    assert hat_bound(True, B, D, H, S, S, tab)[0] == pytest.approx(1e3 * 4 * (4 * n + 3 * S + 4 * D) / 3.35e12)


# --- the entry points, on the CPU at a tiny size --------------------------------


def _run(module, *args):
    r = subprocess.run([sys.executable, "-m", f"fetalsyngen_torch.probes.{module}", "--device", "cpu", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()


def test_microbench_warp_entry_point():
    lines = _run("microbench_warp", "--variant", "probe2_taps8", "--size", "16", "--batch", "2")
    assert lines == ["probe2_taps8: ran once on cpu, no time (B=2, 16^3)"]


def test_probe_blocktp_entry_point():
    lines = _run("probe_blocktp", "--size", "32", "--batch", "1")
    assert lines[0] == "pair_transpose correct"
    assert [ln.split()[0:2] for ln in lines[1:]] == [["pair", "copy"], ["pair", "tp_out"], ["torch", "transpose"]]
    assert all(ln.endswith("ran once on cpu, no time") for ln in lines[1:])


def test_profile_kernel_variants_entry_point():
    lines = _run("profile_kernel_variants", "--depth", "1")
    assert [ln.split()[0] for ln in lines] == ["v0", "v1", "v2", "v3", "v4", "hat_pass_lane"]
    assert all(ln.endswith("ran once on cpu, no time") for ln in lines)
