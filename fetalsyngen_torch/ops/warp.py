"""Separable affine + field warps (port of ``fetalsyngen_tpu.ops.warp``).

The affine map ``o -> A o + t`` factors as ``A = U L`` (upper x unit-lower),
so the warp runs as single-axis resampling passes with closed-form positions.

- The (image, labels) pair: passes without a displacement or a ``row_i``
  term go through :func:`row_affine_pass_pair`: on the card the two-tap
  kernel (:mod:`fetalsyngen_torch.kernels.row_affine`), on the CPU batched
  matmuls with a banded (B, J, K, S) operator
  (:func:`_row_affine_matmul_pair`); the three displacement-carrying passes
  go through the paired hat kernel
  (:func:`fetalsyngen_torch.kernels.hat.hat_pass_pair`).
- One volume (:func:`warp_affine_separable`,
  :func:`warp_affine_field_separable`, :func:`warp_displacement_separable`):
  every pass goes through the single-operand hat kernel
  (:func:`fetalsyngen_torch.kernels.hat.hat_pass`).
- A pair with per-operand modes (:func:`warp_affine_separable_pair`): five
  passes of the paired hat kernel without a displacement.
- The scanner's rigid maps of cube volumes (:func:`warp_rigid_pair_traced`
  with its host decompositions): a quarter turn, unit shears as batched
  matmuls (:func:`_shear_pass_pair_mm`) and a separable zoom, unbatched.

The affine warps may write another grid than the input's (``out_shape``):
the U passes resample to its lengths (``out_len``). Their ``maxspan``
argument is accepted and has no effect: it sized the TPU kernels' tap
window, and the port's kernels read their two taps directly.

The affine warps are batch-first, with per-sample scalars as (B,) tensors;
the rigid warps take one (D, H, W) volume or pair. The pass order, layouts
and coefficients are the JAX package's.

Under :func:`~fetalsyngen_torch.ops.linops.storage_scope` (the stream's
production mode) the matmul passes keep their intermediates in bf16
(``linops.einsum_store``) and the hat passes read and write bf16 rows (the
kernels' bf16 forms; positions and displacements stay f32), as the JAX
package's ``store`` threading does. The rigid warps' ``emit_f32`` marks
their last contraction as a segment boundary: f32 out, unless a scoped
caller keeps bf16 for a consumer that takes it.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..kernels import row_affine
from ..kernels.hat import hat_pass, hat_pass_pair
from .linops import (
    DEFAULT, axis_mm, current_precision, current_storage, einsum_store, interp_matrix_1d, io_dtype, prec_matmul,
)

# Displacement fields are clipped to +-FIELD_LIM voxels: ~3.5 sigma of the
# largest default nonlin_std (4.0), beyond the field's realizable range.
FIELD_LIM = 14.0


def ul_decompose(A: torch.Tensor):
    """Backward Doolittle ``A = U L`` of (B, 3, 3) affines; returns (U, L)."""
    A = A.to(torch.float32)
    u22 = A[:, 2, 2]
    l20 = A[:, 2, 0] / u22
    l21 = A[:, 2, 1] / u22
    u12 = A[:, 1, 2]
    u11 = A[:, 1, 1] - u12 * l21
    l10 = (A[:, 1, 0] - u12 * l20) / u11
    u02 = A[:, 0, 2]
    u01 = A[:, 0, 1] - u02 * l21
    u00 = A[:, 0, 0] - u01 * l10 - u02 * l20
    one, zero = torch.ones_like(u22), torch.zeros_like(u22)
    U = torch.stack(
        [torch.stack(r, -1) for r in ([u00, u01, u02], [zero, u11, u12], [zero, zero, u22])], -2
    )
    L = torch.stack(
        [torch.stack(r, -1) for r in ([one, zero, zero], [l10, one, zero], [l20, l21, one])], -2
    )
    return U, L


def _shear_matrices(J, S, amount, bias, c_fix, slope):
    """(B, J, S, S) banded per-row resampling operators
    ``M[b,j,k,s] = hat(pos(b,j,k) - s)`` with
    ``pos = slope*k + amount*(j - c_fix) + bias``, edge-clamped: the linear
    stack and the nearest stack. ``amount``, ``bias``, ``slope``: (B,).
    """
    dev = amount.device
    jj = torch.arange(J, dtype=torch.float32, device=dev)[None, :, None, None]
    kk = torch.arange(S, dtype=torch.float32, device=dev)[None, None, :, None]
    ss = torch.arange(S, dtype=torch.float32, device=dev)[None, None, None, :]

    def per_sample(v):
        return v.to(torch.float32)[:, None, None, None]

    pos = per_sample(slope) * kk + per_sample(amount) * (jj - c_fix) + per_sample(bias)
    pos = torch.clamp(pos, 0.0, S - 1.0)
    linear = torch.clamp_min(1.0 - torch.abs(pos - ss), 0.0)
    nearest = (torch.round(pos) == ss).to(torch.float32)
    return linear, nearest


def _as_batch(v, B, device) -> torch.Tensor:
    """A (B,) f32 tensor from a per-sample tensor or a Python scalar (filled
    on the device: no host copy, no stream sync)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).expand(B)
    return torch.full((B,), float(v), dtype=torch.float32, device=device)


def _row_affine_matmul_pair(xa, xb, slope, amount, bias, out_order="ijk"):
    """Resample the LAST axis of a (B, I, J, S) pair, ``xa`` linearly and
    ``xb`` nearest, at ``pos = slope*k + amount*row_j + bias``
    (row_j = middle-axis index) with one batched matmul per operand; same
    semantics as a hat pass whose position map has no displacement and no
    row_i term.

    The output axes follow ``out_order``, a permutation of "ijk" (k = the
    resampled axis); it folds the caller's next transpose into the einsum.
    Under the storage scope the operators and outputs are bf16 (the nearest
    operator's one-hot rows and small-integer labels are exact in bf16).
    """
    B, _, J, S = xa.shape
    dev = xa.device
    slope, amount, bias = (_as_batch(v, B, dev) for v in (slope, amount, bias))
    c_fix = (J - 1) / 2.0
    m_lin, m_near = _shear_matrices(J, S, amount, bias + amount * c_fix, c_fix, slope)
    spec = f"bjks,bijs->b{out_order}"
    return einsum_store(spec, m_lin, xa), einsum_store(spec, m_near, xb)


def row_affine_pass_pair(xa, xb, slope, amount, bias, out_order="ijk"):
    """:func:`_row_affine_matmul_pair` of any operand types (f32 or bf16
    images, integer labels). CPU tensors take it as it is, on the operands
    converted to f32; CUDA tensors launch the two-tap kernel
    (:func:`fetalsyngen_torch.kernels.row_affine.row_affine_pair`), which
    computes the same function without the operators and writes the
    output contiguous in ``out_order``, in the form of this thread's scopes:
    the storage scope's bf16 chain, else the precision scope's one bf16
    pass (the public ``precision_scope(DEFAULT)`` alone, which no path of the
    port enters by itself), else the f32 contract."""
    if xa.device.type == "cpu":
        return _row_affine_matmul_pair(xa.to(torch.float32), xb.to(torch.float32), slope, amount, bias, out_order)
    B, _, J, _ = xa.shape
    slope, amount, bias = (_as_batch(v, B, xa.device) for v in (slope, amount, bias))
    c_fix = (J - 1) / 2.0
    form = "bf16" if current_storage() is not None else ("default" if current_precision() == DEFAULT else "f32")
    coefs = torch.stack([slope, amount, bias + amount * c_fix], 1)
    return row_affine.row_affine_pair(xa, xb, coefs, out_order, form)


def _field_combos(L, Fx, Fy, Fz):
    """The L-mixed displacements of the field passes, clipped to
    +-FIELD_LIM, in (B, D, H, W) layout: (gx, gy, gz) with gy = L10*Fx + Fy
    and gz = L20*Fx + L21*Fy + Fz."""
    lim = FIELD_LIM

    def s(v):
        return v[:, None, None, None]

    gx = torch.clamp(Fx, -lim, lim)
    gy = torch.clamp(s(L[:, 1, 0]) * Fx + Fy, -lim, lim)
    gz = torch.clamp(s(L[:, 2, 0]) * Fx + s(L[:, 2, 1]) * Fy + Fz, -lim, lim)
    return gx, gy, gz


def warp_affine_field_pair(va, vb, A, t, Fx, Fy, Fz):
    """Affine + field warp of a (linear, nearest) pair from full-resolution
    (B, D, H, W) field components: forms the L-mixed displacement combos and
    transposes them into the pass layouts, then runs
    :func:`warp_affine_field_pair_pre`."""
    _, L = ul_decompose(A)
    gx, gy, gz = _field_combos(L, Fx, Fy, Fz)
    return warp_affine_field_pair_pre(va, vb, A, t, gy.permute(0, 1, 3, 2), gz, gx.permute(0, 2, 3, 1))


def _hat(x, ci, cj, ck, bias, nearest, disp=None, out_len=None):
    """A hat pass (K2) of one (B, D, H, W) volume with per-sample (B,)
    coefficients ``ci, cj, ck, bias``, an optional displacement and output
    length, on rows of the storage scope's type
    (:func:`~fetalsyngen_torch.ops.linops.io_dtype`)."""
    coefs = torch.stack([ci, cj, ck, bias], dim=1).contiguous()
    return hat_pass(x.to(io_dtype()).contiguous(), coefs, None if disp is None else disp.contiguous(), nearest,
                    out_len)


def _u_passes(x, U, t, nearest, out_shape=None):
    """The U stage ``W1(p) = V[U p + t]``: U-z on (i,j,k), U-y on (i,k,j),
    U-x on (j,k,i), each resampling to its axis of ``out_shape`` (default
    the input's); returns the (j,k,i) layout."""
    OD, OH, OW = out_shape if out_shape is not None else x.shape[1:]
    zero = torch.zeros_like(t[:, 0])
    x = _hat(x, zero, zero, U[:, 2, 2], t[:, 2], nearest, out_len=OW)
    x = x.permute(0, 1, 3, 2)  # (i, k, j)
    x = _hat(x, zero, U[:, 1, 2], U[:, 1, 1], t[:, 1], nearest, out_len=OH)
    x = x.permute(0, 3, 2, 1)  # (j, k, i)
    return _hat(x, U[:, 0, 1], U[:, 0, 2], U[:, 0, 0], t[:, 0], nearest, out_len=OD)


def warp_affine_separable(vol, A, t, nearest=False, out_shape=None, maxspan=None):
    """``out[o] = V[A o + t]`` of a (B, D, H, W) volume via five triangular
    hat passes (exact positions), with (B, 3, 3) ``A`` and (B, 3) ``t``.

    Pass order (layouts in parentheses, resampled axis last):
    U-z (i,j,k) -> U-y (i,k,j) -> U-x (j,k,i) -> L-y (i,k,j) -> L-z (i,j,k).
    ``out_shape`` (OD, OH, OW) is the output grid the map is evaluated on
    (default the input's); ``maxspan`` has no effect (module docstring).
    """
    del maxspan
    U, L = ul_decompose(A)
    t = t.to(torch.float32)
    zero = torch.zeros_like(t[:, 0])
    one = torch.ones_like(zero)
    x = _u_passes(vol.to(torch.float32), U, t, nearest, out_shape)
    # L stage: out(o) = W1[L o]
    x = x.permute(0, 3, 2, 1)  # (i, k, j)
    x = _hat(x, L[:, 1, 0], zero, one, zero, nearest)
    x = x.permute(0, 1, 3, 2)  # (i, j, k)
    x = _hat(x, L[:, 2, 0], L[:, 2, 1], one, zero, nearest)
    return x.to(vol.dtype)


def warp_affine_separable_pair(va, vb, A, t, modes=(False, False), out_shape=None, maxspan=None):
    """Pair version of :func:`warp_affine_separable`: the five passes shared
    by two (B, D, H, W) volumes, each sampled linearly or nearest as
    ``modes`` (first, second) says, one paired hat launch (K1) per pass.
    Returns the pair in the storage scope's type (f32 outside it);
    ``maxspan`` has no effect (module docstring)."""
    del maxspan
    U, L = ul_decompose(A)
    t = t.to(torch.float32)
    OD, OH, OW = out_shape if out_shape is not None else va.shape[1:]
    zero = torch.zeros_like(t[:, 0])
    one = torch.ones_like(zero)
    io = io_dtype()
    nearest_a, nearest_b = (bool(m) for m in modes)

    def hat(a, b, ci, cj, ck, bias, out_len=None):
        coefs = torch.stack([ci, cj, ck, bias], dim=1).contiguous()
        return hat_pass_pair(a.to(io).contiguous(), b.to(io).contiguous(), coefs, None, nearest_b, out_len, nearest_a)

    def tp(a, b, perm):
        return a.permute(perm), b.permute(perm)

    a, b = hat(va.to(torch.float32), vb.to(torch.float32), zero, zero, U[:, 2, 2], t[:, 2], OW)
    a, b = hat(*tp(a, b, (0, 1, 3, 2)), zero, U[:, 1, 2], U[:, 1, 1], t[:, 1], OH)  # (i, k, j)
    a, b = hat(*tp(a, b, (0, 3, 2, 1)), U[:, 0, 1], U[:, 0, 2], U[:, 0, 0], t[:, 0], OD)  # (j, k, i)
    a, b = hat(*tp(a, b, (0, 3, 2, 1)), L[:, 1, 0], zero, one, zero)  # (i, k, j)
    return hat(*tp(a, b, (0, 1, 3, 2)), L[:, 2, 0], L[:, 2, 1], one, zero)  # (i, j, k)


def warp_displacement_separable(vol, dx, dy, dz, nearest=False):
    """``out[o] = V[o + d(o)]`` of a (B, D, H, W) volume for small smooth
    (B, D, H, W) displacements, clipped to +-FIELD_LIM voxels: three hat
    passes with a displacement volume, along k, j and i."""
    lim = FIELD_LIM
    dx, dy, dz = (torch.clamp(d.to(torch.float32), -lim, lim) for d in (dx, dy, dz))
    zero = torch.zeros(vol.shape[0], dtype=torch.float32, device=vol.device)
    one = torch.ones_like(zero)
    x = _hat(vol.to(torch.float32), zero, zero, one, zero, nearest, dz)
    x = _hat(x.permute(0, 1, 3, 2), zero, zero, one, zero, nearest, dy.permute(0, 1, 3, 2))  # (i, k, j)
    x = _hat(x.permute(0, 3, 2, 1), zero, zero, one, zero, nearest, dx.permute(0, 2, 3, 1))  # (j, k, i)
    return x.permute(0, 3, 1, 2).to(vol.dtype)


def warp_affine_field_separable(vol, A, t, Fx, Fy, Fz, nearest=False):
    """Fused affine + displacement warp ``out[o] = V[A (o + F(o)) + t]`` of
    a (B, D, H, W) volume in six hat passes, with full-resolution (B, D, H, W)
    field components ``Fx, Fy, Fz``.

    The U stage handles the affine exactly; the L-stage passes carry the
    displacement through ``U^{-1} (A F) = L F`` (first-order triangular
    approximation of the field, as in the JAX package).
    """
    U, L = ul_decompose(A)
    t = t.to(torch.float32)
    zero = torch.zeros_like(t[:, 0])
    one = torch.ones_like(zero)
    gx, gy, gz = _field_combos(L, Fx, Fy, Fz)
    x = _u_passes(vol.to(torch.float32), U, t, nearest)
    # L stage with displacement: out(o) = W1[L o + g(o)]
    x = x.permute(0, 3, 2, 1)  # (i, k, j): pos = L10*i + j + gy
    x = _hat(x, L[:, 1, 0], zero, one, zero, nearest, gy.permute(0, 1, 3, 2))
    x = x.permute(0, 1, 3, 2)  # (i, j, k): pos = L20*i + L21*j + k + gz
    x = _hat(x, L[:, 2, 0], L[:, 2, 1], one, zero, nearest, gz)
    x = x.permute(0, 2, 3, 1)  # (j, k, i): pos = i + gx
    x = _hat(x, zero, zero, one, zero, nearest, gx.permute(0, 2, 3, 1))
    return x.permute(0, 3, 1, 2).to(vol.dtype)


# ---------------------------------------------------------------------------
# Rigid warps of cube volumes (the scanner's stack-frame maps)
# ---------------------------------------------------------------------------
#
# A rotation-times-isotropic-scale map is split on the host into one of the
# 24 cube rotations (a pure permute/flip) and a residual rotation whose Euler
# angles stay well below 90 degrees; the residual runs as unit shears and a
# final separable zoom, each a matmul. Unbatched (D, H, W) volumes.

# rotation axis -> rotated plane
_PLANE = {0: (1, 2), 1: (2, 0), 2: (0, 1)}


def _exact_quarter_np(V, P):
    S = V.shape[0]
    c = (S - 1) / 2.0
    q = np.indices(V.shape).astype(np.float64) - c
    i = np.rint(np.einsum("ab,b...->a...", P, q) + c).astype(int)
    return V[i[0], i[1], i[2]]


def _init_quarter_table():
    """The 24 proper cube rotations ``P`` and, for each, the (transpose,
    flip axes) layout op with ``out[q] = V[P (q - c) + c]``."""
    mats, ops = [], []
    probe = np.arange(4**3).reshape(4, 4, 4)
    layouts = [
        (tp, ax)
        for tp in itertools.permutations(range(3))
        for ax in itertools.chain.from_iterable(
            itertools.combinations(range(3), k) for k in range(4)
        )
    ]
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product([1, -1], repeat=3):
            P = np.zeros((3, 3))
            for a in range(3):
                P[a, perm[a]] = signs[a]
            if round(np.linalg.det(P)) != 1:
                continue
            want = _exact_quarter_np(probe, P)
            for tp, ax in layouts:
                cand = np.transpose(probe, tp)
                if ax:
                    cand = np.flip(cand, ax)
                if np.array_equal(cand, want):
                    mats.append(P.astype(np.float64))
                    ops.append((tp, tuple(ax)))
                    break
            else:  # pragma: no cover
                raise AssertionError(f"no layout op found for quarter turn {P}")
    return mats, ops


_QUARTER_MATS, _QUARTER_OPS = _init_quarter_table()
_QUARTER_STACK = np.stack(_QUARTER_MATS)  # (24, 3, 3)


def nearest_quarter_index(R) -> int:
    """Host: index of the cube rotation nearest (Frobenius) to ``R``."""
    R = np.asarray(R, np.float64)
    return int(np.argmax(np.einsum("kij,ij->k", _QUARTER_STACK, R)))


def quarter_matrix(idx: int) -> np.ndarray:
    return _QUARTER_MATS[idx]


def apply_quarter_turn(x: torch.Tensor, idx: int) -> torch.Tensor:
    """``out[q] = V[P_idx (q - c) + c]`` on a cube volume: the permute/flip
    of table entry ``idx`` (a host int)."""
    tp, ax = _QUARTER_OPS[idx]
    x = x.permute(tp)
    return torch.flip(x, ax) if ax else x


def decompose_rigid_host(R, t, in_center, out_center):
    """Host: split ``p_in = R q_out + t_c`` (about centers) into a quarter
    turn and a near-identity residual: (q_idx, A_res, t_res) with
    ``R = P[q_idx] @ A_res`` and ``out[q] = quarter(V)[A_res q + t_res]``."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    idx = nearest_quarter_index(R)
    P = _QUARTER_MATS[idx]
    A_res = P.T @ R
    c_in = np.asarray(in_center, np.float64)
    c_out = np.asarray(out_center, np.float64)
    t_res = c_in + P.T @ t - A_res @ c_out
    return idx, A_res.astype(np.float32), t_res.astype(np.float32)


def decompose_affine_paeth_host(A, t, cube):
    """Host: split an uncentered ``p_in = A q_out + t`` (rotation times
    isotropic scale, input = the cube grid) into (q_idx, angles (3,), scale,
    delta (3,)) with ``V[A q + t] == zoom_{scale, delta}(rot_{angles}(
    quarter_{q_idx}(V)))[q]``: rot samples ``Rx(a0) Ry(a1) Rz(a2)`` about the
    cube center, zoom samples axis coordinate ``scale * q + delta``."""
    from scipy.spatial.transform import Rotation

    A = np.asarray(A, np.float64)
    t = np.asarray(t, np.float64)
    s = float(np.cbrt(np.linalg.det(A)))
    R = A / s
    idx = nearest_quarter_index(R)
    P = _QUARTER_MATS[idx]
    R_res = P.T @ R
    angles = Rotation.from_matrix(R_res).as_euler("XYZ")
    c = np.full(3, (cube - 1) / 2.0)
    t_res = P.T @ (t - c) + c
    delta = R_res.T @ (t_res - c) + c
    return idx, angles.astype(np.float32), np.float32(s), delta.astype(np.float32)


def _shear_matrices_jks(J, K, S, amount, c_fix):
    """(J, K, S) banded per-row linear resampling operators
    ``M[j,k,s] = hat(pos(j,k) - s)``, ``pos = k + amount*(j - c_fix)``,
    edge-clamped; ``amount`` a 0-d tensor. Built in place: at a 640 cube the
    operator alone is 1 GB."""
    dev = amount.device
    jj = torch.arange(J, dtype=torch.float32, device=dev)[:, None, None]
    kk = torch.arange(K, dtype=torch.float32, device=dev)[None, :, None]
    ss = torch.arange(S, dtype=torch.float32, device=dev)[None, None, :]
    pos = torch.clamp(kk + amount * (jj - c_fix), 0.0, S - 1.0)
    # max(0, 1 - |pos - s|), in place
    return (pos - ss).abs_().neg_().add_(1.0).clamp_min_(0.0)


def _shear_pass_pair_mm(va, vb, axis_move, axis_fix, amount):
    """Shear of one volume or a pair (``vb`` may be None) as a batched matmul,
    one (K, S) operator per ``axis_fix`` row shared by both operands:
    ``pos[axis_move] = idx + amount * centered(axis_fix)``; intermediates in
    the storage scope's type, see ``linops.einsum_store``."""
    axis_other = next(a for a in range(3) if a not in (axis_move, axis_fix))
    perm = (axis_other, axis_fix, axis_move)
    inv = tuple(int(i) for i in np.argsort(perm))
    xa = va.permute(perm)
    J, K = xa.shape[1], xa.shape[2]
    M = _shear_matrices_jks(J, K, K, amount, (va.shape[axis_fix] - 1) / 2.0)
    oa = einsum_store("jks,ijs->ijk", M, xa).permute(inv)
    if vb is None:
        return oa, None
    return oa, einsum_store("jks,ijs->ijk", M, vb.permute(perm)).permute(inv)


def _interp_or_nearest_matrix(coords, in_size: int, nearest: bool) -> torch.Tensor:
    """(out, in_size) clamped linear operator, or the nearest (one-hot,
    half to even) one."""
    if not nearest:
        return interp_matrix_1d(coords, in_size)
    idx = torch.clamp(torch.round(coords), 0, in_size - 1).to(torch.int64)
    cols = torch.arange(in_size, device=coords.device)
    return (cols[None, :] == idx[:, None]).to(torch.float32)


def warp_rigid_pair_traced(
    va, vb, q_idx, angles, scale, delta, out_shape=None, post_a=None, post_b=None, out_perm=None,
    emit_f32=True,
):
    """``out[q] = V[A q + t]`` for one or two (``vb`` may be None) cube
    volumes, linearly, with the map of :func:`decompose_affine_paeth_host`:
    ``q_idx`` a host int, ``angles`` (3,), ``scale`` (0-d) and ``delta``
    (3,) f32 tensors on the volumes' device.

    The quarter turn is a permute/flip; each residual axis rotation
    ``[[c,-s],[s,c]]`` factors as ``diag(1/c, c)`` times two unit shears, the
    diagonals carried in ``C`` (f32, computed in f32 as the JAX package does)
    and folded into the final zoom, which runs as three separable matmuls.
    ``post_a``/``post_b``: per-axis (out, out) operators (or None) applied to
    each operand in the output frame, composed into the zoom matrices.
    ``out_perm=(1, 2, 0)`` emits the outputs as (axis1, axis2, axis0).

    Under the storage scope every contraction keeps bf16, and the last one
    emits f32 unless ``emit_f32`` is False; the ``post`` compositions take
    the matmul precision scope.
    """
    work = io_dtype()
    cube = va.shape[0]
    out_shape = tuple(out_shape) if out_shape is not None else tuple(va.shape)
    cc = (cube - 1) / 2.0
    a = apply_quarter_turn(va.to(work), q_idx)
    b = apply_quarter_turn(vb.to(work), q_idx) if vb is not None else None
    C = [torch.ones((), dtype=torch.float32, device=va.device)] * 3
    for axis in range(3):
        u_ax, v_ax = _PLANE[axis]
        c = torch.cos(angles[axis])
        s = torch.sin(angles[axis])
        C[u_ax] = C[u_ax] / c
        C[v_ax] = C[v_ax] * c
        amt_u = (-s * c) * C[u_ax] / C[v_ax]
        amt_v = (s / c) * C[v_ax] / C[u_ax]
        a, b = _shear_pass_pair_mm(a, b, u_ax, v_ax, amt_u)
        a, b = _shear_pass_pair_mm(a, b, v_ax, u_ax, amt_v)
    last_spec = {None: None, (1, 2, 0): "oi,jki->koj"}[out_perm]

    def zoom(x, post, axis, M):
        if post is not None and post[axis] is not None:
            M = prec_matmul(post[axis], M)
        if axis == 2 and last_spec is not None:
            return einsum_store(last_spec, M, x, out_f32=emit_f32)
        return axis_mm(x, M, axis, out_f32=emit_f32 and axis == 2)

    for axis in range(3):
        lanes = torch.arange(out_shape[axis], dtype=torch.float32, device=va.device)
        M = interp_matrix_1d(C[axis] * (scale * lanes + delta[axis] - cc) + cc, cube)
        a = zoom(a, post_a, axis, M)
        if b is not None:
            b = zoom(b, post_b, axis, M)
    return a, b


def _rot_axis(axis: int, th: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation by the 0-d ``th`` in the plane of ``axis`` (``_PLANE``)."""
    u_ax, v_ax = _PLANE[axis]
    c, s = torch.cos(th), torch.sin(th)
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    m = [[one if i == j else zero for j in range(3)] for i in range(3)]
    m[u_ax][u_ax] = m[v_ax][v_ax] = c
    m[u_ax][v_ax], m[v_ax][u_ax] = -s, s
    return torch.stack([torch.stack(r) for r in m])


def warp_rigid_zoom_first(v, q_idx, angles, scale, delta, out_size=None, post=None, out_perm=None,
                          emit_f32=True):
    """The map of :func:`warp_rigid_pair_traced` (``out[q] = V[A q + t]``,
    rotation times isotropic scale) for one cube volume, with the zoom
    applied before the rotation's shears, onto an ``out_size`` cube.

    For a downsampling map (``scale > 1``: the scanner's small frame in
    slice-pixel units) every shear then runs on the small output buffer, and
    the rotated content fits it by the caller's eligibility rule. With
    ``R`` the residual rotation and ``c_in``/``c_out`` the buffer centres:
    ``Z[p] = quarter(V)[s p + d]``, ``out[q] = Z[R (q - c_out) + c_out]``,
    ``d = R (delta - c_in + s c_out) + c_in - s c_out``. The rotation is the
    same six unit shears with deferred diagonals, applied last as three
    interpolation matmuls into which the ``post`` operators compose;
    ``out_perm=(1, 2, 0)`` emits (axis1, axis2, axis0). Interpolation order
    differs from the zoom-last warp: equal up to interpolation error. The
    storage scope and ``emit_f32`` act as in :func:`warp_rigid_pair_traced`.
    """
    cube = v.shape[0]
    S = int(out_size) if out_size is not None else cube
    c_in = (cube - 1) / 2.0
    c_out = (S - 1) / 2.0
    dev = v.device
    a = apply_quarter_turn(v.to(io_dtype()), q_idx)
    R_res = _rot_axis(0, angles[0]) @ _rot_axis(1, angles[1]) @ _rot_axis(2, angles[2])
    d = R_res @ (delta - c_in + scale * c_out) + c_in - scale * c_out
    lanes = torch.arange(S, dtype=torch.float32, device=dev)
    for axis in range(3):
        a = axis_mm(a, interp_matrix_1d(scale * lanes + d[axis], cube), axis)
    C = [torch.ones((), dtype=torch.float32, device=dev)] * 3
    for axis in range(3):
        u_ax, v_ax = _PLANE[axis]
        c = torch.cos(angles[axis])
        s = torch.sin(angles[axis])
        C[u_ax] = C[u_ax] / c
        C[v_ax] = C[v_ax] * c
        amt_u = (-s * c) * C[u_ax] / C[v_ax]
        amt_v = (s / c) * C[v_ax] / C[u_ax]
        a, _ = _shear_pass_pair_mm(a, None, u_ax, v_ax, amt_u)
        a, _ = _shear_pass_pair_mm(a, None, v_ax, u_ax, amt_v)
    last_spec = {None: None, (1, 2, 0): "oi,jki->koj"}[out_perm]
    for axis in range(3):
        M = interp_matrix_1d(C[axis] * (lanes - c_out) + c_out, S)
        if post is not None and post[axis] is not None:
            M = prec_matmul(post[axis], M)
        if axis == 2 and last_spec is not None:
            a = einsum_store(last_spec, M, a, out_f32=emit_f32)
        else:
            a = axis_mm(a, M, axis, out_f32=emit_f32 and axis == 2)
    return a


def warp_affine_field_pair_pre(va, vb, A, t, gyT, gz, gxT):
    """Affine + field warp of a (linear, nearest) pair of (B, D, H, W) volumes
    from pre-combined, pre-laid-out displacement fields:

    - ``gyT`` = clip(L10*Fx + Fy, +-FIELD_LIM) in (B, D, W, H) layout,
    - ``gz``  = clip(L20*Fx + L21*Fy + Fz, ...) in (B, D, H, W) layout,
    - ``gxT`` = clip(Fx, ...) in (B, H, W, D) layout,

    with L from :func:`ul_decompose` of the (B, 3, 3) ``A`` and (B, 3)
    offsets ``t``. The U passes and the L21 peel are row-affine passes
    (:func:`row_affine_pass_pair`: on the card five launches of the two-tap
    kernel, the first reading the image and the labels as they arrive); the
    L-y, L-z and x passes launch the hat kernel, three launches per call.
    Under the storage scope the row-affine and hat passes keep the pair in
    bf16 (the labels too: below 257 they are exact), and the image comes out
    bf16.
    """
    U, L = ul_decompose(A)
    t = t.to(torch.float32)
    B = va.shape[0]
    zero = torch.zeros(B, dtype=torch.float32, device=va.device)
    one = torch.ones_like(zero)

    def coefs(ci):
        return torch.stack([ci, zero, one, zero], dim=1).contiguous()

    io = io_dtype()

    def hat(a, b, ci, disp):
        return hat_pass_pair(a.to(io).contiguous(), b.to(io).contiguous(), coefs(ci), disp.contiguous())

    # U-z on (i,j,k): pos_k = U22*k + t2
    a, b = row_affine_pass_pair(va, vb, U[:, 2, 2], 0.0, t[:, 2], out_order="ikj")
    # U-y on (i,k,j): pos_j = U11*j + U12*k + t1
    a, b = row_affine_pass_pair(a, b, U[:, 1, 1], U[:, 1, 2], t[:, 1], out_order="kji")
    # U-x has two row terms, split into two single-row-term passes:
    # i <- i + U02*k on (j,k,i), then i <- U00*i + U01*j + t0 on (k,j,i)
    a, b = row_affine_pass_pair(a, b, 1.0, U[:, 0, 2], 0.0, out_order="jik")
    a, b = row_affine_pass_pair(a, b, U[:, 0, 0], U[:, 0, 1], t[:, 0], out_order="kij")
    # L-y on (i,k,j): pos_j = j + L10*i + gy
    a, b = hat(a, b, L[:, 1, 0], gyT)
    a, b = a.permute(0, 1, 3, 2), b.permute(0, 1, 3, 2)
    # L-z peel: k <- k + L21*j as a row-affine pass, then the hat pass
    # carries the row_i term L20*i and the field
    a, b = row_affine_pass_pair(a, b, 1.0, L[:, 2, 1], 0.0, out_order="ijk")
    a, b = hat(a, b, L[:, 2, 0], gz)
    a, b = a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)
    # x on (j,k,i): pos_i = i + gx
    a, b = hat(a, b, zero, gxT)
    return a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2).to(vb.dtype)
