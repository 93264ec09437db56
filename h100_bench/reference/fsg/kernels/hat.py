"""Hat passes, plain: the frozen reference's copy of the port's plain
versions (``hat_pass_ref``, ``hat_pass_pair_ref``) with no kernel behind them.

For each sample ``b``, row ``r`` of the (D, H) row grid (``row_i = r // H``,
``row_j = r % H``) and output lane ``l``, rows are sampled along their last
axis at ``pos = ((ci*row_i + cj*row_j) + ck*l) + bias [+ displacement]``,
edge-clamped, linearly or nearest (rounding half to even). ``coefs`` is one
(ci, cj, ck, bias) row per sample, (B, 4), or one per slice, (B, D, 4); the
displacement is a (B, D, H, OW) volume, a (B, 3, OW) lane-affine table, or
absent.

:func:`hat_pass` and :func:`hat_pass_pair` take every form on any device.
Under the control's storage (``linops.FP8``) the linearly sampled operands
and their outputs are rounded to float8 e4m3 with a per-tensor scale; the
nearest (label) operands pass as they are.
"""

from __future__ import annotations

import torch

from ..ops.linops import FP8, current_storage, round_fp8

_DISP_NONE, _DISP_VOLUME, _DISP_LANE_AFFINE = 0, 1, 2


def _disp_mode(disp) -> int:
    if disp is None:
        return _DISP_NONE
    return _DISP_LANE_AFFINE if disp.dim() == 3 else _DISP_VOLUME


def positions(coefs: torch.Tensor, R: int, H: int, OW: int, disp=None, lane=None) -> torch.Tensor:
    """(B, R, OW) f32 sample positions of rows ``r`` (``row_i = r // H``,
    ``row_j = r % H``) and lanes ``l``: one eager op per product and sum, in
    the association order the kernels pin. ``coefs``: (B, 4) or (B, R // H,
    4); ``disp``: (B, R, OW) or None; ``lane``: a (B, 3, OW) lane-affine
    table or None."""
    dev = coefs.device
    rows = torch.arange(R, device=dev)
    ri = (rows // H).to(torch.float32)[None, :, None]
    rj = (rows % H).to(torch.float32)[None, :, None]
    lanes = torch.arange(OW, dtype=torch.float32, device=dev)[None, None, :]
    coefs = coefs.to(torch.float32)
    if coefs.dim() == 3:
        c = [coefs[:, rows // H, k, None] for k in range(4)]  # (B, R, 1) each
    else:
        c = [coefs[:, k, None, None] for k in range(4)]  # (B, 1, 1) each
    pos = c[0] * ri + c[1] * rj + c[2] * lanes + c[3]
    if lane is not None:
        A = lane.to(torch.float32)[:, :, None, :]  # (B, 3, 1, OW)
        pos = pos + (A[:, 0] * ri + A[:, 1] * rj + A[:, 2])
    return pos if disp is None else pos + disp


def _positions_of(coefs, B, D, H, OW, disp):
    """:func:`positions` for a (B, D, H, OW) volume or (B, 3, OW) table ``disp``."""
    R = D * H
    if _disp_mode(disp) == _DISP_LANE_AFFINE:
        return positions(coefs, R, H, OW, lane=disp)
    return positions(coefs, R, H, OW, None if disp is None else disp.reshape(B, R, OW))


def _sample_ref(x: torch.Tensor, pos: torch.Tensor, nearest: bool) -> torch.Tensor:
    """Edge-clamped sample of rows ``x`` (B, R, S) at ``pos`` (B, R, OW), in
    ``x``'s dtype: a linear sample of bf16 rows widens its taps to f32 and
    rounds once."""
    S = x.shape[-1]
    sat_lo = pos <= 0.0
    sat_hi = pos >= S - 1.0
    c = torch.clamp(pos, 0.0, S - 1.0)
    if nearest:
        out = torch.take_along_dim(x, torch.round(c).to(torch.int64), dim=2)
    else:
        f = torch.clamp(torch.floor(c), 0.0, S - 2.0)
        w = c - f
        fi = f.to(torch.int64)
        g0 = torch.take_along_dim(x, fi, dim=2).to(torch.float32)
        g1 = torch.take_along_dim(x, fi + 1, dim=2).to(torch.float32)
        out = (g0 * (1.0 - w) + g1 * w).to(x.dtype)
    out = torch.where(sat_lo, x[:, :, :1], out)
    return torch.where(sat_hi, x[:, :, S - 1 :], out)


def _out_len(S: int, disp, out_len) -> int:
    """The output rows' length: the displacement's lanes, else ``out_len``,
    else S; raises where ``out_len`` disagrees with the displacement."""
    OW = disp.shape[-1] if disp is not None else (S if out_len is None else int(out_len))
    if out_len is not None and int(out_len) != OW:
        raise ValueError(f"out_len={out_len} but the displacement has {OW} lanes")
    if OW < 1:
        raise ValueError(f"out_len must be positive, got {OW}")
    return OW


def hat_pass_pair_ref(va, vb, coefs, disp, nearest_b=True, out_len=None, nearest_a=False):
    """Plain PyTorch paired hat pass (K1's reference).

    ``va`` (nearest if ``nearest_a``, else linear), ``vb`` (nearest if
    ``nearest_b``, else linear): (B, D, H, S) f32 or bf16, outputs in their
    dtype; ``coefs``: (B, 4) or (B, D, 4); ``disp``: (B, D, H, OW), (B, 3,
    OW) or None (then OW = ``out_len``, or S). Returns two (B, D, H, OW)
    tensors.
    """
    B, D, H, S = va.shape
    OW = _out_len(S, disp, out_len)
    R = D * H
    pos = _positions_of(coefs, B, D, H, OW, disp)
    oa = _sample_ref(va.reshape(B, R, S), pos, nearest=nearest_a)
    ob = _sample_ref(vb.reshape(B, R, S), pos, nearest=nearest_b)
    return oa.reshape(B, D, H, OW), ob.reshape(B, D, H, OW)


def hat_pass_ref(x, coefs, disp=None, nearest=False, out_len=None):
    """Plain PyTorch single-operand hat pass (K2's reference).

    ``x``: (B, D, H, S) f32 or bf16; ``coefs``: (B, 4) or (B, D, 4); ``disp``:
    (B, D, H, OW), (B, 3, OW) or None (then OW = ``out_len``, or S). Returns
    a (B, D, H, OW) tensor of ``x``'s dtype, sampled nearest if ``nearest``.
    """
    B, D, H, S = x.shape
    OW = _out_len(S, disp, out_len)
    pos = _positions_of(coefs, B, D, H, OW, disp)
    return _sample_ref(x.reshape(B, D * H, S), pos, nearest).reshape(B, D, H, OW)


def hat_pass_pair(va, vb, coefs, disp, nearest_b=True, out_len=None, nearest_a=False):
    """Paired hat pass: :func:`hat_pass_pair_ref`, rounded under the control's storage."""
    if current_storage() != FP8:
        return hat_pass_pair_ref(va, vb, coefs, disp, nearest_b, out_len, nearest_a)
    qa = (lambda t: t) if nearest_a else round_fp8
    qb = (lambda t: t) if nearest_b else round_fp8
    oa, ob = hat_pass_pair_ref(qa(va), qb(vb), coefs, disp, nearest_b, out_len, nearest_a)
    return qa(oa), qb(ob)


def hat_pass(x, coefs, disp=None, nearest=False, out_len=None):
    """Single-operand hat pass: :func:`hat_pass_ref`, rounded under the control's storage."""
    if current_storage() != FP8 or nearest:
        return hat_pass_ref(x, coefs, disp, nearest, out_len)
    return round_fp8(hat_pass_ref(round_fp8(x), coefs, disp, nearest, out_len))
