"""Microbenchmark the warp's hot path on the card, one variant per call.

Port of ``scripts/microbench_warp.py``: the same variants on (B, S, S, S)
f32 volumes, each a step ``carry -> carry`` timed by
:func:`fetalsyngen_torch.probes.timing.chain_ms`; prints ``"{v}: ... ms/iter
total, ... ms/vol (B=..., S^3)"``.

    python -m fetalsyngen_torch.probes.microbench_warp --variant probe2_taps8 [--iters 50]
        [--batch 4] [--size 256] [--device cuda]

- ``pair_*``, ``single_l`` and ``deform_pair`` run the hat kernels (K1, K2)
  through :mod:`fetalsyngen_torch.kernels.hat` and
  :mod:`fetalsyngen_torch.ops.warp`; ``pair_l_unit*`` is the same K1 call as
  ``pair_l`` (``unit_slope=True`` is a TPU lane-block hint with no
  counterpart on the card), on the random, zero or upsampled smooth field.
- ``u_stage`` and ``nonlin_field`` run ``_row_affine_matmul_pair`` and
  ``zoom_mm`` (f32 matmuls, TF32 off, where the TPU script ran
  ``batched_matmul`` at the MXU's default bf16 precision).
- The bf16 variants run under the stream's production scopes
  (:mod:`fetalsyngen_torch.ops.linops`), each step casting its outputs back
  to f32 as the TPU script's do: ``pair_l_unit_bf16`` is ``pair_l_unit`` on
  bf16 rows (K1's bf16 form) under ``storage_scope``, ``u_stage_bf16`` the
  U stage under ``storage_scope`` (bf16 intermediates), ``deform_pair_bf16``
  the whole field warp under ``precision_scope(DEFAULT)`` and
  ``storage_scope``.
- ``transpose*``, ``pad``, ``gather_table``, ``onehot_sweep``, ``randn``,
  ``batched_matmul`` and ``matmul`` are plain torch operations.
- ``probe2_{copy,stage,taps<N>}`` run K3 and ``probe_{copy,stage,ladder,
  tiles,sweep12}`` K4 (:mod:`fetalsyngen_torch.kernels.probes`; ``probe_*``
  needs S a multiple of 128).

``transpose_bf16`` is plain torch.
"""

from __future__ import annotations

import argparse
import re

import torch
import torch.nn.functional as F

from ..kernels import hat, probes
from ..ops import warp
from ..ops.linops import DEFAULT, precision_scope, storage_scope, zoom_mm
from . import timing

VARIANTS = (
    "pair_l", "pair_l_nodisp", "pair_u", "single_l", "transpose", "transpose_bf16", "transpose_rows",
    "pair_l_unit", "pair_l_unit_bf16", "pair_l_unit_zero", "pair_l_unit_smooth", "u_stage", "u_stage_bf16",
    "nonlin_field", "deform_pair", "deform_pair_bf16", "pad",
    "probe2_copy", "probe2_stage", "probe2_taps8", "probe_copy", "probe_stage", "probe_ladder", "probe_tiles",
    "probe_sweep12", "gather_table", "onehot_sweep", "randn", "batched_matmul", "matmul",
)
PAD = 128  # the staged rows' pad of the ``pad`` variant (warp.PAD)


def _coefs(c, B, dev):
    return torch.tensor([c] * B, dtype=torch.float32, device=dev)


def _zoom_to(small, S):
    """(B, s, s, s) upsampled to (B, S, S, S) by ``zoom_mm``."""
    B, s = small.shape[0], small.shape[-1]
    factor = torch.full((B, 3), S / s, dtype=torch.float32, device=small.device)
    size = torch.full((B, 3), s, dtype=torch.float32, device=small.device)
    return zoom_mm(small, (S, S, S), factor, size)


def build(v: str, B: int, S: int, dev: torch.device):
    """(step, carry) of variant ``v`` on (B, S, S, S) volumes drawn from a
    seeded generator on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (B, S, S, S)

    def randn(*size):
        return torch.randn(size, generator=g, device=dev)

    x, y = randn(*shape), randn(*shape)
    d = torch.rand(shape, generator=g, device=dev) * 16.0 - 8.0

    if v in ("pair_l", "pair_l_unit", "pair_l_unit_zero", "pair_l_unit_smooth"):
        if v.endswith("zero"):
            d = torch.zeros_like(d)
        elif v.endswith("smooth"):
            d = _zoom_to(randn(B, 12, 12, 12) * 4.0, S).contiguous()
        c = _coefs((0.11, 0.07, 1.0, 0.3), B, dev)
        return (lambda t: (*hat.hat_pass_pair(t[0], t[1], c, t[2]), t[2])), (x, y, d)
    if v == "pair_l_unit_bf16":
        c = _coefs((0.11, 0.07, 1.0, 0.3), B, dev)

        def pair_bf16(t):
            with storage_scope(torch.bfloat16):
                bf = torch.bfloat16
                oa, ob = hat.hat_pass_pair(t[0].to(bf), t[1].to(bf), c, t[2])
            return oa.float(), ob.float(), t[2]

        return pair_bf16, (x, y, d)
    if v in ("pair_l_nodisp", "pair_u"):
        c = _coefs((0.11, 0.07, 1.0, 0.3) if v == "pair_l_nodisp" else (0.05, 0.1, 1.08, -9.0), B, dev)
        return (lambda t: hat.hat_pass_pair(t[0], t[1], c, None)), (x, y)
    if v == "single_l":
        c = _coefs((0.11, 0.07, 1.0, 0.3), B, dev)
        return (lambda t: (hat.hat_pass(t[0], c, t[1]), t[1])), (x, d)
    if v == "transpose":
        return (lambda a: a.permute(0, 1, 3, 2) + 0.0), x
    if v == "transpose_bf16":
        return (lambda a: a.permute(0, 1, 3, 2) + 0.0), x.to(torch.bfloat16)
    if v == "transpose_rows":
        return (lambda a: a.permute(0, 2, 1, 3) + 0.0), x
    if v in ("u_stage", "u_stage_bf16"):
        store = torch.bfloat16 if v.endswith("bf16") else None

        def u_stage(t):
            with storage_scope(store):
                a, b = warp._row_affine_matmul_pair(t[0], t[1], 1.08, 0.0, 0.3, out_order="ikj")
                a, b = warp._row_affine_matmul_pair(a, b, 0.95, 0.06, 0.1, out_order="kji")
                a, b = warp._row_affine_matmul_pair(a, b, 1.0, 0.04, 0.0, out_order="jik")
                a, b = warp._row_affine_matmul_pair(a, b, 1.02, -0.05, 0.2, out_order="kij")
            return a.float(), b.float()

        return u_stage, (x, y)
    if v == "nonlin_field":
        def field(f):
            up = torch.stack([_zoom_to(f[:, c], S) for c in range(3)], 1)
            return f + up.mean() * 1e-20

        return field, randn(B, 3, 10, 10, 10)
    if v in ("deform_pair", "deform_pair_bf16"):
        A = (torch.eye(3, device=dev) + randn(3, 3) * 0.05).expand(B, 3, 3)
        t0 = torch.zeros((B, 3), device=dev)
        if v == "deform_pair":
            return (lambda t: (*warp.warp_affine_field_pair(t[0], t[1], A, t0, t[2], t[2], t[2]), t[2])), (x, y, d)

        def deform_bf16(t):
            with precision_scope(DEFAULT), storage_scope(torch.bfloat16):
                oa, ob = warp.warp_affine_field_pair(t[0], t[1], A, t0, t[2], t[2], t[2])
            return oa.float(), ob.float(), t[2]

        return deform_bf16, (x, y, d)
    if v == "pad":
        def pad(a):
            p = F.pad(a.reshape(B, S * S, S), (PAD, PAD + 128), mode="replicate")
            return p[:, :, PAD : PAD + S].reshape(shape)

        return pad, x
    if m := re.fullmatch(r"probe2_(copy|stage|taps(\d+))", v):
        mode, ntaps = ("taps", int(m[2])) if m[2] else (m[1], 0)
        return (lambda t: probes.probe2(t[0], t[1], mode, ntaps)), (x, y)
    if m := re.fullmatch(r"probe_(\w+)", v):
        if m[1] not in probes.SINGLE_MODES:
            raise SystemExit(f"unknown variant {v}")
        return (lambda a: probes.probe(a, m[1])), x
    if v in ("gather_table", "onehot_sweep"):
        seeds = torch.randint(0, 50, shape, generator=g, device=dev)
        table, table2 = randn(50), randn(50)
        if v == "gather_table":
            return (lambda c: c + (table[c] < -10).to(c.dtype)), seeds

        def sweep(c):
            mu = torch.zeros(c.shape, device=dev)
            sg = torch.zeros(c.shape, device=dev)
            for lab in range(50):
                sel = c == lab
                mu = torch.where(sel, table[lab], mu)
                sg = torch.where(sel, table2[lab], sg)
            return c + (mu + sg < -100).to(c.dtype)

        return sweep, seeds
    if v == "randn":
        return (lambda c: c + torch.randn(c.shape, generator=g, device=dev)), x
    if v == "batched_matmul":
        M = randn(S, S, S)  # (j, k, s)
        return (lambda c: torch.einsum("jks,bjsw->bjkw", M, c.transpose(1, 2)).transpose(1, 2)), x
    if v == "matmul":
        M = randn(S, S)
        return (lambda c: torch.einsum("oi,bijk->bojk", M, c)), x
    raise SystemExit(f"unknown variant {v}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", required=True)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = timing.start(args.device)
    B, S, v = args.batch, args.size, args.variant
    step, carry = build(v, B, S, dev)
    ms, _ = timing.chain_ms(step, carry, args.iters, dev)
    if ms is None:
        print(f"{v}: ran once on {dev.type}, no time (B={B}, {S}^3)", flush=True)
    else:
        print(f"{v}: {ms:.3f} ms/iter total, {ms / B:.3f} ms/vol (B={B}, {S}^3)", flush=True)
    return ms


if __name__ == "__main__":
    main()
