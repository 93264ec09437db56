"""The work of the hat passes, counted from the shapes and types a call
sees, and the card's peaks (``peaks.json``).

A hat pass reads each operand row once and writes each output row once:
its least time is its bytes over the card's memory bandwidth, whatever
kernel implements it.
"""

from __future__ import annotations

import json
import math

from .manifest import HERE


def _nbytes(t) -> int:
    return 0 if t is None else math.prod(t.shape) * t.element_size()


def _out_bytes(x, disp, out_len, n_out: int) -> int:
    B, D, H, S = x.shape
    OW = disp.shape[-1] if disp is not None else (S if out_len is None else int(out_len))
    return n_out * B * D * H * OW * x.element_size()


def hat_pass_bytes(x, coefs, disp=None, nearest=False, out_len=None) -> int:
    """Bytes a single-operand pass ``hat_pass(x, coefs, disp, nearest,
    out_len)`` must move: ``x``, the coefficients and the displacement read
    once, the output written once."""
    return _nbytes(x) + _nbytes(coefs) + _nbytes(disp) + _out_bytes(x, disp, out_len, 1)


def hat_pass_pair_bytes(va, vb, coefs, disp, nearest_b=True, out_len=None, nearest_a=False) -> int:
    """Bytes a paired pass ``hat_pass_pair(va, vb, coefs, disp, ...)`` must
    move: both operands, the coefficients and the displacement read once,
    both outputs written once."""
    return _nbytes(va) + _nbytes(vb) + _nbytes(coefs) + _nbytes(disp) + _out_bytes(va, disp, out_len, 2)


WORK = {"hat_pass": hat_pass_bytes, "hat_pass_pair": hat_pass_pair_bytes}


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    return json.loads((HERE / "peaks.json").read_text()).get(kind)
