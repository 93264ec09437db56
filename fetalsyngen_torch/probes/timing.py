"""Timing for the probe entry points: CUDA events around chained iterations.

The counterpart of the scripts' ``timeit`` and ``timed`` (a ``fori_loop`` of
iterations inside one jitted program, best of three): one warm-up call, then
three times ``iters`` calls queued back to back between two CUDA events; the
best of the three, in ms per call. On the CPU the work runs once and no time
is taken.

:func:`bound` and :func:`hat_bound` give the least time the card could take
for a function, the yardstick the kernels' times are read against.
"""

from __future__ import annotations

import functools
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``ops`` f32 operations."""
    b, o = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return (b, "bytes") if b >= o else (o, "operations")


def hat_bound(pair: bool, B, D, H, S, OW, disp=None, nearest=False, esize: int = 4, nearest_a: bool = False):
    """:func:`bound` of one hat pass over (B, D, H, S) rows to OW lanes: each
    input read once (the rows of one or two operands, the displacement volume
    or lane-affine table, the coefficients), each output written once; per
    output element the position polynomial (6 operations, +1 with a volume,
    +5 with a table) and 5 per linear sample (the second operand of a pair
    is nearest if ``nearest``, its first if ``nearest_a``, the single
    operand if ``nearest``). ``esize``: the bytes of a row and output element
    (4: f32, 2: the bf16 forms; displacements, tables and coefficients are
    f32 either way)."""
    n_in, out = (2 if pair else 1), B * D * H * OW
    n_lin = n_in - int(nearest) - int(pair and nearest_a)
    disp_elems, pos_ops = 0, 6
    if disp is not None:
        disp_elems, pos_ops = (disp.numel(), 7) if disp.dim() == 4 else (disp.numel(), 11)
    nbytes = esize * n_in * (B * D * H * S + out) + 4 * (disp_elems + B * D * 4)
    return bound(nbytes, out * (pos_ops + 5 * n_lin))


@functools.cache
def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def start(device: str) -> torch.device:
    """The run's device; on a CUDA device, f32 products in full f32 (TF32
    off), bf16 GEMMs summing in f32 and the card's line printed first."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.set_float32_matmul_precision("highest")
        print(card_line(), flush=True)
    return dev


def chain_ms(step, carry, iters: int, device: torch.device):
    """(best ms per call of ``carry = step(carry)`` over three chains of
    ``iters`` calls after one warm-up call, the last carry); on the CPU
    (None, the carry of one call)."""
    carry = step(carry)
    if device.type != "cuda":
        return None, carry
    best = float("inf")
    for _ in range(3):
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(iters):
            carry = step(carry)
        end_ev.record()
        end_ev.synchronize()
        best = min(best, start_ev.elapsed_time(end_ev) / iters)
    return best, carry
