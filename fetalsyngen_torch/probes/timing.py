"""Timing for the probe entry points: CUDA events around chained iterations.

The counterpart of the scripts' ``timeit`` and ``timed`` (a ``fori_loop`` of
iterations inside one jitted program, best of three): one warm-up call, then
three times ``iters`` calls queued back to back between two CUDA events; the
best of the three, in ms per call. On the CPU the work runs once and no time
is taken.
"""

from __future__ import annotations

import functools
import subprocess

import torch


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
    off) and the card's line printed first."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
