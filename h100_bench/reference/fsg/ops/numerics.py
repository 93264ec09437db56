"""Exactly-rounded grid-size numerics in f32 (port of ``fetalsyngen_tpu.ops.numerics``).

The reference truncates ``shape * input_res / spacing`` in f64 on the host.
:func:`floor_div_exact` reproduces that law from f32 inputs with f32 ops
only, so a per-sample ``new_size`` can be computed on the device without a
host sync: the f32 quotient is a candidate that an exact Dekker comparison of
``n * b`` against ``a`` corrects by at most one.

Every product and sum below is its own eager op, so nothing is contracted into
an FMA; the Dekker halves rely on that.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0  # 2^12 + 1 (Dekker split point; exact in f32)


def _nb_le_a(n: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact predicate ``n * b <= a`` for f32 ``a, b > 0`` and integer-valued
    f32 ``0 <= n < 2^12`` with ``n * b`` within a factor of 2 of ``a``."""
    c = _SPLIT * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    s = n * b_hi - a
    return s + n * b_lo <= 0.0


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``.

    On a GPU the values go through pinned host memory with a non-blocking
    copy: ``torch.tensor(values, device=cuda)`` copies from pageable memory
    and synchronises the stream, which would stall the pipeline each time a
    stage builds a constant.
    """
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def floor_div_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``floor(a / b)`` for positive f32 tensors, correctly rounded (int32).

    Matches ``np.float64(a) / np.float64(b)`` truncation for quotients < 2^12.
    """
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    q0 = torch.floor(a / b)
    q = torch.where(_nb_le_a(q0 + 1.0, a, b), q0 + 1.0, q0)
    q = torch.where(_nb_le_a(q, a, b), q, q - 1.0)
    return q.to(torch.int32)
