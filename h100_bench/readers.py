"""What the metric readers (``metrics/<name>.py``) share: each reads one
number from a run's context and returns it, or None where the run has
nothing to read (an inactive span, no trace), and the metric is left out.

The context (``runner.run``): ``setup_s``, ``window_s``, ``volumes``,
``batches``, ``batch_size``, ``waits_s`` (each batch's wait), ``peak_bytes``,
``trace`` (:func:`trace.reduce` of the traced part of the window),
``traced`` and ``untraced`` (volumes and batches of each part; ``untraced``
also its host-clock bounds ``t0`` and ``t1``), ``recorder`` (the spans'
calls), ``device_kind``.
"""

from __future__ import annotations

from . import roofline


def traced(ctx, key: str, per_volume: bool = False, scale: float = 1.0):
    """``trace[key] * scale``, per traced volume if ``per_volume``."""
    t = ctx.get("trace")
    if t is None or ctx["device_kind"] == "cpu":
        return None
    v = t[key] * scale
    if per_volume:
        n = ctx["traced"]["volumes"]
        return v / n if n else None
    return v


def idle_pct(ctx):
    t = ctx.get("trace")
    if t is None or ctx["device_kind"] == "cpu" or not t["window_us"]:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])


def untraced_calls(ctx, *spans):
    """The calls of ``spans`` that started in the untraced part of the
    window, or None if any span is inactive or that part is empty."""
    u = ctx["untraced"]
    if u["t0"] is None or not u["batches"]:
        return None
    out = []
    for name in spans:
        calls = ctx["recorder"].between(name, u["t0"], u["t1"])
        if calls is None:
            return None
        out += calls
    return out


def host_ms(calls) -> float:
    return sum(c["t1"] - c["t0"] for c in calls) * 1e3


def per_untraced(ctx, value, unit: str = "volumes"):
    n = ctx["untraced"][unit]
    return value / n if n else None


def roofline_pct(ctx, *spans):
    """The least time the calls of ``spans`` need (their bytes over the
    card's memory bandwidth) over their CUDA-event time, in %."""
    calls = untraced_calls(ctx, *spans)
    peaks = roofline.peaks(ctx["device_kind"])
    if not calls or peaks is None or any("ms" not in c for c in calls):
        return None
    ms = sum(c["ms"] for c in calls)
    if ms <= 0:
        return None
    return 100.0 * sum(c["bytes"] for c in calls) / peaks["hbm_bytes_per_s"] / (ms / 1e3)
