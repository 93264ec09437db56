"""The program's own spans (``fetalsyngen_torch.trace``), read by the
per-layer metrics of a ``--trace 1`` run.

The runner installs every span file in a traced run and none in an untraced
one. ``spans/program.json`` names this module's ``switch``: resolving that
name (the module's ``__getattr__``) turns the program's tracing on, so the
program records its spans in exactly the runs that install the benchmark's
own, and a ``--trace 0`` run stays as it was. The first reader drains the
records (the runner has synchronised by then), turns tracing off and keeps
them in the run's context. Where the program has no
``fetalsyngen_torch.trace``, the span stays inactive and every reader
returns None.

A record (``fetalsyngen_torch.trace.drain``): ``name``, host ``t0`` and
``t1`` by ``time.perf_counter()`` (the runner's clock), ``thread``, ``id``,
``parent``, ``batch`` (the stream's draw index), ``attrs`` and, for a span
on the CUDA clock, ``ms``.
"""

from __future__ import annotations


def _program_trace():
    try:
        from fetalsyngen_torch import trace
    except ImportError:
        return None
    return trace


def __getattr__(name: str):
    if name != "switch":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    trace = _program_trace()
    if trace is None:
        raise AttributeError(f"{__name__}.switch: the program has no fetalsyngen_torch.trace")
    trace.enable()
    return trace.enable


def records(ctx) -> list[dict] | None:
    """The program's span records of the run, drained once and kept in
    ``ctx``; None where the program's tracing was not on."""
    if "program_spans" not in ctx:
        trace = _program_trace()
        recs = None
        if trace is not None and trace.enabled():
            recs = trace.drain()
            trace.disable()
            globals().pop("switch", None)  # a later install turns it on again
        ctx["program_spans"] = recs
    return ctx["program_spans"]


def untraced(ctx, name: str) -> list[dict] | None:
    """The records of span ``name`` that started in the untraced part of the
    window, or None where there is none (or no records)."""
    recs = records(ctx)
    u = ctx["untraced"]
    if recs is None or u["t0"] is None or not u["batches"]:
        return None
    return [r for r in recs if r["name"] == name and u["t0"] <= r["t0"] < u["t1"]] or None


def host_ms(recs) -> float:
    return sum(r["t1"] - r["t0"] for r in recs) * 1e3


def card_ms(recs) -> float | None:
    """The records' CUDA-event milliseconds, or None where one has none."""
    if any("ms" not in r for r in recs):
        return None
    return sum(r["ms"] for r in recs)


def card_ms_per_vol(ctx, name: str) -> float | None:
    """CUDA-event milliseconds of span ``name`` (one a batch) per volume, in
    the untraced window."""
    recs = untraced(ctx, name)
    ms = card_ms(recs) if recs else None
    return None if ms is None else ms / (len(recs) * ctx["batch_size"])
