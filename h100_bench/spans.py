"""Spans around the calls into the program's layers, from the benchmark's
own files: ``spans/<name>.json`` names the layer, the ``module:function``
(or ``module:Class.method``) attributes to wrap, the clock (``host``,
``cuda`` or ``both``) and optionally the work function of
:mod:`.roofline` that counts a call's bytes. Each wrapper replaces the
name in the module that calls it; a target that is gone leaves its span
inactive, and the metrics reading it report nothing.

Spans are installed only in ``--trace 1`` runs. Every call is kept in
memory (host start and end, its CUDA events, its work) and each wrapper
also marks the call in the profiler's trace (``record_function``).
"""

from __future__ import annotations

import functools
import importlib
import time

from . import roofline
from .manifest import HERE, read_json


class Recorder:
    """The calls of every installed span, by span name."""

    def __init__(self):
        self.calls: dict[str, list[dict]] = {}
        self.missing: dict[str, list[str]] = {}
        self._undo: list = []

    def install(self, names=None, base=HERE) -> None:
        """Wrap the targets of ``spans/<name>.json`` for each name (default:
        every span file)."""
        names = sorted(p.stem for p in (base / "spans").glob("*.json")) if names is None else names
        for name in names:
            spec = read_json("spans", name, base)
            self.calls[name] = []
            for target in spec["targets"]:
                if not self._wrap(name, spec, target):
                    self.missing.setdefault(name, []).append(target)

    def _wrap(self, name: str, spec: dict, target: str) -> bool:
        mod_name, _, attr = target.partition(":")
        try:
            owner = importlib.import_module(mod_name)
        except ImportError:
            return False
        *path, leaf = attr.split(".")
        for p in path:
            owner = getattr(owner, p, None)
            if owner is None:
                return False
        fn = getattr(owner, leaf, None)
        if fn is None or not callable(fn):
            return False
        import torch

        clock = spec.get("clock", "host")
        work = roofline.WORK[spec["work"]] if spec.get("work") else None
        calls = self.calls[name]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = {"t0": time.perf_counter()}
            cuda = clock in ("cuda", "both") and torch.cuda.is_available()
            if cuda:
                rec["ev0"] = torch.cuda.Event(enable_timing=True)
                rec["ev0"].record()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            if cuda:
                rec["ev1"] = torch.cuda.Event(enable_timing=True)
                rec["ev1"].record()
            rec["t1"] = time.perf_counter()
            if work is not None:
                rec["bytes"] = work(*args, **kwargs)
            calls.append(rec)
            return out

        setattr(owner, leaf, wrapper)
        self._undo.append((owner, leaf, fn))
        return True

    def uninstall(self) -> None:
        for owner, leaf, fn in reversed(self._undo):
            setattr(owner, leaf, fn)
        self._undo.clear()

    def resolve(self) -> None:
        """Turn each call's CUDA events into milliseconds (``ms``); call once
        the device is idle."""
        for calls in self.calls.values():
            for rec in calls:
                if "ev0" in rec:
                    rec["ms"] = rec.pop("ev0").elapsed_time(rec.pop("ev1"))

    def active(self, name: str) -> bool:
        return name in self.calls and name not in self.missing

    def between(self, name: str, t0: float, t1: float) -> list[dict] | None:
        """The calls of span ``name`` that started in [t0, t1) by the host
        clock, or None if the span is not active."""
        if not self.active(name):
            return None
        return [r for r in self.calls[name] if t0 <= r["t0"] < t1]
