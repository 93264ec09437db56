"""The port's spans: named intervals of its work, recorded while tracing is on.

    from fetalsyngen_torch import trace

    trace.enable()
    ...                       # run the stream, the generator, the chain
    torch.cuda.synchronize()
    records = trace.drain()   # one dict per closed span

Tracing is off by default, and :func:`enable` / :func:`disable` is its one
switch. Off, :func:`span` checks a module flag and returns one shared null
context: no clock read, no CUDA event, no profiler mark, nothing kept.

On, each span records its ``name``, its host ``t0`` and ``t1`` by
``time.perf_counter()``, its ``thread``, its ``id`` and its ``parent``'s
(the span open around it on the same thread, or None), the ``batch`` it
belongs to (the stream's draw index, given by ``batch=`` or inherited from
the parent) and its ``attrs`` (counts). A span opened with ``cuda=True``
also records a start and an end CUDA event on the current stream; at
:func:`drain`, after the caller has synchronised, the pair becomes ``ms``.
While a ``torch.profiler`` session is active, each span also opens a
``record_function`` of its name, so it lies on the profiler's timeline
beside the device's operations.

Records go to a buffer of :data:`CAPACITY` records; when it is full the
oldest go first. The spans and the counts the port records (README,
"Tracing"):

- ``stream.produce`` (host, CUDA): one batch of ``SyntheticStream``, its
  host draws, fields, banks and ``batch_program``; ``volumes``.
- ``stream.join`` (host): the consumer waiting on the producer's thread.
- ``stream.compose`` (CUDA): the batch's seed composition; ``subjects``
  (distinct subjects in the batch), ``filled`` (banks built for it) and
  ``slab_bytes`` (the bank slab's bytes).
- ``core.intensity``, ``core.deform``, ``core.gamma``, ``core.bias``,
  ``core.resample_noise`` (CUDA): ``synth_core``'s stages.
- ``chain.blur_cortex``, ``chain.struct_noise``, ``chain.motion``,
  ``chain.boundaries`` (CUDA): the artifact chain, one a sample;
  ``chain.motion`` of a motion-on sample carries ``stacks_attempted`` and
  ``stacks_accepted``.
- ``chain.sync`` (host): the chain's one device-to-host read a batch.
- ``motion.stack`` (host): one accepted stack's acquisition and recon.
- ``bank.fill`` (host): the banks a fill builds (``subjects``, ``bytes``,
  ``threads``), each build's spans nested under it on its own thread.
- ``bank.decode``, ``bank.to_ras`` (the narrowing), ``bank.pin`` (the
  wait for a staging set) (host), ``bank.upload`` (CUDA: the copy and the
  orientation into the slot): a seed bank's build, its segmentation's too.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

# records kept until drained; the oldest go first
CAPACITY = 1 << 16

_on = False
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()
_ids = itertools.count(1)


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already open still record when they close."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is active (in any thread)."""
    return torch.autograd.profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Null:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()


class _Span:
    __slots__ = ("rec", "cuda", "_mark", "_ev0")

    def __init__(self, name: str, cuda: bool, attrs: dict):
        self.rec = {"name": name, "attrs": attrs}
        self.cuda = cuda

    def __enter__(self):
        stack = _stack()
        parent = stack[-1].rec if stack else None
        rec = self.rec
        rec["id"] = next(_ids)
        rec["parent"] = parent["id"] if parent else None
        rec["batch"] = rec["attrs"].pop("batch", parent["batch"] if parent else None)
        rec["thread"] = threading.get_ident()
        self._mark = None
        if _profiling():
            self._mark = torch.autograd.profiler.record_function(rec["name"])
            self._mark.__enter__()
        if self.cuda:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        stack.append(self)
        rec["t0"] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1"] = time.perf_counter()
        if self.cuda:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            rec["events"] = (self._ev0, ev1)
        _stack().pop()
        if self._mark is not None:
            self._mark.__exit__(*exc)
        _records.append(rec)
        return False

    def set(self, **attrs) -> None:
        """Attributes of the open span; ``batch=`` sets its batch (spans
        opened inside it after this inherit it)."""
        if "batch" in attrs:
            self.rec["batch"] = attrs.pop("batch")
        self.rec["attrs"].update(attrs)


def span(name: str, cuda: bool = False, **attrs):
    """A context manager that records ``name`` while tracing is on (the
    shared :data:`NULL` while it is off). ``cuda``: also time the current
    CUDA stream, for work on a CUDA device. ``attrs``: counts kept with the
    record; ``batch=`` the stream's draw index, which spans opened inside
    inherit."""
    if not _on:
        return NULL
    return _Span(name, cuda, attrs)


@contextlib.contextmanager
def under(parent):
    """Spans opened in this block on the calling thread nest under
    ``parent``, a span open on another thread (one that hands its work to a
    pool), and inherit its batch; nothing while ``parent`` is :data:`NULL`."""
    if not isinstance(parent, _Span):
        yield
        return
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def annotate(**attrs) -> None:
    """Attributes of this thread's innermost open span (nothing while
    tracing is off or no span is open)."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].set(**attrs)


def drain() -> list[dict]:
    """The records of the closed spans, in the order they closed, and an
    empty buffer. A CUDA span's events become ``ms`` here: call it once the
    device has finished the spans' work (it waits for any that has not)."""
    out = []
    while True:
        try:
            rec = _records.popleft()
        except IndexError:
            return out
        events = rec.pop("events", None)
        if events is not None:
            events[1].synchronize()
            rec["ms"] = events[0].elapsed_time(events[1])
        out.append(rec)
