"""The profiler's trace reduced to what the per-layer metrics read: the
device's busy time and idle gaps inside the traced window, kernels by name
and count, and what the host was doing in each gap.

The trace is ``torch.profiler``'s Chrome trace (microseconds). The window
is the ``window`` annotation the runner puts around the traced batches, or
the profiler's own span (``PyTorch Profiler``) where the trace lost it.
"""

from __future__ import annotations

import bisect
import collections
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
COPY = re.compile(r"copy", re.I)
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass", re.I)


def short_name(name: str) -> str:
    """A kernel's name without its template and arguments: its function,
    and the operation it runs where the name carries one
    (``elementwise_kernel:direct_copy_kernel_cuda``)."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    cut = re.search(r"[<(]", name)
    head = (name[:cut.start()] if cut else name).split("::")[-1].strip() or name[:60]
    rest = name[cut.start():] if cut else ""
    inner = [i for i in re.findall(r"[A-Za-z_]\w*", rest)
             if i != head and not i.startswith("gpu_kernel")
             and re.search(r"_kernel_cuda|Functor|^launch_|_kernel_impl$|Ops$", i)]
    return (f"{head}:{inner[0]}" if inner else head)[:120]


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, merged and sorted."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_and_gaps(intervals, w0: float, w1: float):
    """(busy time, idle gaps) of device ``intervals`` clipped to [w0, w1]."""
    clipped = [(max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1]
    merged = union(clipped)
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return busy, gaps


class _HostIndex:
    """The host events of one thread, to name what covers a time: events
    longer than ``long_us`` are scanned whole, the short ones through a
    sorted index."""

    def __init__(self, events, long_us: float = 1000.0):
        self.long = [e for e in events if e.get("dur", 0) > long_us]
        self.short = sorted((e for e in events if e.get("dur", 0) <= long_us), key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.short]
        self.long_us = long_us

    def covering(self, t: float) -> list[dict]:
        out = [e for e in self.long if e["ts"] <= t < e["ts"] + e["dur"]]
        i = bisect.bisect_right(self.starts, t)
        lo = bisect.bisect_left(self.starts, t - self.long_us)
        out += [e for e in self.short[lo:i] if e["ts"] + e.get("dur", 0) > t]
        return out


def reduce(trace: dict, annotations=()) -> dict | None:
    """The trace's numbers inside its ``window`` annotation (None if it has
    none). ``annotations`` are the span names, used to name idle gaps by the
    layers the host was in."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == "window"]
    # the profiler's own span where the annotation was lost: it opens just
    # before the annotation and closes just after it
    windows = windows or [e for e in events if e.get("cat") == "Trace" and e.get("name") == "PyTorch Profiler"]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] < w1]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy, gaps = busy_and_gaps([(e["ts"], e["ts"] + e["dur"]) for e in dev], w0, w1)
    by_name = collections.Counter()
    for e in kernels:
        by_name[short_name(e["name"])] += e["dur"]
    for e in dev:
        if e["cat"] != "kernel":
            by_name[e["name"]] += e["dur"]
    # the host threads that run the layers (the stream's producers, one a
    # batch): those with the spans' marks
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") in set(annotations)]
    threads = {(e["pid"], e["tid"]) for e in marks}
    host = None
    if threads:
        host = _HostIndex([e for e in events if e.get("cat") in HOST_CATS and (e["pid"], e["tid"]) in threads])
    named = collections.Counter()
    for s, e in gaps:
        parts = []
        if host is not None:
            cover = sorted(host.covering((s + e) / 2), key=lambda x: x["ts"])
            parts = [c["name"] for c in cover if c.get("cat") == "user_annotation"]
            inner = [c["name"] for c in cover if c.get("cat") != "user_annotation"]
            if inner:
                parts.append(inner[-1])
        named["/".join(parts) or "outside the layers"] += e - s
    return {
        "window_us": w1 - w0,
        "busy_us": busy,
        "kernels": len(kernels),
        "kernel_us": sum(e["dur"] for e in kernels),
        "copy_us": sum(e["dur"] for e in kernels if COPY.search(e["name"])),
        "gemm_us": sum(e["dur"] for e in kernels if GEMM.search(e["name"])),
        "device_ops": [[n, us / 1e6] for n, us in by_name.most_common(10)],
        "idle_gaps": [[n, us / 1e6] for n, us in named.most_common(10)],
    }


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)
