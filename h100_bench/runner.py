"""One run of one cell: the general traffic generator, the measured window,
the traced window, the correctness check and the metrics.

The traffic is a closed loop on ``SyntheticStream``: one consumer asks the
stream for a batch, reads back a checksum of it (so the batch counts only
once the card has finished it) and asks again. Set-up builds the dataset
and the stream from the configuration and warms up every shape the traffic
uses (:data:`WARMUP_BATCHES` batches); where the traffic names the pins of
its heaviest draw (``worst_case``), a second stream on the same dataset and
seed banks first serves as many batches with those pins, from a fixed seed
(:func:`worst_case_warmup`). The window then runs for ``--seconds``.
A ``--trace 1`` run installs the spans, profiles the first
``trace_seconds`` of its window and leaves the rest unprofiled, for the
per-layer rates the profiler would slow.

One batch of the window, drawn from the seed, is copied to host memory as
it is served and compared with the plain reference once the window has
closed and the program's state is freed (:mod:`.check`).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import os
import tempfile
import time

import numpy as np

from . import check
from .manifest import HERE
from .spans import Recorder
from .trace import reduce as reduce_trace


def process_clock() -> float:
    """Seconds since this process started, by the kernel's clock (10 ms
    steps), or None where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def apply_flags(torch, flags: dict) -> None:
    """The configuration's process-wide matmul settings."""
    torch.backends.cuda.matmul.allow_tf32 = bool(flags.get("allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(flags.get("cudnn_allow_tf32", False))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bool(
        flags.get("allow_bf16_reduced_precision_reduction", False))


def build_dataset(config: dict):
    """The program's ``FetalSynthDataset`` as the configuration gives it."""
    from fetalsyngen_torch.config import instantiate

    ds = copy.deepcopy(config["dataset"])
    gen = ds.pop("generator")
    return instantiate(ds, generator=instantiate(gen))


def _checksum(batch) -> float:
    """A sum over a lattice of the batch's image: read back to the host, so
    it returns once the card has finished the batch."""
    return float(batch["image"][..., ::64, ::64, ::64].sum())


class _Keeper:
    """Copies one batch's image and label to host memory as it is served:
    into pinned buffers made at set-up, without blocking, on CUDA."""

    def __init__(self, torch, B: int, shape, device):
        self.cuda = device.type == "cuda"
        pin = dict(pin_memory=True) if self.cuda else {}
        self.image = torch.empty((B, *shape), dtype=torch.float32, **pin)
        self.label = torch.empty((B, *shape), dtype=torch.int32, **pin)
        self.index = None

    def keep(self, batch, index: int) -> None:
        self.image.copy_(batch["image"], non_blocking=self.cuda)
        self.label.copy_(batch["label"], non_blocking=self.cuda)
        self.index = index


# batches served in set-up, before the window, in every cell
WARMUP_BATCHES = 2

# the seed of the worst-case warm-up's stream: the same batches in every run
WORST_CASE_SEED = 0


def worst_case_warmup(ds, stream, traffic: dict) -> None:
    """Serve :data:`WARMUP_BATCHES` batches of the traffic's heaviest draw:
    a stream on the same dataset and seed banks as ``stream``, with the
    same batch size and prefetch, its draws pinned by ``traffic["worst_case"]``
    (``SyntheticStream``'s ``genparams``) and seeded by
    :data:`WORST_CASE_SEED`. Its shapes are the largest the traffic draws,
    and its batches are made as the window's are (by producer threads on the
    side stream, each while the last is held), so the peak of memory that
    the window can reach is reached in set-up, whatever the run's seed
    draws; ``stream``'s own draws are untouched."""
    pins = traffic.get("worst_case")
    if not pins:
        return
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    warm = SyntheticStream(ds, batch_size=stream.batch_size, seed=WORST_CASE_SEED, prefetch=stream.prefetch,
                           mix_subjects=stream.mix_subjects, genparams=pins)
    warm.banks = stream.banks
    it = iter(warm)
    for _ in range(WARMUP_BATCHES):
        _checksum(next(it))
    it.close()
    del it, warm
    gc.collect()


def pick_position(seed: int, compare: dict) -> int:
    """The window position from which the compared batch is taken, drawn from the seed."""
    return int(np.random.default_rng([seed, 7]).integers(0, int(compare.get("pick_from", 1))))


def compared(index: int, motion_on, seed: int, compare: dict) -> bool:
    """Whether the batch of stream position ``index`` (warm-up included),
    whose samples draw the motion artifact as ``motion_on`` says, may be the
    compared one: at or after the seed's draw, and accepted by the traffic's
    ``compare.require``. The run compares the first such batch; the control
    finds the same one from the reference's draws."""
    if index < WARMUP_BATCHES + pick_position(seed, compare):
        return False
    if compare.get("require") == "motion":
        return motion_on is not None and bool(np.any(motion_on))
    return True


def _motion_on(batch):
    return batch["meta"].get("scanner", {}).get("motion_on")


# batches drawn after the window, at most, for one the traffic's compare accepts
_MAX_AFTER = 64


def _all_threads(torch):
    """The profiler's setting that records the host operations of every
    thread (the stream's producer threads), where this torch has it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def load_reader(name: str, base=HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py`` (None if there is no such file)."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location("h100_bench_metric_" + name.replace(".", "_").replace("-", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(workload: dict, config: dict, traffic: dict, limits: dict, metrics: list[dict], seed: int,
        seconds: float, trace: bool, t_origin: float, device_name: str = "cuda", base=HERE) -> dict:
    """One run of ``workload``: its result line as a dict (with ``checks``,
    the numbers compared beside their limits, last)."""
    import torch

    device = torch.device(device_name)
    cuda = device.type == "cuda"
    apply_flags(torch, config.get("torch_flags", {}))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    recorder = Recorder()
    if trace:
        recorder.install(base=base)

    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    marks = {"start": t_origin()}
    ds = build_dataset(config)
    B = int(traffic["batch_size"])
    stream = SyntheticStream(ds, batch_size=B, seed=seed, prefetch=bool(traffic.get("prefetch", True)),
                             mix_subjects=int(traffic.get("mix_subjects", 1)))
    shape = tuple(config["dataset"]["generator"]["shape"])
    marks["stream"] = t_origin()
    keeper = _Keeper(torch, B, shape, device)
    marks["keeper"] = t_origin()
    compare = traffic.get("compare", {})
    worst_case_warmup(ds, stream, traffic)
    peak_worst_case = torch.cuda.max_memory_allocated() if cuda else 0
    marks["worst_case"] = t_origin()
    it = iter(stream)
    warmup = WARMUP_BATCHES
    for _ in range(warmup):
        _checksum(next(it))
    setup_s = t_origin()
    marks["warmup"] = setup_s

    trace_s = float(traffic.get("trace_seconds", 0)) if trace else 0.0
    waits, volumes, batches = [], 0, 0
    traced = {"volumes": 0, "batches": 0}
    prof = None
    profiling = contextlib.ExitStack()
    if trace_s > 0:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []),
                                      experimental_config=_all_threads(torch))
        profiling.enter_context(prof)
        profiling.enter_context(torch.profiler.record_function("window"))
    t0 = time.perf_counter()
    t_untraced = t0 if trace_s <= 0 else None
    untraced = {"volumes": 0, "batches": 0}
    t_last = t0
    while True:
        ta = time.perf_counter()
        batch = next(it)
        _checksum(batch)
        t_last = time.perf_counter()
        waits.append(t_last - ta)
        volumes += B
        batches += 1
        if t_untraced is None:
            traced["volumes"] += B
            traced["batches"] += 1
            if t_last - t0 >= trace_s:
                profiling.close()
                t_untraced = time.perf_counter()
        else:
            untraced["volumes"] += B
            untraced["batches"] += 1
        if keeper.index is None and compared(warmup + batches - 1, _motion_on(batch), seed, compare):
            keeper.keep(batch, warmup + batches - 1)
        del batch
        if t_last - t0 >= seconds:
            break
    profiling.close()
    window_s = t_last - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    extra = 0
    while keeper.index is None and extra < _MAX_AFTER:
        # a window too short to serve an eligible batch: the next one after it
        batch = next(it)
        if compared(warmup + batches + extra, _motion_on(batch), seed, compare):
            keeper.keep(batch, warmup + batches + extra)
        extra += 1
        del batch
    it.close()
    del it
    if cuda:
        torch.cuda.synchronize()
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    reduced = None
    if prof is not None:
        fd, trace_file = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(trace_file)
            from .trace import load

            reduced = reduce_trace(load(trace_file), annotations=list(recorder.calls))
        finally:
            os.unlink(trace_file)
        del prof
    recorder.resolve()
    recorder.uninstall()
    del stream, ds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers = check.compare(config, traffic, keeper, seed, device) if keeper.index is not None else {}
    ref_s = time.perf_counter() - t_ref
    checks, correct = check.judge(numbers, limits)

    ctx = {
        "setup_s": setup_s, "window_s": window_s, "volumes": volumes, "batches": batches, "batch_size": B,
        "waits_s": waits, "peak_bytes": peak, "trace": reduced, "traced": traced,
        "untraced": {**untraced, "t0": t_untraced, "t1": t_last}, "recorder": recorder, "device_kind": kind,
        "warmup_batches": warmup,
    }
    out = {}
    for m in metrics:
        read = load_reader(m["name"], base)
        value = read(ctx) if read is not None else None
        if value is None:
            continue
        extra = value if isinstance(value, dict) else {"value": value}
        out[m["name"]] = {"value": extra.pop("value"), "unit": m["unit"], **extra}
    result = {
        "correct": correct,
        "attempted": volumes,
        "failed": 0,
        "metrics": out,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(workload["chips"]), "memory_peak_bytes": int(peak)},
        "compared": {"batch_index": keeper.index, "batch_size": B, "reference_s": ref_s},
        "setup": {"to_run_s": marks["start"], "dataset_and_stream_s": marks["stream"] - marks["start"],
                  "pinned_buffers_s": marks["keeper"] - marks["stream"], "worst_case_s": marks["worst_case"] - marks["keeper"],
                  "warmup_s": marks["warmup"] - marks["worst_case"], "worst_case_peak_bytes": int(peak_worst_case)},
    }
    if reduced is not None:
        result["device"]["busy_s"] = reduced["busy_us"] / 1e6
        result["device"]["window_s"] = reduced["window_us"] / 1e6
        result["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    return result
