"""The input stream: seed banks in device memory, seed composition on the
device, the SR-artifact chain, side-stream prefetch (port of
``fetalsyngen_tpu.parallel.input_pipeline``).

The dataset path decodes four seed NIfTIs on the host for every sample. The
stream instead decodes every (subcluster count, meta-label) seed volume of a
subject once, natively (:mod:`fetalsyngen_torch.io.native`), and keeps it as
an int8 bank ``(n_options, 4, D, H, W)`` in device memory. Each batch element
draws its subject and its four subcluster counts, gathers the four chosen
int8 volumes and sums them on the device, and the batch runs through
:func:`~fetalsyngen_torch.generator.pipeline.synth_core`. The generator's SR
artifacts then run per element, in the reference's order (blur_cortex ->
struct_noise -> simulate_motion -> boundaries,
:func:`~fetalsyngen_torch.generator.artifacts.batched.apply_chain`), before
each image is divided by its peak. With ``prefetch`` the next batch is
generated on a side CUDA stream while the caller holds the current one.

The batch program runs in the stream's bf16 production mode, as the JAX
stream's does (:func:`_production_scopes`: one-pass bf16 matmuls and bf16
intermediates, ``ops.linops``); ``FSG_STREAM_BF16=0`` rolls it back to the
f32 contract. The dataset API stays f32.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import trace
from ..generator.artifacts.batched import ChainSpec, QualityArtifacts, apply_chain, chain_draws, pack_motion
from ..generator.artifacts.scanner import slice_grid
from ..generator.pipeline import draw_fields, make_generators, synth_core
from ..generator.params import sample_params
from ..io import native, nifti
from ..ops.linops import DEFAULT, precision_scope, storage_scope
from ..ops.numerics import device_const
from ..train.step import resolve_device


@contextlib.contextmanager
def _production_scopes():
    """The stream's bf16 production mode (``precision_scope(DEFAULT)`` and
    ``storage_scope(bfloat16)``) for the calling thread, or, under
    ``FSG_STREAM_BF16=0``, the f32 contract (the JAX stream's rollback)."""
    if os.environ.get("FSG_STREAM_BF16", "1") == "0":
        yield
        return
    with precision_scope(DEFAULT), storage_scope(torch.bfloat16):
        yield

# One side stream per CUDA device, made at first use and shared by every
# stream's producer: the ring kernels keep a tile counter per (device,
# stream) in a fixed table of 64 (csrc/ring.cuh, tile_counter), so a stream
# per batch or per iterator would exhaust it.
_SIDE_STREAMS: dict[int, torch.cuda.Stream] = {}
_SIDE_LOCK = threading.Lock()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The prefetch stream of CUDA ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _SIDE_LOCK:
        if index not in _SIDE_STREAMS:
            _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
        return _SIDE_STREAMS[index]


def compose_seeds(bank: torch.Tensor, choices: torch.Tensor) -> torch.Tensor:
    """Sum the seed variants chosen per meta-label from a bank (the device
    counterpart of ``ImageFromSeeds.load_seeds``).

    The four chosen int8 volumes are gathered first and widened in the sum:
    widening the bank first would move n_options x 4 volumes at 4 bytes
    instead of 4 volumes at 1 byte.

    Args:
        bank: (n_options, 4, D, H, W) int8.
        choices: (4,) integer, the option index per meta-label (0-based).

    Returns:
        (D, H, W) int32 seed volume.
    """
    picked = bank[choices.long(), torch.arange(4, device=bank.device)]
    return picked.sum(0, dtype=torch.int32)


def choose_options(u: torch.Tensor, hi: torch.Tensor, lo: int) -> torch.Tensor:
    """(B, 4) int32 option per meta-label from (B, 4) f32 uniforms ``u`` and
    each element's (B,) option count ``hi``: ``lo + floor(u * (hi - lo))``
    in f32, clipped to ``[lo, hi - 1]``."""
    ch = torch.floor(u * (hi - lo).to(torch.float32)[:, None]).to(torch.int32) + lo
    return torch.minimum(torch.clamp_min(ch, lo), (hi - 1)[:, None])


def _take_rows(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``t[rows]`` for a contiguous (N, V) tensor, gathered as 8-byte words
    where a row holds whole words: the indexing kernel's cost goes by
    elements, so int8 rows gather several times slower than the same bytes
    as int64."""
    if (t.shape[1] * t.element_size()) % 8:
        return t[rows]
    return t.view(torch.int64)[rows].view(t.dtype)


def batch_program(banks, segs, hi, slots, subj, u, p, fields, cfg, lo: int, chain=None, attrs=None):
    """One batch (the body of the JAX stream's batch program).

    Args:
        banks: (C, n_options, 4, D, H, W) int8 seed banks, one a slot
            (:class:`SeedBankCache`'s slab).
        segs: (C, D, H, W) int16 segmentations, one a slot.
        hi: (C,) int32 usable options per slot.
        slots: (S,) int64 slot of each resident subject.
        subj: (B,) int64 resident subject per element.
        u: (B, 4) f32 uniforms choosing the options (:func:`choose_options`).
        p, fields: the batch's ``GenParams`` and ``Fields``.
        cfg: the generator config; ``lo`` the lowest option index.
        chain: None, or a callable ``(image, labels) -> image`` run on the
            synthesised batch before the division (the artifact chain).
        attrs: counts kept with the ``stream.compose`` span.

    The core and the chain run in the production mode
    (:func:`_production_scopes`, entered here, in the calling thread).

    Returns:
        (image, label): (B, D, H, W) f32 divided by each sample's peak where
        it is positive, and int32 labels.
    """
    C, n_opt = banks.shape[:2]
    vol = banks.shape[3:]
    with trace.span("stream.compose", cuda=banks.is_cuda, **(attrs or {})):
        slot = slots[subj]
        ch = choose_options(u, hi[slot], lo)
        rows = (slot[:, None] * n_opt + ch.long()) * 4 + torch.arange(4, device=banks.device)
        picked = _take_rows(banks.reshape(C * n_opt * 4, -1), rows)  # (B, 4, D*H*W) int8
        seeds = picked.sum(1, dtype=torch.int32).reshape(-1, *vol)
        del picked
        seg = _take_rows(segs.reshape(C, -1), slot).reshape(-1, *vol).to(torch.int32)
    with _production_scopes():
        out, seg, _ = synth_core(p, fields, seeds, seg, cfg)
        out = out.float()
        if chain is not None:
            out = chain(out, seg)
    peak = out.amax(dim=(1, 2, 3), keepdim=True)
    return out / torch.where(peak > 0, peak, 1.0), seg


def _narrow_into(dst: torch.Tensor, a: np.ndarray) -> None:
    """A decoded volume ``a`` (Fortran-ordered, as NIfTI stores it) narrowed
    to ``dst``'s type into the flat ``dst``, in its own order: one
    sequential pass, no transpose (:func:`_orient_into` reorients)."""
    np.copyto(dst.numpy().reshape(a.shape[::-1]), a.T, casting="unsafe")


def _orient_into(dst: torch.Tensor, flat: torch.Tensor, affine: np.ndarray) -> None:
    """``nifti.to_ras`` of a volume narrowed in its own order (``flat``, on
    ``dst``'s device), written into the (D, H, W) ``dst``: the transposing
    copy runs where ``dst`` lives (on the card, the host's slowest step of a
    bank's build is gone)."""
    ornt = nifti.io_orientation(affine)
    perm = np.argsort(ornt[:, 0])
    flips = ornt[perm.astype(int), 1]
    shape = [int(n) for n in np.asarray(dst.shape)[np.argsort(perm)]]  # the volume's own axes
    t = flat.view(shape[::-1]).permute(2, 1, 0).permute(*perm.tolist())
    dims = [d for d in range(3) if flips[d] < 0]
    dst.copy_(t.flip(dims) if dims else t)


# banks built at once by SeedBankCache.fill: host threads, each with a
# staging set of its own for the fill
FILL_THREADS = min(8, os.cpu_count() or 1)

# the bank caches' counts, for tests and chip_smoke.py: banks built into a
# slot, lookups served from the slab, banks evicted from it
BANK_COUNTS = {"fills": 0, "hits": 0, "evictions": 0}


class SeedBankCache:
    """Seed banks in one slab of device memory, an LRU keyed by subject name.

    A subject's bank, every (option, meta-label) seed volume at int8, goes
    into a slot of one int8 slab ``(capacity, n_options, 4, D, H, W)``, and
    its segmentation (where ``seg_paths`` names it) into the same slot of an
    int16 slab ``(capacity, D, H, W)``; a batch gathers its rows through the
    slots, so no bank is ever copied a second time. Both slabs are made at
    the first bank built. ``capacity`` is the smaller of the number of
    subjects and ``max_bytes`` over one bank's bytes (at least one); past
    it, the least recently used bank leaves its slot to the next, except the
    banks of the fill in progress. ``max_bytes`` defaults to half the card's
    memory on CUDA (an H100 80GB: 39.8 GiB, 106 banks of 6 options at 256^3,
    0.375 GiB each) and to the JAX package's 1.2 GB on the CPU; a smaller
    ``max_bytes`` trades device memory for rebuilds where a stream rotates
    through a cohort larger than its slots. Each subject has a slot of its
    own, whatever its files: banks are keyed by name.

    The banks live on ``device``: None means CUDA, which raises without a
    card (``device="cpu"`` keeps them in host memory). A build decodes into
    a staging set (a filling thread's own for the whole fill, else one for
    the build; pinned on CUDA, through PyTorch's caching host allocator) and
    narrows each volume in its files' order; on CUDA each volume then goes
    to the card with a non-blocking copy on the current stream and is
    reoriented there into its slot, the transposing copy the host would
    take longest over. The slabs follow
    the CUDA streams that use them: a fill or a lookup on another stream
    than the last user's first waits for that user's work
    (:meth:`mark_used`). ``records[name]`` says how the bank was built:
    ``reader`` ("native" or "python") and ``bytes``. With tracing on
    (:mod:`fetalsyngen_torch.trace`) a build records the spans
    ``bank.decode``, ``bank.to_ras`` (the narrowing) and, on CUDA,
    ``bank.pin`` (making or waiting for the staging set) and ``bank.upload`` (the
    copies and the reorientation on the card); :meth:`fill` records
    ``bank.fill`` around its builds.
    """

    def __init__(self, seed_paths: dict, max_bytes: int | None = None, device=None, seg_paths: dict | None = None):
        self.seed_paths = seed_paths
        self.seg_paths = seg_paths
        self.device = resolve_device(device)
        if max_bytes is None:
            max_bytes = (torch.cuda.get_device_properties(self.device).total_memory // 2
                         if self.device.type == "cuda" else 1_200_000_000)
        self.max_bytes = max_bytes
        self.records: dict[str, dict] = {}
        self._cache: collections.OrderedDict[str, int] = collections.OrderedDict()  # name -> slot
        self._bytes = 0
        self.banks: torch.Tensor | None = None
        self.segs: torch.Tensor | None = None
        self.capacity = 0
        self._free: list[int] = []
        self._opts: list[int] = []  # options of the bank in each slot
        self._option_bytes = 0  # one option's four volumes
        self._keep: set[str] = set()  # the names of the fill in progress
        self.filled = 0  # banks the last fill built
        self._lock = threading.Lock()
        self._local = threading.local()  # a filling thread's staging set (``staging``)
        self._last_use: tuple | None = None  # (stream, event) of the slabs' last user

    @property
    def nbytes(self) -> int:
        """Bytes of the banks held (each of its own options)."""
        return self._bytes

    @property
    def slab_bytes(self) -> int:
        """Bytes of the bank slab (0 before the first bank)."""
        return 0 if self.banks is None else self.banks.numel()

    def options(self, name: str) -> list[int]:
        return sorted(self.seed_paths[name].keys())

    def _load_into(self, name: str, out: torch.Tensor, raw: np.ndarray) -> tuple[str, list]:
        """Decode every (option, meta-label) seed volume of one subject
        through the int32 buffer ``raw`` and narrow each to int8 in its own
        order into a row of ``out`` ((n_options * 4, D*H*W)); returns the
        reader used and each volume's affine (:func:`_orient_into` orients).

        The native loader decodes all volumes at once, oriented by the first
        volume's affine; without it, or where it refuses a volume, the
        Python reader decodes each.
        """
        per_sub = self.seed_paths[name]
        paths = [str(per_sub[n][m]) for n in self.options(name) for m in range(1, 5)]
        if native.available():  # builds the library at first use
            with trace.span("bank.decode", volumes=len(paths)):
                shape, affine = nifti.load_header(paths[0])
                vols = native.load_labels_batch(paths, shape, raw)
            if vols is not None:
                with trace.span("bank.to_ras", volumes=len(paths)):
                    for dst, a in zip(out, vols):
                        _narrow_into(dst, a)
                return "native", [affine] * len(paths)
        affines = []
        for dst, path in zip(out, paths):
            with trace.span("bank.decode", volumes=1):
                img = nifti.load(path)
            with trace.span("bank.to_ras", volumes=1):
                _narrow_into(dst, img.data)
            affines.append(img.affine)
        return "python", affines

    def _follow(self) -> None:
        """Order the current CUDA stream after the slabs' last user."""
        last = self._last_use
        if last is not None and last[0] != torch.cuda.current_stream(self.device):
            torch.cuda.current_stream(self.device).wait_event(last[1])

    def mark_used(self) -> None:
        """Record the current CUDA stream as the slabs' last user: a fill or
        a lookup on another stream waits for the work enqueued so far."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._last_use = (torch.cuda.current_stream(self.device), event)

    def _make_slabs(self, name: str) -> None:
        """The slabs, sized by the volumes of ``name``'s first seed file
        (under the lock, at the first bank)."""
        vol = tuple(nifti.load_header(str(next(iter(self.seed_paths[name][self.options(name)[0]].values()))))[0])
        n_opt = max(len(v) for v in self.seed_paths.values())
        self._option_bytes = 4 * int(np.prod(vol))
        self.capacity = min(len(self.seed_paths), max(1, self.max_bytes // (n_opt * self._option_bytes)))
        self.banks = torch.empty((self.capacity, n_opt, 4, *vol), dtype=torch.int8, device=self.device)
        if self.seg_paths:
            self.segs = torch.empty((self.capacity, *vol), dtype=torch.int16, device=self.device)
        self._free = list(range(self.capacity - 1, -1, -1))
        self._opts = [0] * self.capacity

    def _too_many(self, n: int) -> RuntimeError:
        return RuntimeError(
            f"SeedBankCache: the {n} subjects of one fill need a slot each, but "
            f"max_bytes={self.max_bytes} holds {self.capacity} banks of {self.banks[0].numel()} bytes; "
            "raise max_bytes or lower mix_subjects"
        )

    def _slot(self) -> int:
        """A slot for a new bank (under the lock): free, else the least
        recently used bank's that is not in the fill in progress."""
        if self._free:
            return self._free.pop()
        for old, slot in self._cache.items():
            if old not in self._keep:
                del self._cache[old]
                self._bytes -= self._opts[slot] * self._option_bytes
                BANK_COUNTS["evictions"] += 1
                return slot
        raise self._too_many(len(self._keep))

    def _staged(self) -> dict:
        """A staging set whose last copies have completed: a bank's volumes
        (``bank``, (n_options * 4, D*H*W) int8) and a segmentation (``seg``,
        (D*H*W,) int16) in their files' order, pinned on CUDA, and an int32
        decode buffer (``raw``). A thread in a fill keeps its set for the
        fill's later builds (:meth:`fill` drops it); any other build makes
        one of its own."""
        st = getattr(self._local, "staging", None)
        if st is not None:
            if st["event"] is not None:
                st["event"].synchronize()
            return st
        cuda = self.device.type == "cuda"
        V = self.banks[0, 0, 0].numel()
        bank = torch.empty((self.banks[0].numel() // V, V), dtype=torch.int8, pin_memory=cuda)
        st = {
            "bank": bank,
            "seg": None if self.segs is None else torch.empty(V, dtype=torch.int16, pin_memory=cuda),
            "raw": np.empty(bank.numel(), np.int32),
            "event": None,
        }
        if getattr(self._local, "filling", False):
            self._local.staging = st
        return st

    def _build(self, name: str) -> int:
        """Build ``name``'s bank (and segmentation) into a slot: decoded into
        a staging set, then copied into the slot, on CUDA without blocking on
        the current stream. Returns the slot; a build that fails leaves its
        slot free."""
        with self._lock:
            if self.banks is None:
                self._make_slabs(name)
        n = len(self.options(name))
        cuda = self.device.type == "cuda"
        with trace.span("bank.pin", bytes=n * self._option_bytes) if cuda else contextlib.nullcontext():
            st = self._staged()
        bank, seg = st["bank"][: 4 * n], st["seg"]
        reader, affines = self._load_into(name, bank, st["raw"])
        if seg is not None:
            with trace.span("bank.decode", volumes=1):
                img = nifti.load(str(self.seg_paths[name]))
            with trace.span("bank.to_ras", volumes=1):
                _narrow_into(seg, img.data)
            affines.append(img.affine)
        with self._lock:
            slot = self._slot()
        try:
            dsts = list(self.banks[slot, :n].flatten(0, 1)) + ([self.segs[slot]] if seg is not None else [])
            srcs = list(bank) + ([seg] if seg is not None else [])
            with trace.span("bank.upload", cuda=True, bytes=n * self._option_bytes) if cuda else contextlib.nullcontext():
                # each volume to the card as it is, reoriented there
                card = torch.empty(2 * bank.shape[1], dtype=torch.uint8, device=self.device) if cuda else None
                for dst, src, affine in zip(dsts, srcs, affines):
                    if cuda:
                        src = card[: src.nbytes].view(src.dtype).copy_(src, non_blocking=True)
                    _orient_into(dst, src, affine)
            if cuda:
                st["event"] = torch.cuda.Event()
                st["event"].record()
        except BaseException:
            with self._lock:
                self._free.append(slot)
            raise
        with self._lock:
            self.records[name] = {"reader": reader, "bytes": n * self._option_bytes}
            self._opts[slot] = n
            if name in self._cache:  # built twice at once: the other slot serves
                self._free.append(slot)
                return self._cache[name]
            self._cache[name] = slot
            self._bytes += n * self._option_bytes
            BANK_COUNTS["fills"] += 1
        return slot

    def bank(self, name: str) -> torch.Tensor:
        """The (n_options, 4, D, H, W) int8 bank of subject ``name``, a view
        of its slot, ready for use on the current stream; built into a slot
        if absent."""
        if self.device.type == "cuda":
            self._follow()
        with self._lock:
            slot = self._cache.get(name)
            if slot is not None:
                self._cache.move_to_end(name)
                BANK_COUNTS["hits"] += 1
        if slot is None:
            slot = self._build(name)
        self.mark_used()
        return self.banks[slot, : self._opts[slot]]

    def _filling(self, name: str) -> None:
        """:meth:`bank` of ``name`` on a fill's thread, which keeps one
        staging set for all its builds."""
        self._local.filling = True
        self.bank(name)

    def fill(self, names) -> int:
        """Make the banks of ``names`` resident: the absent ones are built
        by :meth:`bank` on up to :data:`FILL_THREADS` host threads, each
        copying into its slot on the caller's current stream; none of
        ``names`` is evicted meanwhile. More names than slots raise before
        any build. Afterwards ``names`` are the most recently used, in their
        order. Returns the number built (also kept in ``filled``)."""
        names = list(dict.fromkeys(names))
        with self._lock:
            absent = [n for n in names if n not in self._cache]
            if absent and self.banks is None:
                self._make_slabs(absent[0])
            if absent and len(names) > self.capacity:
                raise self._too_many(len(names))
            BANK_COUNTS["hits"] += len(names) - len(absent)
            self._keep = set(names)
        try:
            if absent:
                threads = min(len(absent), FILL_THREADS)
                with trace.span("bank.fill", subjects=len(absent), threads=threads) as sp:
                    if threads == 1:
                        for name in absent:
                            self._filling(name)
                    else:
                        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

                        def build(name):
                            with trace.under(sp), (torch.cuda.stream(stream) if stream is not None
                                                   else contextlib.nullcontext()):
                                self._filling(name)

                        with ThreadPoolExecutor(threads, thread_name_prefix="fsg-bank-fill") as pool:
                            list(pool.map(build, absent))
                    sp.set(bytes=sum(self.records[n]["bytes"] for n in absent))
            elif self.device.type == "cuda":
                self._follow()
        finally:
            self._keep = set()
            vars(self._local).clear()  # the caller's staging set (the pool's went with its threads)
        with self._lock:
            for n in names:
                self._cache.move_to_end(n)
        self.filled = len(absent)
        return self.filled

    def slots(self, names) -> list[int]:
        """The slot of each of ``names`` (resident)."""
        return [self._cache[n] for n in names]

    def slot_options(self) -> list[int]:
        """The options of the bank in each slot (0 where none)."""
        return list(self._opts)


class SyntheticStream:
    """Iterator of device-generated batches from a ``FetalSynthDataset``.

    Each batch mixes subjects per element from the resident subjects' seed
    banks, composes each element's seeds on the device and runs the batch
    through ``synth_core``; the images are divided by each sample's peak.
    The stream runs on the dataset generator's device (CUDA unless the
    generator says ``device: cpu``). With ``prefetch`` a producer thread
    generates the next batch on the device's side stream while the caller
    holds the current one; one producer runs at a time, so the host draws
    keep their order and prefetch on and off give the same batches. An
    iterator closed with a batch in flight hands that batch's ``meta`` back
    to the stream, and the next batch any iterator draws is the earliest
    handed back, so closing an iterator skips no draws and returned draws
    come back in their order. A batch whose generation failed is not drawn
    again.

    Host draws: the subject of each element comes from
    ``np.random.default_rng(seed)`` as in the JAX stream, and so does the
    motion artifact's geometry (:func:`pack_motion`, drawn before the
    subjects, as the JAX stream draws it): one seed gives the JAX stream's
    residents, subjects and pack. Each element's integer seed, which seeds
    its ``torch.Generator`` for the parameters and voxel fields and its
    artifact draws (:func:`chain_draws`), and the (B, 4) uniforms that
    choose its options come from a second generator derived from ``seed``.
    Every batch carries them in ``"meta"`` (with the pack and, when the
    motion artifact is configured, ``"scanner"``: the effective per-sample
    slice resolution, thickness and gap in mm); :meth:`replay_batch` and
    :meth:`replay_sample` re-create a batch or one element bit for bit on
    the same device. ``banks`` is the stream's :class:`SeedBankCache`.

    Args:
        artifacts: run the generator's configured SR artifacts (default).
        mix_subjects: subjects resident at once (elements draw uniformly
            among them); the resident set rotates by one subject per batch
            when the dataset has more. The banks' slots hold up to
            ``banks.max_bytes`` (:class:`SeedBankCache`; set it before the
            first batch, which makes the slab).
        cube: the motion engine's static cube tiers (an int or a tuple);
            by default every tier of the motion artifact's ``tiers`` that
            the configured slice-resolution range can need
            (``scanner.slice_grid``), so no draw is clamped.
        ns_grid: the slice grid; by default the smallest multiple of 32
            covering ``max(shape) * res / gap_min + 2`` (at least 64, at most
            the artifact's ``ns_grid``).
        small_tier: samples whose slice FOV fits the smallest 128-multiple
            buffer holding the volume run the motion engine there, in px
            units (``FSG_SMALL_TIER=0`` turns it off).
        dz_split: the dz-split on the stacks that allow it
            (``FSG_DZ_SPLIT=1/0`` forces it).
        coarse_w: the recon weight on pooled grids (``FSG_COARSE_W=1/0``
            forces it).
        genparams: pins, read under ``"artifacts"`` or ``"artifact_params"``:
            ``simulate_motion: {resolution_slice | resolution_slice_fac (mm),
            slice_thickness, gap, apply}`` pins the scanner's draws and its
            gate; a non-empty ``blur_cortex`` / ``struct_noise`` /
            ``boundaries`` dict forces that artifact on, ``{"apply": False}``
            off, for every sample.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        seed: int = 0,
        prefetch: bool = True,
        artifacts: bool = True,
        mix_subjects: int = 2,
        cube: int | tuple | None = None,
        ns_grid: int | None = None,
        small_tier: bool = True,
        dz_split: bool = True,
        coarse_w: bool = True,
        genparams: dict | None = None,
    ):
        gen = dataset.generator
        self.device = torch.device(getattr(gen, "device", None) or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SyntheticStream: the generator's device {self.device} means CUDA, but "
                "torch.cuda.is_available() is false; set the generator's `device: cpu`"
            )
        self.dataset = dataset
        self.cfg = gen.cfg
        self.batch_size = batch_size
        self.prefetch = prefetch
        gp = {k: v for k, v in (genparams or {}).items() if v is not None}
        self.genparams = gp
        self.artifact_pins = {
            k: v for k, v in (gp.get("artifacts", gp.get("artifact_params")) or {}).items() if v is not None
        }
        self._sm_gp = dict(self.artifact_pins.get("simulate_motion") or {}) or None

        def gate_of(name: str) -> int:
            sub = {k: v for k, v in (self.artifact_pins.get(name) or {}).items() if v is not None}
            return -1 if not sub else 0 if sub.get("apply") is False else 1

        g = [gate_of(n) for n in ("blur_cortex", "struct_noise", "boundaries")]
        self._gates = np.asarray(g, np.int32) if any(x >= 0 for x in g) else None

        arts = (getattr(gen, "artifacts", None) or {}) if artifacts else {}
        self._sm = arts.get("simulate_motion")
        qa = QualityArtifacts.from_generator(gen) if artifacts else QualityArtifacts()
        has_quality = any(a is not None for a in (qa.blur_cortex, qa.struct_noise, qa.boundaries))
        shape = tuple(self.cfg.shape)
        res0 = float(self.cfg.resolution[0])
        tiers = tuple(self._sm.tiers) if self._sm is not None else (384, 512, 640)
        if cube is None:
            if self._sm is not None:
                # every tier the configured res_slice range can need
                sp = self._sm.scanner_args
                rs_lo = float(sp.resolution_slice_fac_min)
                rs_hi = min(float(sp.resolution_slice_fac_max), float(sp.resolution_slice_max) / res0)
                t_small = slice_grid(shape, rs_hi, sp.slice_size, tiers)
                t_big = slice_grid(shape, rs_lo, sp.slice_size, tiers)
                cubes = tuple(t for t in sorted(tiers) if t_small <= t <= t_big)
            else:
                cubes = (int(min((c for c in tiers if c >= max(shape)), default=max(tiers))),)
        else:
            cubes = tuple(int(c) for c in cube) if isinstance(cube, (tuple, list)) else (int(cube),)
        self.cubes = cubes
        self.cube = cubes[0] if len(cubes) == 1 else cubes
        if ns_grid is None:
            # the scanner never makes more than max(shape) * res / gap_min + 2
            # slices a stack: the smallest multiple of 32 covering that
            ns_grid = getattr(self._sm, "ns_grid", 128)
            if self._sm is not None:
                need = int(max(shape) * res0 / float(self._sm.scanner_args.gap_min)) + 2
                ns_grid = min(ns_grid, max(64, -(-need // 32) * 32))
        self.ns_grid = int(ns_grid)
        sc = ((max(shape) + 127) // 128) * 128
        if os.environ.get("FSG_SMALL_TIER", "1") == "0":
            small_tier = False
        self.small_cube = sc if (small_tier and sc < self.cubes[0]) else None
        env = os.environ.get("FSG_DZ_SPLIT")
        self.dz_split = env == "1" if env in ("0", "1") else bool(dz_split)
        env = os.environ.get("FSG_COARSE_W")
        self.coarse_w = env == "1" if env in ("0", "1") else bool(coarse_w)
        self.chain = None
        if has_quality or self._sm is not None:
            self.chain = ChainSpec(
                qa if has_quality else None, self._sm, shape, self.cube, self.ns_grid, self.small_cube,
                self.dz_split, self.coarse_w,
            )

        self._rng = np.random.default_rng(seed)
        self._draws = np.random.default_rng([seed, 1])
        seg_paths = {dataset._sub_ses_idx(i): path for i, path in enumerate(dataset.segm_paths)}
        self.banks = SeedBankCache(dataset.seed_paths, device=self.device, seg_paths=seg_paths)
        self._names = sorted(dataset.seed_paths.keys())
        self._i = 0
        self._lo = max(self.cfg.intensity.min_subclusters - 1, 0)
        self.mix_subjects = max(1, min(int(mix_subjects), len(self._names)))
        self._want: tuple[str, ...] = ()
        # (draw index, meta) of batches drawn but never yielded (their
        # iterator was closed with them in flight), a heap: drawn again, in
        # the order they were first drawn, before new values
        self._returned: list[tuple[int, dict]] = []
        self._n_drawn = 0
        # one batch (or replay) at a time: the resident set and the bank
        # cache are shared by producers and replays
        self._lock = threading.RLock()
        # the host draws and the returned metas: a closing iterator takes
        # only this lock, so it hands its batch back without waiting for
        # another iterator's batch to be generated
        self._meta_lock = threading.Lock()

    def _banks_for(self, resident) -> tuple:
        """The batch program's (banks, segs, hi, slots) for the ``resident``
        names of a meta: the slabs, each slot's usable options and each
        resident's slot, after :meth:`SeedBankCache.fill` has built the
        absent banks (host I/O only then)."""
        self.banks.fill(resident)
        maxsub = self.cfg.intensity.max_subclusters
        hi = [min(maxsub, n) for n in self.banks.slot_options()]
        return (
            self.banks.banks,
            self.banks.segs,
            device_const(hi, torch.int32, self.device),
            device_const(self.banks.slots(resident), torch.int64, self.device),
        )

    def make_chain(self, meta: dict, draws=None, traces=None):
        """The batch program's artifact chain for ``meta`` (None without
        artifacts): :func:`apply_chain` with the batch's pack and the
        elements' :func:`chain_draws` (or ``draws``, a list of ``Draws``);
        ``traces`` as :func:`apply_chain` takes it."""
        if self.chain is None:
            return None
        if draws is None:
            draws = chain_draws(meta["seeds"], self.device)
        pack = meta.get("pack", {})
        return lambda out, seg: apply_chain(out, seg, self.chain, pack, draws, traces)

    def _run(self, meta: dict, **chain_kw):
        """The batch of ``meta`` (under the stream's lock)."""
        dev = self.device
        banks = self._banks_for(meta["resident"])
        gens = make_generators(meta["seeds"], dev)
        p = sample_params(gens, self.cfg)
        fields = draw_fields(gens, self.cfg, dev)
        subj = device_const(meta["subj"], torch.int64, dev)
        u = device_const(meta["u"], torch.float32, dev)
        attrs = {"subjects": len(set(meta["resident"][int(s)] for s in meta["subj"])),
                 "filled": self.banks.filled, "slab_bytes": self.banks.slab_bytes}
        images, labels = batch_program(*banks, subj, u, p, fields, self.cfg, self._lo,
                                       self.make_chain(meta, **chain_kw), attrs)
        self.banks.mark_used()
        return {
            "image": images,
            "label": labels,
            "name": tuple(meta["resident"][int(s)] for s in meta["subj"]),
            "meta": meta,
        }

    def _draw(self) -> tuple[int, dict]:
        """The next batch's draw index and host draws (under the meta lock):
        the earliest meta handed back by a closed iterator first, else new
        draws. The residents advance by one subject a draw (round-robin)
        when the dataset has more subjects than ``mix_subjects``."""
        if self._returned:
            return heapq.heappop(self._returned)
        index, self._n_drawn = self._n_drawn, self._n_drawn + 1
        B = self.batch_size
        if not self._want or len(self._names) > self.mix_subjects:
            self._want = tuple(self._names[(self._i + j) % len(self._names)] for j in range(self.mix_subjects))
            self._i += 1
        meta = {
            "seeds": self._draws.integers(0, 2**31 - 1, B),
            "u": self._draws.random((B, 4), dtype=np.float32),
            "resident": self._want,
            "batch_size": B,
        }
        pack = {}
        if self._sm is not None:
            # the motion geometry first, then the subjects: the JAX stream's
            # order of draws from this rng
            pack = pack_motion(
                self._rng, B, tuple(self.cfg.shape), float(self.cfg.resolution[0]), self._sm, self.cube,
                self.ns_grid, small_cube=self.small_cube, genparams=self._sm_gp, with_record=True,
            )
            meta["scanner"] = pack.pop("_record")
        if self._gates is not None:
            pack["gates"] = np.broadcast_to(self._gates, (B, 3)).copy()
        if self.chain is not None:
            meta["pack"] = pack
        # subject per element, drawn as the JAX stream draws it
        meta["subj"] = self._rng.integers(0, len(self._want), B)
        return index, meta

    def _generate(self, box: dict | None = None, **chain_kw) -> dict | None:
        """The next batch; ``chain_kw`` as :meth:`make_chain` takes them.
        For a producer, ``box`` receives the batch's draw index and meta as
        they are drawn. A box whose iterator closed before the draw draws
        nothing (None); one closed while its batch ran hands the meta back
        when the batch is done. A batch that fails hands nothing back: its
        draws are dropped. With tracing on, the whole call is the span
        ``stream.produce`` of the batch's draw index."""
        with trace.span("stream.produce", cuda=self.device.type == "cuda", volumes=self.batch_size) as sp, \
                self._lock:
            with self._meta_lock:
                if box is not None and box.get("closed"):
                    return None
                index, meta = self._draw()
                if box is not None:
                    box["index"], box["meta"] = index, meta
            sp.set(batch=index)
            batch = self._run(meta, **chain_kw)
            if box is not None:
                with self._meta_lock:
                    box["ran"] = True
                    if box.get("closed"):
                        heapq.heappush(self._returned, (box["index"], meta))
            return batch

    def replay_batch(self, meta: dict) -> dict:
        """Re-generate a batch bit for bit from its ``meta`` record, on this
        stream or a fresh one with the same configuration and device."""
        B = int(meta["batch_size"])
        if B != self.batch_size:
            raise ValueError(
                f"meta was produced with batch_size={B}, this stream uses "
                f"{self.batch_size}; construct a stream with batch_size={B}"
            )
        with self._lock:
            return self._run(meta)

    def replay_sample(self, meta: dict, index: int) -> dict:
        """One element of a recorded batch (see :meth:`replay_batch`)."""
        batch = self.replay_batch(meta)
        return {"image": batch["image"][index], "label": batch["label"][index], "name": batch["name"][index]}

    def _produce(self, box: dict) -> None:
        """Generate one batch into ``box``; on CUDA on the side stream, with
        the event that completes it. An exception is kept for the consumer."""
        try:
            if self.device.type == "cuda":
                stream = _side_stream(self.device)
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    box["batch"] = self._generate(box)
                    box["event"] = torch.cuda.Event()
                    box["event"].record(stream)
            else:
                box["batch"] = self._generate(box)
        except Exception as e:  # noqa: BLE001 - re-raised in the consumer
            box["error"] = e

    def _start(self) -> tuple[threading.Thread, dict]:
        box: dict = {}
        t = threading.Thread(target=self._produce, args=(box,), name="fsg-stream-producer")
        t.start()
        return t, box

    def _receive(self, box: dict) -> dict:
        """The producer's batch, ready on the consumer's current stream."""
        if "error" in box:
            raise box["error"]
        batch = box["batch"]
        if "event" in box:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(box["event"])
            batch["image"].record_stream(cur)
            batch["label"].record_stream(cur)
        return batch

    def __iter__(self):
        if not self.prefetch:
            while True:
                yield self._generate()
        t, box = self._start()
        try:
            while True:
                with trace.span("stream.join") as sp:
                    t.join()
                    sp.set(batch=box.get("index"))
                batch = self._receive(box)
                t, box = self._start()
                yield batch
        finally:
            # closed with a batch in flight: its draws go back to the stream
            # (here if the batch is done, else by its producer when it is),
            # so that no consumer skips them; a producer that has not drawn
            # yet draws nothing, and a failed batch goes back to no one
            with self._meta_lock:
                box["closed"] = True
                if box.get("ran") and "error" not in box:
                    heapq.heappush(self._returned, (box["index"], box["meta"]))
            t.join()
