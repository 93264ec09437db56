"""Batch sharding over processes, one per device (port of
``fetalsyngen_tpu.parallel.sharding``).

The JAX package shards the batch axis over a 1-D device mesh. Here the
mesh is the ``torch.distributed`` process group: one process per device
(``torchrun --nproc_per_node N``; NCCL on cards, gloo on the CPU), each
generating the rows of the batch that fall to its rank. Generation is
independent per volume, so the generators have no collectives; only the
trainer's gradients are averaged (:mod:`fetalsyngen_torch.train.step`).

Every function takes the global batch and returns, or runs on, this rank's
rows: rank r of world W holds rows ``r*B/W .. (r+1)*B/W - 1``. Without a
process group the world is 1 and the rows are the whole batch.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..generator.artifacts.batched import (
    QualityArtifacts,
    apply_post_motion,
    apply_pre_motion,
    chain_draws,
    motion_t,
    row_of,
)
from ..generator.config import GeneratorCfg
from ..train.step import generate, normalize_peak, resolve_device
from .input_pipeline import _production_scopes


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group (the default
    process group): its rank, the world size and its device."""

    rank: int
    world: int
    device: torch.device


def data_group(device=None) -> DataGroup:
    """The data-parallel group of this process (counterpart of
    ``data_mesh``): rank and world of the default process group if one is
    initialised, else rank 0 of world 1. ``device``: None means CUDA,
    ``cuda:LOCAL_RANK`` under ``torchrun``; a device type without an index
    takes that index too."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return DataGroup(rank, world, dev)


def _rows(g: DataGroup, n: int) -> slice:
    if n % g.world:
        raise ValueError(f"a batch of {n} does not divide over {g.world} ranks")
    per = n // g.world
    return slice(g.rank * per, (g.rank + 1) * per)


def shard_batch(g: DataGroup, arr) -> torch.Tensor:
    """This rank's rows of a global batch (leading axis), on its device."""
    t = torch.as_tensor(arr)
    return t[_rows(g, t.shape[0])].to(g.device).contiguous()


def shard_seeds(g: DataGroup, seeds_per_sample) -> list[int]:
    """This rank's integer sample seeds of the global batch's."""
    seeds = [int(s) for s in seeds_per_sample]
    return seeds[_rows(g, len(seeds))]


def make_sharded_generator(g: DataGroup, cfg: GeneratorCfg):
    """``gen(seeds_per_sample, seeds, segs) -> (images, labels)``: this
    rank's rows of ``synth_batch`` of the global batch, generated on its
    device, in f32 (the JAX package's ``make_sharded_generator`` enters no
    scope either)."""

    def gen(seeds_per_sample, seeds, segs):
        return generate(shard_seeds(g, seeds_per_sample), shard_batch(g, seeds), shard_batch(g, segs), cfg,
                        g.device)

    return gen


def make_sharded_artifact_generator(g: DataGroup, generator, shape, cube, ns_grid: int, small_cube=None):
    """Generation with the SR-artifact chain, each rank over its rows.

    Returns ``gen(seeds_per_sample, seeds, segs, pack) -> (images,
    labels)`` for the global batch and its :func:`pack_motion` pack (None:
    no motion). Each of the rank's samples in turn (one sample's scanner
    buffers live at a time): ``synth_core`` from its seed, blur_cortex and
    struct_noise (:func:`apply_pre_motion`), the motion engine on its row
    of the pack (:func:`motion_t`), boundaries (:func:`apply_post_motion`),
    then the division by its peak. Its artifact draws come from
    :func:`chain_draws` of its seed, as the stream's do; the pack's
    ``"gates"`` pin the quality artifacts as they do in the stream. The core
    and the chain run in the stream's bf16 production mode
    (``input_pipeline._production_scopes``; ``FSG_STREAM_BF16=0``: f32), as
    the JAX package's sharded artifact generator does.
    """
    qa = QualityArtifacts.from_generator(generator)
    sm = (getattr(generator, "artifacts", None) or {}).get("simulate_motion")
    cfg = generator.cfg
    shape = tuple(shape)

    def gen(seeds_per_sample, seeds, segs, pack=None):
        rows = _rows(g, len(seeds_per_sample))
        local = shard_seeds(g, seeds_per_sample)
        seeds, segs = shard_batch(g, seeds), shard_batch(g, segs)
        gates = None if pack is None else pack.get("gates")
        images, labels = [], []
        for i, (s, b) in enumerate(zip(local, range(rows.start, rows.stop))):
            with _production_scopes():
                out, seg = generate([s], seeds[i : i + 1], segs[i : i + 1], cfg, g.device)
                out, seg = out[0].float(), seg[0]
                draws = chain_draws([s], g.device)[0]
                gb = None if gates is None else gates[b]
                out = apply_pre_motion(out, seg, qa, draws, gb)
                if sm is not None and pack is not None and "motion_on" in pack:
                    out = motion_t(out, seg, row_of(pack, b), sm, shape, cube, ns_grid, draws, small_cube)
                out = apply_post_motion(out, seg, qa, draws, gb)
            images.append(out)
            labels.append(seg)
        return normalize_peak(torch.stack(images)), torch.stack(labels)

    return gen
