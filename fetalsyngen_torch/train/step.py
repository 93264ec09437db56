"""The fused generate-and-train step: synthesis feeds segmentation training
on the same device (port of ``fetalsyngen_tpu.train.step``).

Each step generates a batch with ``synth_batch`` (K1 runs three times in
its deform stage), divides each image by its peak, and takes one AdamW step
of the UNet on it. Only the UNet is differentiated: the images are
constants of the loss, as they are to ``jax.value_and_grad`` in the
reference, so the hat kernels need no backward pass.

Data parallelism (:func:`make_sharded_train_step`) is one process per
device with the batch split over the ranks: the model is wrapped in
``DistributedDataParallel``, whose gradient average over equal local
batches is the gradient of the reference's global-batch mean with
replicated parameters.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..generator.config import GeneratorCfg
from ..generator.pipeline import synth_batch
from .unet import UNet3D

# optax.adamw's defaults: b1, b2, eps (outside the square root) and the
# decay, which optax applies to every parameter (mask=None)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken. The steps
    update the model and the optimizer in place."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def resolve_device(device=None) -> torch.device:
    """``device``, with None meaning CUDA; CUDA without a card raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} means CUDA, but torch.cuda.is_available() is false; pass device='cpu'"
        )
    return dev


def create_train_state(seed: int, model: UNet3D, shape, lr: float = 1e-3, device=None) -> TrainState:
    """``model`` initialised from ``seed`` (flax's initialisers, drawn on
    the CPU, so every device gets the same weights), on ``device`` (None:
    CUDA), with ``torch.optim.AdamW`` at optax's ``adamw(lr)`` defaults."""
    dev = resolve_device(device)
    div = 2 ** (len(model.channels) - 1)
    if any(int(s) % div for s in shape):
        raise ValueError(f"shape {tuple(shape)} does not divide by {div}, the UNet's pooling factor")
    model.init_parameters(torch.Generator().manual_seed(int(seed)))
    model.to(dev)
    return TrainState(model, torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW))


def loss_fn(model, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``model`` on (B, D, H, W) images
    against (B, D, H, W) integer labels, with ``jax.nn.one_hot`` targets: a
    label outside [0, n_classes) is an all-zero target, so its voxel adds 0
    to the sum and still counts in the mean over all B*D*H*W voxels."""
    logits = model(images[:, None])
    logp = F.log_softmax(logits, 1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < logits.shape[1])
    picked = logp.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return -torch.where(valid, picked, 0.0).mean()


def normalize_peak(images: torch.Tensor) -> torch.Tensor:
    """Each (D, H, W) image divided by its peak where the peak is positive
    (tensor / tensor: ``1.0 / t`` would round twice)."""
    peak = images.amax(dim=(1, 2, 3), keepdim=True)
    return images / torch.where(peak > 0, peak, torch.ones_like(peak))


def _update(model, opt, images, labels) -> torch.Tensor:
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, normalize_peak(images), labels)
    loss.backward()
    opt.step()
    return loss.detach()


def train_on(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
    """One gradient step on a generated batch, each image divided by its
    peak. Returns ``(state, loss)``, the loss a device tensor (no host
    read in the step)."""
    loss = _update(state.model, state.opt, images, labels)
    state.step += 1
    return state, loss


def generate(seeds_per_sample, seeds, segs, cfg: GeneratorCfg, device):
    """The step's batch: ``synth_batch`` without autograd. (images, labels)."""
    with torch.no_grad():
        images, labels, _ = synth_batch(seeds, segs, cfg, seeds_per_sample, device)
    return images, labels


def generate_and_train_step(state: TrainState, seeds_per_sample, seeds, segs, cfg: GeneratorCfg):
    """One fused step: synthesise a batch from (B, D, H, W) seed labels and
    segmentations, one integer seed per sample, on the model's device, then
    take a gradient step on it. Returns ``(state, loss)``."""
    dev = next(state.model.parameters()).device
    images, labels = generate(seeds_per_sample, seeds, segs, cfg, dev)
    return train_on(state, images, labels)


def make_sharded_train_step(state: TrainState, cfg: GeneratorCfg, g):
    """The fused step on ``state``, data-parallel over ``g`` (this
    process's :class:`~fetalsyngen_torch.parallel.sharding.DataGroup`).

    Returns ``step(seeds_per_sample, seeds, segs) -> loss``, which updates
    ``state`` in place. The inputs are the global batch; each rank
    generates its rows
    (:func:`~fetalsyngen_torch.parallel.sharding.make_sharded_generator`)
    and trains on them, through ``DistributedDataParallel`` when a process
    group is initialised, and the returned loss is the mean over the global
    batch on every rank. ``step.module`` is the module the step runs: the
    ``DistributedDataParallel`` wrapper, or ``state.model``.
    """
    import torch.distributed as dist

    from ..parallel.sharding import make_sharded_generator

    gen = make_sharded_generator(g, cfg)
    module = state.model
    ddp = dist.is_available() and dist.is_initialized()
    if ddp:
        device_ids = [g.device.index] if g.device.type == "cuda" else None
        module = nn.parallel.DistributedDataParallel(state.model, device_ids=device_ids)

    def step(seeds_per_sample, seeds, segs) -> torch.Tensor:
        loss = _update(module, state.opt, *gen(seeds_per_sample, seeds, segs))
        state.step += 1
        if ddp:
            dist.all_reduce(loss)
            loss = loss / g.world
        return loss

    step.module = module
    return step
