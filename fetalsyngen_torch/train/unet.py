"""3D segmentation UNet, the downstream consumer model (port of
``fetalsyngen_tpu.train.unet``, a flax ``linen`` module).

The reference ships no model; this compact UNet proves the end-to-end
contract: generated batches feeding a segmentation train loop on the same
device. It computes what the flax module computes, on channels-first
``(B, C, D, H, W)`` tensors:

- parameters are f32; the convolutions, GroupNorms and the transposed
  convolutions compute in ``dtype`` (bf16 by default): input, kernel and
  bias are cast to ``dtype`` as flax's ``promote_dtype`` casts them, and
  the result is ``dtype``. Explicit casts, not ``torch.autocast``, which
  runs ``group_norm`` in f32 and returns f32;
- convolutions pad "SAME" (1 at k=3);
- ``GroupNorm(min(8, C))`` with flax's epsilon, 1e-6, its statistics and
  its affine map in f32 (flax promotes both to at least f32), the result in
  ``dtype``. Flax takes the variance as E[x^2] - E[x]^2; torch's kernel
  takes it in two passes, which differ in the last bits of f32;
- 2x2x2 max pooling with stride 2; a skip is concatenated after the
  upsample, the upsampled channels first;
- the 1x1x1 head computes in f32, and the logits are f32.

:meth:`UNet3D.init_parameters` follows flax's initialisers: every kernel
``lecun_normal`` (a normal of variance 1/fan_in truncated at two standard
deviations, its scale divided by 0.8796 so that the truncated variance is
1/fan_in), every bias zero, GroupNorm scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax.linen.GroupNorm's default epsilon (torch's is 1e-5)
# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# its scale by it so that the truncated draw keeps the asked-for variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax GroupNorm under ``dtype``: statistics and the affine map in f32."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(dtype)


class ConvBlock(nn.Module):
    """Two (3^3 conv -> GroupNorm -> SiLU) layers."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([
            nn.Conv3d(in_channels if i == 0 else features, features, 3, padding=1) for i in range(2)
        ])
        self.norms = nn.ModuleList([nn.GroupNorm(min(8, features), features, eps=GN_EPS) for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        for conv, norm in zip(self.convs, self.norms):
            x = F.conv3d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.silu(_group_norm(x, norm, dt))
        return x


class UNet3D(nn.Module):
    """Encoder-decoder with skip connections over (B, C, D, H, W) volumes.

    ``blocks`` holds the ConvBlocks in call order (the encoder's, the
    bottom's, then the decoder's), ``ups`` the transposed convolutions and
    ``head`` the 1x1x1 classifier: the order of flax's ``ConvBlock_i``,
    ``ConvTranspose_j`` and ``Conv_0`` (``convert.unet_state_from_flax``).
    The input has one channel; each spatial size must divide by
    ``2 ** (len(channels) - 1)``.
    """

    def __init__(self, channels: Sequence[int] = (16, 32, 64), n_classes: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        self.n_classes = int(n_classes)
        self.dtype = dtype
        enc, bottom = self.channels[:-1], self.channels[-1]
        blocks, ins = [], 1
        for ch in enc:
            blocks.append(ConvBlock(ins, ch, dtype))
            ins = ch
        blocks.append(ConvBlock(ins, bottom, dtype))
        ins, ups = bottom, []
        for ch in reversed(enc):
            ups.append(nn.ConvTranspose3d(ins, ch, 2, stride=2))
            blocks.append(ConvBlock(2 * ch, ch, dtype))
            ins = ch
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = nn.Conv3d(ins, self.n_classes, 1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisation, drawn from ``generator`` (a CPU generator
        for parameters on the CPU) in module order."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.ConvTranspose3d):
                # torch (in, out, k, k, k); flax's fan_in is in * k^3
                _lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(), generator)
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d, nn.GroupNorm)):
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, D, H, W) -> (B, n_classes, D, H, W) f32 logits."""
        dt = self.dtype
        n_enc = len(self.channels) - 1
        x = x.to(dt)
        skips = []
        for block in self.blocks[:n_enc]:
            x = block(x)
            skips.append(x)
            x = F.max_pool3d(x, 2, 2)
        x = self.blocks[n_enc](x)
        for up, block, skip in zip(self.ups, self.blocks[n_enc + 1:], reversed(skips)):
            x = F.conv_transpose3d(x.to(dt), up.weight.to(dt), up.bias.to(dt), stride=2)
            x = block(torch.cat([x, skip], 1))
        return F.conv3d(x.float(), self.head.weight, self.head.bias)
