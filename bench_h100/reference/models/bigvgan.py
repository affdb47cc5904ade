"""BigVGAN generator with alias-free SnakeBeta activations: the reference's copy.

Frozen copy of ``toucan_tpu_torch/models/vocoders/bigvgan.py`` cut to its
f32 path, every activation K5's plain version
(``nn/alias_free.py::alias_free_snake``).  Reference
``TrainingInterfaces/Spectrogram_to_Wave/BigVGAN/BigVGAN.py:19-121`` and
``AMP.py:19-60``: ``conv_pre``, then per stage a transposed conv and three
AMP blocks averaged, then ``activation_post``, ``conv_post`` and tanh.
Parameter names are the reference's state-dict keys with weight norm folded.
"""

from typing import Tuple

import torch
from torch import nn

from bench_h100.reference.models.hifigan import _at_least_f32
from bench_h100.reference.nn import alias_free
from bench_h100.reference.nn.convolution import same_conv


class SnakeBeta(nn.Module):
    """Log-scale SnakeBeta parameters of one activation (``act.alpha/beta``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    """Upsample 2x -> SnakeBeta -> downsample 2x on (B, C, T)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return alias_free.alias_free_snake(x.transpose(1, 2), self.act.alpha,
                                           self.act.beta).transpose(1, 2)


class AMPBlock(nn.Module):
    """act -> dilated conv -> act -> conv -> +residual, one round per dilation."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(same_conv(channels, channels, kernel_size, d)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(same_conv(channels, channels, kernel_size)
                                    for _ in dilations)
        self.activations = nn.ModuleList(Activation1d(channels)
                                         for _ in range(2 * len(dilations)))

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c1(self.activations[2 * i](x))
            x = x + c2(self.activations[2 * i + 1](xt))
        return x


class BigVGAN(nn.Module):
    def __init__(self, num_mels: int = 80, channels: int = 512,
                 upsample_rates: Tuple[int, ...] = (8, 6, 4, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 12, 8, 4),
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.n_blocks = len(resblock_kernel_sizes)
        self.conv_pre = same_conv(num_mels, channels, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (scale, up_k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = channels // 2 ** (i + 1)
            self.ups.append(nn.ModuleList([nn.ConvTranspose1d(
                channels // 2 ** i, ch, up_k, scale, padding=(up_k - scale) // 2)]))
            for k in resblock_kernel_sizes:
                self.resblocks.append(AMPBlock(ch, k, resblock_dilations))
        self.activation_post = Activation1d(ch)
        self.conv_post = same_conv(ch, 1, 7)
        self.out_proj_x1 = same_conv(channels // 4, 1, 7)
        self.out_proj_x2 = same_conv(channels // 8, 1, 7)

    def forward(self, c):
        """c (B, T, 80) -> wave (B, 384*T, 1) f32."""
        x = self.conv_pre(c.transpose(1, 2))
        n = self.n_blocks
        for i, (up,) in enumerate(self.ups):
            x = up(x)
            x = sum(block(x) for block in self.resblocks[i * n:(i + 1) * n]) / n
        x = self.conv_post(self.activation_post(x))
        return _at_least_f32(torch.tanh(x).transpose(1, 2))
