"""HiFiGAN generator (Avocodo variant), inference: the reference's copy.

Frozen copy of ``toucan_tpu_torch/models/vocoders/hifigan.py`` cut to its
f32 path, with K2 replaced by its plain version
(``kernels_plain.py::hifigan_stage_plain``).  Reference
``TrainingInterfaces/Spectrogram_to_Wave/HiFiGAN/HiFiGAN.py:13-179``.
80-band mel frames -> 24 kHz wave through 8*6*4*2 = 384x upsampling.  Each
stage is a transposed conv and then three residual stacks averaged.
Parameter names are the reference's state-dict keys with weight norm folded.
"""

from typing import Tuple

import torch
from torch import nn

from bench_h100.reference.kernels_plain import hifigan_stage_plain
from bench_h100.reference.nn.convolution import same_conv


def _at_least_f32(x):
    """f32 from bf16 (the wave comes back f32), float64 kept (a float64 check)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class ResidualStack(nn.Module):
    """LReLU -> dilated conv -> LReLU -> conv, 3 rounds, residual."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope: float):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(slope), same_conv(channels, channels, kernel_size, d))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(slope), same_conv(channels, channels, kernel_size))
            for _ in dilations)


class HiFiGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 80, channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Tuple[int, ...] = (8, 6, 4, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 12, 8, 4),
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilations: Tuple[int, ...] = (1, 3, 5), slope: float = 0.1):
        super().__init__()
        self.slope = slope
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(resblock_dilations)
        self.input_conv = same_conv(in_channels, channels, kernel_size)
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (scale, up_k) in enumerate(zip(upsample_scales, upsample_kernel_sizes)):
            ch = channels // 2 ** (i + 1)
            self.upsamples.append(nn.Sequential(
                nn.LeakyReLU(slope),
                nn.ConvTranspose1d(channels // 2 ** i, ch, up_k, scale,
                                   padding=(up_k - scale) // 2)))
            for k in resblock_kernel_sizes:
                self.blocks.append(ResidualStack(ch, k, resblock_dilations, slope))
        self.out_proj_x1 = same_conv(channels // 4, 1, 7)
        self.out_proj_x2 = same_conv(channels // 8, 1, 7)
        self.output_conv = nn.Sequential(nn.LeakyReLU(0.01), same_conv(ch, 1, kernel_size),
                                         nn.Tanh())
        # the reference's init_weights: conv weights ~ N(0, 0.01)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                nn.init.normal_(m.weight, 0.0, 0.01)

    def forward(self, c):
        """c (B, T, 80) -> wave (B, 384*T, 1) f32."""
        x = self.input_conv(c.transpose(1, 2))
        n = len(self.resblock_kernel_sizes)
        for i, up in enumerate(self.upsamples):
            x = hifigan_stage_plain(up(x), self.blocks[i * n:(i + 1) * n], self.slope)
        return _at_least_f32(self.output_conv(x).transpose(1, 2))
