"""BigVGAN generator with alias-free SnakeBeta activations, inference.

Counterpart of ``toucan_tpu/models/vocoders/bigvgan.py``; reference
``TrainingInterfaces/Spectrogram_to_Wave/BigVGAN/BigVGAN.py:19-121`` and
``AMP.py:19-60``.  80-band mel frames -> 24 kHz wave through 8*6*4*2 = 384x
upsampling: ``conv_pre``, then per stage a transposed conv (no leaky ReLU
before it, unlike HiFiGAN) and three AMP blocks averaged, then
``activation_post``, ``conv_post`` and tanh.  Every activation is the
alias-free SnakeBeta of ``kernels/aliasfree.py``: the K5 kernel on CUDA
tensors (4 stages x 3 blocks x 6 + 1 = 73 launches per call), its plain
version on CPU tensors.  The dense convs are ``F.conv1d`` in (B, C, T); the
activations read and write that memory as (B, T, C) views with time
innermost, so no transpose is copied.  Parameter names are the reference's
state-dict keys with weight norm folded.  The Avocodo taps
``out_proj_x1``/``out_proj_x2`` run only with ``return_intermediates=True``.
``forward(c, differentiable=True)`` is the training path: every activation
is the plain ``nn/alias_free.py::alias_free_snake``, with autograd, and K5
is not launched; the path is chosen by that argument alone.  With ``dtype=torch.bfloat16`` (the JAX
generator's ``dtype``) the parameters are held in bf16, the convs run as
bf16 cuDNN convs and every activation runs K5's bf16 instantiation; the
wave comes back f32.
"""

from typing import Tuple

import torch
from torch import nn

from toucan_tpu_torch.kernels.aliasfree import alias_free_snake
from toucan_tpu_torch.models.vocoders.hifigan import _at_least_f32
from toucan_tpu_torch.nn import alias_free
from toucan_tpu_torch.nn.convolution import conv_reach, same_conv


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

    def forward(self, x, differentiable: bool = False):
        act = alias_free.alias_free_snake if differentiable else alias_free_snake
        return act(x.transpose(1, 2), self.act.alpha, self.act.beta).transpose(1, 2)


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

    def forward(self, x, differentiable: bool = False):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c1(self.activations[2 * i](x, differentiable))
            x = x + c2(self.activations[2 * i + 1](xt, differentiable))
        return x

    def reach(self, q: int) -> int:
        """The last input index that output index ``q`` reads
        (``nn/convolution.py::conv_reach``)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            q = alias_free.snake_reach(conv_reach(c1, alias_free.snake_reach(conv_reach(c2, q))))
        return q


class BigVGAN(nn.Module):
    def __init__(self, num_mels: int = 80, channels: int = 512,
                 upsample_rates: Tuple[int, ...] = (8, 6, 4, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 12, 8, 4),
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilations: Tuple[int, ...] = (1, 3, 5),
                 dtype: torch.dtype = torch.float32):
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
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the parameters."""
        return self.conv_pre.weight.dtype

    @property
    def receptive_frames(self) -> int:
        """R: the mel frames past a length L that the wave's first 384 L
        samples read, L .. L + R - 1, from the convs' and the resamplers'
        own geometry (18 for the released one), so a mel cut at L + R
        frames or more gives those samples unchanged: what K5's replicate
        edges put past the cut reaches none of them."""
        q = alias_free.snake_reach(conv_reach(self.conv_post, -1))
        n = self.n_blocks
        for i in reversed(range(len(self.ups))):
            q = max(block.reach(q) for block in self.resblocks[i * n:(i + 1) * n])
            q = conv_reach(self.ups[i][0], q)
        return conv_reach(self.conv_pre, q) + 1

    def forward(self, c, return_intermediates: bool = False, differentiable: bool = False):
        """c (B, T, 80) -> wave (B, 384*T, 1) f32; with
        ``return_intermediates`` (wave, x2, x1), the Avocodo taps after
        stages 2 and 1, (B, 192*T, 1) and (B, 48*T, 1), in the JAX order.
        ``differentiable=True`` runs the training path (module docstring);
        the default runs under ``torch.no_grad()`` through K5."""
        if differentiable:
            return self._run(c, return_intermediates, True)
        with torch.no_grad():
            return self._run(c, return_intermediates, False)

    def _run(self, c, return_intermediates: bool, differentiable: bool):
        x = self.conv_pre(c.to(self.dtype).transpose(1, 2))
        n = self.n_blocks
        taps = {}
        for i, (up,) in enumerate(self.ups):
            x = up(x)
            x = sum(block(x, differentiable) for block in self.resblocks[i * n:(i + 1) * n]) / n
            if return_intermediates and i in (1, 2):
                conv = self.out_proj_x1 if i == 1 else self.out_proj_x2
                taps[i] = _at_least_f32(conv(x).transpose(1, 2))
        x = self.conv_post(self.activation_post(x, differentiable))
        wave = _at_least_f32(torch.tanh(x).transpose(1, 2))
        return (wave, taps[2], taps[1]) if return_intermediates else wave
