"""Vocoder critics: MSD, MPD, Avocodo's CoMBD and SubBand (PQMF), and the joint critic.

Counterpart of ``toucan_tpu/models/vocoders/discriminators.py`` (reference
``Spectrogram_to_Wave/HiFiGAN/HiFiGAN_Discriminators.py`` and
``Spectrogram_to_Wave/Avocodo/AvocodoDiscriminators.py``).  Every conv is a
``nn/param_norm.py::NormedConv`` with weight norm, except the first
multi-scale critic's, which take spectral norm.  Waves come in as (B, T, 1),
as the generators give them; inside, the convs run in torch's (B, C, T)
(and (B, C, T/P, P) for the period critics), so the feature maps are the
JAX package's (B, T, C) ones transposed (the losses are means over them).
Every critic returns ``[*feature_maps, score]``; the joint critic returns
the 17 critics in the JAX order: 3 MSD, 5 MPD, 5 CoMBD, 4 SubBand.

Module names follow the JAX module tree (``msd.scale_0.conv_first``,
``mcmbd.combd_2.conv_3``, ``msbd.fsbd.mdc_4.conv_out``, ...): no reference
discriminator checkpoint is in this repository to take keys from, and this
way ``weights.py::avocodo_discriminator_from_jax`` maps each conv by its
path.  ``combd_1`` and ``combd_2`` are each one module applied twice (to the
generator's tap and to the PQMF band), as in JAX: the weights are shared.

The frequency sub-band critic's first convs take ``segment / 64`` channels
(the time axis of the 64-band analysis becomes its channels), which a JAX
module infers at init: here ``segment`` is given at construction.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from toucan_tpu_torch.nn.param_norm import NormedConv

SEGMENT = 12288  # the reference's 24 kHz training segment


def _lrelu(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


# ---------------------------------------------------------------- periods

class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, channels: int = 32, kernel_size: int = 5,
                 downsample_scales: Sequence[int] = (3, 3, 3, 3, 1), max_channels: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.period = period
        self.n_convs = len(downsample_scales)
        cin, ch = 1, channels
        pad = (kernel_size - 1) // 2
        for i, scale in enumerate(downsample_scales):
            self.add_module(f"conv_{i}", NormedConv(cin, ch, (kernel_size, 1), (scale, 1),
                                                    ((pad, pad), (0, 0)), generator=generator))
            cin, ch = ch, min(ch * 4, max_channels)
        self.output_conv = NormedConv(cin, 1, (2, 1), padding=((1, 1), (0, 0)),
                                      generator=generator)

    def forward(self, x):
        """x (B, 1, T) -> [fmaps (B, C, T/P, P)..., score (B, n)]."""
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
        x = x.reshape(b, c, -1, self.period)
        outs = []
        for i in range(self.n_convs):
            x = _lrelu(getattr(self, f"conv_{i}")(x))
            outs.append(x)
        outs.append(self.output_conv(x).reshape(b, -1))
        return outs


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), channels: int = 32,
                 max_channels: int = 1024, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(
                p, channels, max_channels=max_channels, generator=generator))

    def forward(self, x):
        return [getattr(self, f"period_{p}")(x) for p in self.periods]


# ----------------------------------------------------------------- scales

class ScaleDiscriminator(nn.Module):
    def __init__(self, channels: int = 128, kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 downsample_scales: Sequence[int] = (4, 4, 4, 4, 1), max_channels: int = 1024,
                 max_groups: int = 16, norm: str = "weight",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(norm=norm, generator=generator)
        self.conv_first = NormedConv(1, channels, (kernel_sizes[0],), **kw)
        self.n_down = len(downsample_scales)
        in_chs = out_chs = channels
        prev, groups = channels, 4
        for i, scale in enumerate(downsample_scales):
            self.add_module(f"down_{i}", NormedConv(prev, out_chs, (kernel_sizes[1],), (scale,),
                                                    groups=groups, **kw))
            prev = in_chs = out_chs
            out_chs = min(in_chs * 2, max_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_channels)
        self.post_conv = NormedConv(prev, out_chs, (kernel_sizes[2],), **kw)
        self.output_conv = NormedConv(out_chs, 1, (kernel_sizes[3],), **kw)

    def forward(self, x):
        outs = [_lrelu(self.conv_first(x))]
        for i in range(self.n_down):
            outs.append(_lrelu(getattr(self, f"down_{i}")(outs[-1])))
        outs.append(_lrelu(self.post_conv(outs[-1])))
        outs.append(self.output_conv(outs[-1]))
        return outs


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3, channels: int = 128, max_channels: int = 1024,
                 follow_official_norm: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        for i in range(scales):
            norm = "spectral" if follow_official_norm and i == 0 else "weight"
            self.add_module(f"scale_{i}", ScaleDiscriminator(
                channels, max_channels=max_channels, norm=norm, generator=generator))

    def forward(self, x):
        outs = []
        for i in range(self.scales):
            outs.append(getattr(self, f"scale_{i}")(x))
            x = F.avg_pool1d(x, 4, 2, padding=2, count_include_pad=True)
        return outs


# ------------------------------------------------------------------- PQMF

@lru_cache(maxsize=None)
def pqmf_analysis_filters(n: int, taps: int, cutoff: float, beta: float) -> np.ndarray:
    """(n, taps+1) cosine-modulated kaiser prototype filterbank
    (reference PQMF, AvocodoDiscriminators.py:225-265)."""
    from scipy.signal import firwin
    qmf = firwin(taps + 1, cutoff, window=("kaiser", beta))
    h = np.zeros((n, taps + 1))
    for k in range(n):
        factor = ((2 * k + 1) * (np.pi / (2 * n))
                  * (np.arange(taps + 1) - (taps - 1) / 2))
        h[k] = 2 * qmf * np.cos(factor + (-1) ** k * np.pi / 4)
    return h.astype(np.float32)


def pqmf_analysis(x: torch.Tensor, n: int, taps: int = 62, cutoff: float = 0.15,
                  beta: float = 9.0) -> torch.Tensor:
    """x (B, 1, T) -> (B, n, T//n) critically-sampled subbands."""
    filt = torch.from_numpy(pqmf_analysis_filters(n, taps, cutoff, beta)).to(x)
    return F.conv1d(x, filt[:, None, :], stride=n, padding=taps // 2)


# ------------------------------------------------------------------ CoMBD

class CoMBD(nn.Module):
    def __init__(self, filters: Sequence[int] = (16, 64, 256, 1024, 1024, 1024),
                 kernels: Sequence[int] = (7, 11, 11, 11, 11, 5),
                 groups: Sequence[int] = (1, 4, 16, 64, 256, 1),
                 strides: Sequence[int] = (1, 1, 4, 4, 4, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_convs = len(filters)
        cin = 1
        for i, (f, k, g, s) in enumerate(zip(filters, kernels, groups, strides)):
            self.add_module(f"conv_{i}", NormedConv(cin, f, (k,), (s,), groups=g,
                                                    generator=generator))
            cin = f
        self.conv_post = NormedConv(cin, 1, (3,), generator=generator)

    def forward(self, x):
        """-> [fmaps..., score (B, n)]."""
        fmap = []
        for i in range(self.n_convs):
            x = _lrelu(getattr(self, f"conv_{i}")(x))
            fmap.append(x)
        return fmap + [self.conv_post(x).reshape(x.shape[0], -1)]


class MultiCoMBDiscriminator(nn.Module):
    """Collaborative multi-band critic: full-band and PQMF-band inputs paired
    with the generator's intermediate upsampling taps."""

    KERNELS = ((7, 11, 11, 11, 11, 5), (11, 21, 21, 21, 21, 5), (15, 41, 41, 41, 41, 5))

    def __init__(self, filters: Sequence[int] = (16, 64, 256, 1024, 1024, 1024),
                 groups: Sequence[int] = (1, 4, 16, 64, 256, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i, kernels in enumerate(self.KERNELS, start=1):
            self.add_module(f"combd_{i}", CoMBD(filters, kernels, groups, generator=generator))

    def forward(self, wave, upsampled_twice=None, upsampled_once=None):
        outs = [self.combd_3(wave)]
        x2 = pqmf_analysis(wave, 2, taps=256, cutoff=0.25, beta=10.0)[:, :1]
        x1 = pqmf_analysis(wave, 8, taps=192, cutoff=0.13, beta=10.0)[:, :1]
        if upsampled_twice is not None and upsampled_once is not None:
            outs += [self.combd_2(upsampled_twice), self.combd_1(upsampled_once)]
        else:
            outs += [self.combd_2(x2), self.combd_1(x1)]
        return outs + [self.combd_2(x2), self.combd_1(x1)]


# ---------------------------------------------------------------- SubBand

class MDC(nn.Module):
    def __init__(self, in_channels: int, channel: int, kernel: int, stride: int,
                 dilations: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_convs = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv_{i}", NormedConv(in_channels, channel, (kernel,),
                                                    dilation=(d,), generator=generator))
        self.conv_out = NormedConv(channel, channel, (3,), (stride,), generator=generator)

    def forward(self, x):
        acc = 0.0
        for i in range(self.n_convs):
            acc = acc + getattr(self, f"conv_{i}")(x)
        return _lrelu(self.conv_out(acc / self.n_convs))


class SubBandDiscriminator(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int], kernel: int,
                 strides: Sequence[int], dilations: Sequence[Sequence[int]],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_blocks = len(channels)
        cin = in_channels
        for i, (ch, s, dil) in enumerate(zip(channels, strides, dilations)):
            self.add_module(f"mdc_{i}", MDC(cin, ch, kernel, s, dil, generator=generator))
            cin = ch
        self.conv_post = NormedConv(cin, 1, (3,), generator=generator)

    def forward(self, x):
        fmap = []
        for i in range(self.n_blocks):
            x = getattr(self, f"mdc_{i}")(x)
            fmap.append(x)
        return fmap + [self.conv_post(x).reshape(x.shape[0], -1)]


def _scaled(c: int, s: float) -> int:
    """A width scaled by s, a multiple of 16 and at least 16 (the JAX rule:
    every grouped conv's channel counts stay valid)."""
    return max(16, int(c * s) // 16 * 16)


class MultiSubBandDiscriminator(nn.Module):
    def __init__(self, tsubband: Sequence[int] = (6, 11, 16), n: int = 16, m: int = 64,
                 channel_scale: float = 1.0, segment: int = SEGMENT,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tsubband, self.n, self.m = tuple(tsubband), n, m
        tch = tuple(_scaled(c, channel_scale) for c in (64, 128, 256, 256, 256))
        fch = tuple(_scaled(c, channel_scale) for c in (32, 64, 128, 128, 128))
        tstr = (1, 1, 3, 3, 1)
        kw = dict(generator=generator)
        self.tsbd1 = SubBandDiscriminator(tsubband[0], tch, 7, tstr, ((5, 7, 11),) * 5, **kw)
        self.tsbd2 = SubBandDiscriminator(tsubband[1], tch, 5, tstr, ((3, 5, 7),) * 5, **kw)
        self.tsbd3 = SubBandDiscriminator(tsubband[2], tch, 3, tstr, ((1, 2, 3),) * 5, **kw)
        self.fsbd = SubBandDiscriminator(segment // m, fch, 5, tstr,
                                         ((1, 2, 3),) * 3 + ((2, 3, 5),) * 2, **kw)

    def forward(self, wave):
        xn = pqmf_analysis(wave, self.n, taps=256, cutoff=0.03, beta=10.0)
        outs = [disc(xn[:, :tsb]) for tsb, disc in ((self.tsubband[2], self.tsbd3),
                                                    (self.tsubband[1], self.tsbd2),
                                                    (self.tsubband[0], self.tsbd1))]
        xm = pqmf_analysis(wave, self.m, taps=256, cutoff=0.1, beta=9.0)
        # frequency analysis: the 64 bands become the time axis (reference :137)
        return outs + [self.fsbd(xm.transpose(1, 2))]


# ------------------------------------------------------------------ joint

class AvocodoJointDiscriminator(nn.Module):
    """MSD + MPD + CoMBD + SubBand, the reference's joint critic
    (``HiFiGAN_Discriminators.py:473-568``).  ``channel_scale`` < 1 shrinks
    every critic's width (tests); 1.0 is the reference's.  ``generator``
    draws the initial weights and the spectral norm's start vectors."""

    def __init__(self, channel_scale: float = 1.0, segment: int = SEGMENT,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s = channel_scale
        self.channel_scale, self.segment = s, segment
        kw = dict(generator=generator)
        self.msd = MultiScaleDiscriminator(channels=_scaled(128, s),
                                           max_channels=_scaled(1024, s), **kw)
        self.mpd = MultiPeriodDiscriminator(channels=_scaled(32, s),
                                            max_channels=_scaled(1024, s), **kw)
        groups = (1, 4, 16, 64, 256, 1) if s == 1.0 else (1, 4, 4, 4, 4, 1)
        self.mcmbd = MultiCoMBDiscriminator(
            tuple(_scaled(f, s) for f in (16, 64, 256, 1024, 1024, 1024)), groups, **kw)
        self.msbd = MultiSubBandDiscriminator(channel_scale=s, segment=segment, **kw)

    def forward(self, wave, upsampled_twice=None, upsampled_once=None):
        """wave (B, T, 1) and the generator's taps (B, T/2, 1), (B, T/8, 1)
        -> 17 lists ``[*fmaps, score]``."""
        wave = wave.transpose(1, 2)
        taps = [None if t is None else t.transpose(1, 2)
                for t in (upsampled_twice, upsampled_once)]
        return self.msd(wave) + self.mpd(wave) + self.mcmbd(wave, *taps) + self.msbd(wave)
