"""Alias-free SnakeBeta: 2x kaiser-sinc upsample, SnakeBeta, 2x low-pass decimate.

Counterpart of ``toucan_tpu/nn/alias_free.py`` (reference BigVGAN
``AMP.py`` with ``alias_free_torch``'s ``Activation1d``).  Plain PyTorch on
(B, T, C) with replicate padding at the sequence edges; it is the plain
version of the K5 kernel (``kernels/aliasfree.py``).  The JAX package's
folded, shifted-add and depthwise variants are TPU layouts of this same
function and are not carried over.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SNAKE_EPS = 1e-9
TAPS = 12


@lru_cache(maxsize=None)
def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """(kernel_size,) low-pass FIR; matches alias_free_torch.filter semantics."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    attenuation = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if attenuation > 50.0:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21.0:
        beta = 0.5842 * (attenuation - 21) ** 0.4 + 0.07886 * (attenuation - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def resample_filter(device=None) -> torch.Tensor:
    """The 12-tap filter of both resamplers, kaiser_sinc_filter(0.25, 0.3, 12)."""
    return torch.from_numpy(kaiser_sinc_filter(0.25, 0.3, TAPS)).to(device)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, 2T): sinc interpolation with replicate edge padding."""
    c = x.shape[1]
    pad = TAPS // 2 - 1
    crop = pad * 2 + (TAPS - 2) // 2
    filt = resample_filter(x.device).to(x.dtype).expand(c, 1, TAPS)
    y = F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), filt, stride=2, groups=c)
    return 2.0 * y[..., crop:y.shape[-1] - crop]


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 2T) -> (B, C, T): sinc low-pass and decimation, replicate edges."""
    c = x.shape[1]
    filt = resample_filter(x.device).to(x.dtype).expand(c, 1, TAPS)
    x = F.pad(x, (TAPS // 2 - 1, TAPS // 2), mode="replicate")
    return F.conv1d(x, filt, stride=2, groups=c)


def snake_reach(q: int) -> int:
    """The last input index that output index ``q`` of ``alias_free_snake``
    reads: the downsampler's last tap, then the upsampler's.  ``q`` may be
    an offset from a frame boundary, as in ``nn/convolution.py::conv_reach``."""
    pad = TAPS // 2 - 1
    last = 2 * q + TAPS - 1 - pad                 # downsample2: padded rows 2q .. 2q + TAPS - 1
    return (last + pad * 2 + (TAPS - 2) // 2) // 2 - pad   # upsample2: its crop, then its pad


def snake_factors(alpha: torch.Tensor, beta: torch.Tensor, dtype=torch.float32):
    """(e^alpha, 1 / (e^beta + eps)) of the log-scale parameters, in f32,
    rounded to ``dtype`` and back: the JAX kernel rounds both to x's dtype
    before use (``toucan_tpu/kernels/pallas_aliasfree.py:136-137``)."""
    a = torch.exp(alpha.float())
    inv_b = 1.0 / (torch.exp(beta.float()) + SNAKE_EPS)
    return a.to(dtype).float(), inv_b.to(dtype).float()


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x + sin^2(e^alpha x) / (e^beta + eps) on (B, C, T), per channel (logscale)."""
    a, inv_b = snake_factors(alpha, beta)
    return x + inv_b[:, None] * torch.sin(x * a[:, None]) ** 2


def alias_free_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, C): upsample 2x, SnakeBeta, downsample 2x.

    A bf16 x is computed as the JAX kernel computes it: widened to f32,
    e^alpha and the inverse rounded to bf16 (``snake_factors``), the
    arithmetic in f32, the output rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        a, inv_b = snake_factors(alpha, beta, torch.bfloat16)
        xc = x.transpose(1, 2).float()
        y = upsample2(xc)
        y = y + inv_b[:, None] * torch.sin(y * a[:, None]) ** 2
        return downsample2(y).to(torch.bfloat16).transpose(1, 2)
    xc = x.transpose(1, 2)
    return downsample2(snake_beta(upsample2(xc), alpha, beta)).transpose(1, 2)
