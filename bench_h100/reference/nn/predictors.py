"""Duration and variance (pitch/energy) predictors.

Conv stacks with speaker-conditional layer norm, as the reference
(``Layers/DurationPredictor.py:12-113``, ``Layers/VariancePredictor.py:13-80``).
At inference the duration predictor gives round(exp(x) - offset) clamped
at zero.  Dropout follows each norm when ``deterministic`` is False
(``toucan_tpu/nn/predictors.py:38``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.nn.convolution import conv_btc, same_conv
from bench_h100.reference.nn.norms import ConditionalLayerNorm, LayerNorm


class _ConvStack(nn.Module):
    def __init__(self, idim: int, n_layers: int, n_chans: int, kernel_size: int,
                 utt_embed_dim: Optional[int], dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv = nn.ModuleList(
            nn.Sequential(same_conv(idim if i == 0 else n_chans, n_chans, kernel_size),
                          nn.ReLU())
            for i in range(n_layers))
        self.norms = nn.ModuleList(
            ConditionalLayerNorm(n_chans, utt_embed_dim) if utt_embed_dim is not None
            else LayerNorm(n_chans) for _ in range(n_layers))
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, utt_embed=None, input_mask=None, deterministic: bool = True):
        for conv, norm in zip(self.conv, self.norms):
            if input_mask is not None:
                xs = xs * input_mask
            xs = torch.relu(conv_btc(conv[0], xs))
            xs = norm(xs, utt_embed) if isinstance(norm, ConditionalLayerNorm) else norm(xs)
            if not deterministic:
                xs = F.dropout(xs, self.dropout_rate)
        return self.linear(xs)


class DurationPredictor(_ConvStack):
    OFFSET = 1.0  # the predictor regresses log(duration + OFFSET)

    def __init__(self, idim: int, n_layers: int = 3, n_chans: int = 256,
                 kernel_size: int = 3, utt_embed_dim: Optional[int] = None,
                 dropout_rate: float = 0.2):
        super().__init__(idim, n_layers, n_chans, kernel_size, utt_embed_dim, dropout_rate)

    def forward(self, xs, utt_embed=None, input_mask=None):
        """xs (B, T, D) -> (B, T) int32 durations, rounded in f32."""
        x = super().forward(xs, utt_embed, input_mask)[..., 0].float()
        return torch.clamp(torch.round(torch.exp(x) - self.OFFSET), min=0.0).to(torch.int32)

class VariancePredictor(_ConvStack):
    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 256,
                 kernel_size: int = 3, utt_embed_dim: Optional[int] = None,
                 dropout_rate: float = 0.5):
        super().__init__(idim, n_layers, n_chans, kernel_size, utt_embed_dim, dropout_rate)

    def forward(self, xs, utt_embed=None, input_mask=None, padding_mask=None,
                deterministic: bool = True):
        """xs (B, T, D) -> (B, T, 1), 0 where ``padding_mask`` (B, T, 1) is True."""
        x = super().forward(xs, utt_embed, input_mask, deterministic)
        return x if padding_mask is None else x.masked_fill(padding_mask, 0.0)
