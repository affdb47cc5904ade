"""Duration and variance (pitch/energy) predictors.

Conv stacks with speaker-conditional layer norm, as the reference
(``Layers/DurationPredictor.py:12-113``, ``Layers/VariancePredictor.py:13-80``).
At inference the duration predictor gives round(exp(x) - offset) clamped
at zero.
"""

from typing import Optional

import torch
from torch import nn

from toucan_tpu_torch.nn.convolution import conv_btc, same_conv
from toucan_tpu_torch.nn.norms import ConditionalLayerNorm, LayerNorm


class _ConvStack(nn.Module):
    def __init__(self, idim: int, n_layers: int, n_chans: int, kernel_size: int,
                 utt_embed_dim: Optional[int]):
        super().__init__()
        self.conv = nn.ModuleList(
            nn.Sequential(same_conv(idim if i == 0 else n_chans, n_chans, kernel_size),
                          nn.ReLU())
            for i in range(n_layers))
        self.norms = nn.ModuleList(
            ConditionalLayerNorm(n_chans, utt_embed_dim) if utt_embed_dim is not None
            else LayerNorm(n_chans) for _ in range(n_layers))
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, utt_embed=None, input_mask=None):
        for conv, norm in zip(self.conv, self.norms):
            if input_mask is not None:
                xs = xs * input_mask
            xs = torch.relu(conv_btc(conv[0], xs))
            xs = norm(xs, utt_embed) if isinstance(norm, ConditionalLayerNorm) else norm(xs)
        return self.linear(xs)


class DurationPredictor(_ConvStack):
    OFFSET = 1.0  # the predictor regresses log(duration + OFFSET)

    def __init__(self, idim: int, n_layers: int = 3, n_chans: int = 256,
                 kernel_size: int = 3, utt_embed_dim: Optional[int] = None):
        super().__init__(idim, n_layers, n_chans, kernel_size, utt_embed_dim)

    def forward(self, xs, utt_embed=None, input_mask=None):
        """xs (B, T, D) -> (B, T) int32 durations, rounded in f32."""
        x = super().forward(xs, utt_embed, input_mask)[..., 0].float()
        return torch.clamp(torch.round(torch.exp(x) - self.OFFSET), min=0.0).to(torch.int32)


class VariancePredictor(_ConvStack):
    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 256,
                 kernel_size: int = 3, utt_embed_dim: Optional[int] = None):
        super().__init__(idim, n_layers, n_chans, kernel_size, utt_embed_dim)

    def forward(self, xs, utt_embed=None, input_mask=None):
        """xs (B, T, D) -> (B, T, 1)."""
        return super().forward(xs, utt_embed, input_mask)
