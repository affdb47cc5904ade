"""Conformer convolution module and position-wise conv feed-forward.

Reference semantics: ``Layers/Convolution.py:10-55`` and
``Layers/MultiLayeredConv1d.py:12-51``.  Modules take (B, T, C); the convs
keep the reference's (C_out, C_in, k) weights.  The BatchNorm normalizes by
its running statistics, padded frames too, as the reference does at
inference.  (Frozen copy of ``toucan_tpu_torch/nn/convolution.py``, cut to
inference.)
"""

import torch.nn.functional as F
from torch import nn


def conv_btc(conv: nn.Conv1d, x):
    """Apply a Conv1d to a (B, T, C) tensor."""
    if conv.kernel_size[0] == 1 and conv.groups == 1:
        return F.linear(x, conv.weight[..., 0], conv.bias)
    return conv(x.transpose(1, 2)).transpose(1, 2)


def same_conv(c_in, c_out, kernel_size, dilation=1, groups=1, bias=True) -> nn.Conv1d:
    """Conv1d with the length-preserving padding of an odd kernel."""
    return nn.Conv1d(c_in, c_out, kernel_size, padding=dilation * (kernel_size - 1) // 2,
                     dilation=dilation, groups=groups, bias=bias)


class ConformerConvModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = same_conv(channels, channels, kernel_size, groups=channels)
        self.norm = nn.BatchNorm1d(channels)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x, mask=None):
        """mask (B, T, 1): padded frames are zeroed before the depthwise conv,
        so real frames see the zero padding of an exact-length run."""
        x = F.glu(conv_btc(self.pointwise_conv1, x), dim=-1)
        if mask is not None:
            x = x * mask
        x = self.depthwise_conv(x.transpose(1, 2))
        x = F.batch_norm(x, self.norm.running_mean, self.norm.running_var, self.norm.weight,
                         self.norm.bias, training=False, eps=self.norm.eps)
        return conv_btc(self.pointwise_conv2, F.silu(x.transpose(1, 2)))


class ConvFeedForward(nn.Module):
    """Position-wise feed-forward as two 1x1 convs."""

    def __init__(self, channels: int, hidden_channels: int):
        super().__init__()
        self.w_1 = nn.Conv1d(channels, hidden_channels, 1)
        self.w_2 = nn.Conv1d(hidden_channels, channels, 1)

    def forward(self, x):
        return conv_btc(self.w_2, F.relu(conv_btc(self.w_1, x)))
