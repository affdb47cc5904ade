"""Conformer convolution module and position-wise conv feed-forward.

Reference semantics: ``Layers/Convolution.py:10-55`` and
``Layers/MultiLayeredConv1d.py:12-51``.  Modules take (B, T, C); the convs
keep the reference's (C_out, C_in, k) weights.  The BatchNorm normalizes
padded frames too, as the reference: with ``train=False`` by its running
statistics, with ``train=True`` by the batch's, whose running averages it
updates as flax's ``BatchNorm(momentum=0.9)`` does (``train_batch_norm``).
"""

import torch
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


FLAX_MOMENTUM = 0.9  # flax's BatchNorm(momentum=0.9) is PyTorch's momentum=0.1


def train_batch_norm(norm: nn.BatchNorm1d, x):
    """(B, C, T) normalized by the batch's mean and biased variance over
    (B, T); the running statistics become ``0.9 * old + 0.1 * batch`` with
    the *biased* variance, as flax keeps ``batch_stats`` (PyTorch's own
    update would use the unbiased one)."""
    momentum = FLAX_MOMENTUM
    mean = x.mean(dim=(0, 2))
    var = (x - mean[:, None]).square().mean(dim=(0, 2))
    with torch.no_grad():
        norm.running_mean.mul_(momentum).add_((1 - momentum) * mean)
        norm.running_var.mul_(momentum).add_((1 - momentum) * var)
        norm.num_batches_tracked.add_(1)
    y = (x - mean[:, None]) * torch.rsqrt(var + norm.eps)[:, None]
    return y * norm.weight[:, None] + norm.bias[:, None]


class ConformerConvModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = same_conv(channels, channels, kernel_size, groups=channels)
        self.norm = nn.BatchNorm1d(channels)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x, mask=None, train: bool = False):
        """mask (B, T, 1): padded frames are zeroed before the depthwise conv,
        so real frames see the zero padding of an exact-length run."""
        x = F.glu(conv_btc(self.pointwise_conv1, x), dim=-1)
        if mask is not None:
            x = x * mask
        x = self.depthwise_conv(x.transpose(1, 2))
        n = self.norm
        x = (train_batch_norm(n, x) if train else
             F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0, n.eps))
        return conv_btc(self.pointwise_conv2, F.silu(x.transpose(1, 2)))


class ConvFeedForward(nn.Module):
    """Position-wise feed-forward as two 1x1 convs, dropout between them."""

    def __init__(self, channels: int, hidden_channels: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w_1 = nn.Conv1d(channels, hidden_channels, 1)
        self.w_2 = nn.Conv1d(hidden_channels, channels, 1)

    def forward(self, x, deterministic: bool = True):
        h = F.relu(conv_btc(self.w_1, x))
        if not deterministic:
            h = F.dropout(h, self.dropout_rate)
        return conv_btc(self.w_2, h)
