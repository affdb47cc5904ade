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


def train_batch_norm(norm: nn.modules.batchnorm._BatchNorm, x, update: bool = True):
    """(B, C, ...) normalized by the batch's mean and biased variance over
    every axis but C; with ``update`` the running statistics become
    ``0.9 * old + 0.1 * batch`` with the *biased* variance, as flax keeps
    ``batch_stats`` (PyTorch's own update would use the unbiased one)."""
    momentum = FLAX_MOMENTUM
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    mean = x.mean(dim=dims)
    var = (x - mean.view(shape)).square().mean(dim=dims)
    if update:
        with torch.no_grad():
            norm.running_mean.mul_(momentum).add_((1 - momentum) * mean)
            norm.running_var.mul_(momentum).add_((1 - momentum) * var)
            norm.num_batches_tracked.add_(1)
    y = (x - mean.view(shape)) * torch.rsqrt(var + norm.eps).view(shape)
    return y * norm.weight.view(shape) + norm.bias.view(shape)


def batch_norm(norm: nn.modules.batchnorm._BatchNorm, x, train: bool = False,
               update: bool = True):
    """flax's ``BatchNorm(use_running_average=not train)`` on (B, C, ...),
    whatever the module's mode: ``train_batch_norm`` or the running
    statistics."""
    if train:
        return train_batch_norm(norm, x, update)
    return F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                        training=False, eps=norm.eps)


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
        x = batch_norm(self.norm, x, train)
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
