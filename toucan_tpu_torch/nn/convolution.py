"""Conformer convolution module and position-wise conv feed-forward.

Reference semantics: ``Layers/Convolution.py:10-55`` and
``Layers/MultiLayeredConv1d.py:12-51``.  Modules take (B, T, C); the convs
keep the reference's (C_out, C_in, k) weights.  The BatchNorm normalizes
padded frames too, as the reference: with ``train=False`` by its running
statistics, with ``train=True`` by the batch's, whose running averages it
updates as flax's ``BatchNorm(momentum=0.9)`` does (``train_batch_norm``).
"""

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# sums a tensor over the ranks that share a batch, with its gradient; set
# by ``dist/tensor_parallel.py::MeshStep.batch_statistics``
_stats_reduce = None


@contextlib.contextmanager
def batch_statistics_reduced_by(reduce):
    """Within, training-mode BatchNorm takes the moments of the batch that
    ``reduce`` sums its sums over (None: this rank's batch alone)."""
    global _stats_reduce
    before, _stats_reduce = _stats_reduce, reduce
    try:
        yield
    finally:
        _stats_reduce = before


def stats_reduce():
    """The reduction ``batch_statistics_reduced_by`` set, or None."""
    return _stats_reduce


def conv_btc(conv: nn.Conv1d, x):
    """Apply a Conv1d to a (B, T, C) tensor (a tensor-parallel conv by its
    own ``forward_btc``)."""
    if hasattr(conv, "forward_btc"):
        return conv.forward_btc(x)
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
    reduce = _stats_reduce
    if reduce is None:
        mean = x.mean(dim=dims)
        var = (x - mean.view(shape)).square().mean(dim=dims)
    else:  # the global batch's moments, from every rank's sums
        n = reduce(x.new_tensor(x.numel() // x.shape[1]))
        mean = reduce(x.sum(dim=dims)) / n
        var = reduce((x - mean.view(shape)).square().sum(dim=dims)) / n
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
            h = dropout(h, self.dropout_rate, getattr(self.w_1, "generator", None))
        return conv_btc(self.w_2, h)


def dropout(x, rate: float, generator=None):
    """``F.dropout`` in training mode, its mask drawn from ``generator``
    when one is given (a 'model'-sharded region's own stream,
    ``dist/tensor_parallel.py::seed_dropout``)."""
    if generator is None or rate == 0.0:
        return F.dropout(x, rate)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)
