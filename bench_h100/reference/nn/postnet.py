"""Convolutional PostNet (reference ``Layers/PostNet.py:25-74``).

Five bias-free convs of kernel 5; GroupNorm(32) + tanh on the hidden
layers and GroupNorm(20) on the output layer.  GroupNorm statistics cover
the whole padded bucket, as in the JAX package.  Unless ``deterministic``,
dropout follows each hidden layer's tanh and the output's GroupNorm
(``toucan_tpu/nn/postnet.py:24``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.nn.convolution import same_conv


class PostNet(nn.Module):
    def __init__(self, odim: int = 80, n_layers: int = 5, n_chans: int = 256,
                 kernel_size: int = 5, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.postnet = nn.ModuleList()
        for i in range(n_layers):
            c_in = odim if i == 0 else n_chans
            last = i == n_layers - 1
            c_out = odim if last else n_chans
            self.postnet.append(nn.Sequential(
                same_conv(c_in, c_out, kernel_size, bias=False),
                nn.GroupNorm(20 if last else 32, c_out)))

    def forward(self, xs, mask=None, deterministic: bool = True):
        """xs (B, T, odim); mask (B, T, 1) zeroes padded frames before each conv."""
        x = xs.transpose(1, 2)
        m = None if mask is None else mask.transpose(1, 2)
        for i, layer in enumerate(self.postnet):
            if m is not None:
                x = x * m
            x = layer(x)
            if i < len(self.postnet) - 1:
                x = torch.tanh(x)
            if not deterministic:
                x = F.dropout(x, self.dropout_rate)
        return x.transpose(1, 2)
