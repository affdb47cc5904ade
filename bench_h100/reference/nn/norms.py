"""Normalization layers.

LayerNorm uses eps=1e-12 as the reference does (``Layers/LayerNorm.py:17``).
ConditionalLayerNorm keeps the reference's division by the *variance*
(``Layers/ConditionalLayerNorm.py:15-67``), with the var == 0 guard of the
JAX package.
"""

import torch
from torch import nn


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__(dim, eps=eps)


def _mlp(embedding_dim: int, channels: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(embedding_dim, embedding_dim), nn.Tanh(),
                         nn.Linear(embedding_dim, channels), nn.Tanh(),
                         nn.Linear(channels, channels))


class ConditionalLayerNorm(nn.Module):
    """Scale and bias predicted from a speaker embedding by two MLPs.

    x (B, T, C), embedding (B, E).
    """

    def __init__(self, channels: int, embedding_dim: int):
        super().__init__()
        self.W_scale = _mlp(embedding_dim, channels)
        self.W_bias = _mlp(embedding_dim, channels)

    def forward(self, x, embedding):
        embedding = embedding.to(x.dtype)
        scale = self.W_scale(embedding)
        bias = self.W_bias(embedding)
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        # division by var (not its square root) is the reference's arithmetic;
        # an all-constant row has x - mean == 0, so normed = 0 is its limit
        normed = (x - mean) / torch.where(var == 0.0, torch.ones_like(var), var)
        return scale[:, None, :] * normed + bias[:, None, :]
