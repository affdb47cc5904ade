"""Relative positional encodings (Transformer-XL style).

For a length-T input the table covers relative offsets T-1 ... -(T-1)
(reference ``Layers/PositionalEncoding.py:68-131``).  The conformers take
each table from a cache per (length, width, device).
"""

import functools
import math

import numpy as np
import torch


def relative_position_encoding(length: int, d_model: int, device=None) -> torch.Tensor:
    """(1, 2*length-1, d_model) sinusoid table, offsets length-1 .. -(length-1)."""
    offsets = np.arange(length - 1, -length, -1, dtype=np.float32)
    inv_freq = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    angles = np.abs(offsets)[:, None] * inv_freq[None, :]
    pe = np.zeros((offsets.shape[0], d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(np.sign(offsets)[:, None] * angles)
    pe[:, 1::2] = np.cos(angles)
    return torch.from_numpy(pe[None]).to(device)


@functools.lru_cache(maxsize=32)
def _cached_table(length: int, d_model: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):  # a normal tensor, usable outside inference mode too
        return relative_position_encoding(length, d_model, device).to(dtype)


def rel_positional_encoding(x: torch.Tensor, d_model: int):
    """Scale the (B, T, D) input and return it with its (cached, shared,
    read-only) position table in x's dtype."""
    x = x * math.sqrt(d_model)
    return x, _cached_table(x.shape[-2], d_model, x.device, x.dtype)
