"""Relative positional encodings (Transformer-XL style).

For a length-T input the table covers relative offsets T-1 ... -(T-1)
(reference ``Layers/PositionalEncoding.py:68-131``).  The conformers take
each table from a cache per (length, width, device): a table made on the
host and copied to the card is a host-to-device copy, which a CUDA graph
cannot capture, so the warm-up before a capture fills the cache.  A graph
reads its tables by address, so a capture holds them (``build.hold``) for
as long as its graph lives, whatever the cache evicts.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import build


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


def rel_positional_encoding(x: torch.Tensor, d_model: int, dropout_rate: float = 0.0,
                            deterministic: bool = True):
    """Scale the (B, T, D) input and return it with its (cached, shared,
    read-only) position table in x's dtype (JAX makes it in f32 and casts
    it to the model's dtype).  Unless ``deterministic``, both go through
    dropout, each with its own draw (``toucan_tpu/nn/positional.py:39``)."""
    x = x * math.sqrt(d_model)
    table = build.hold(_cached_table(x.shape[-2], d_model, x.device, x.dtype))
    if deterministic:
        return x, table
    return F.dropout(x, dropout_rate), F.dropout(table, dropout_rate)
