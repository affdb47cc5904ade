"""Multi-head attention: plain, and with Transformer-XL relative position bias.

``MultiHeadedAttention`` is the reference's plain attention
(``Layers/Attention.py:16-110``, JAX ``toucan_tpu/nn/attention.py:35-50``):
no model of the package uses it, and it takes no kernel.
``RelPositionMultiHeadedAttention``: reference semantics
``Layers/Attention.py:113-198``.  Inference
(``deterministic=True``) runs ``kernels/flash_attention.py::
flash_rel_attention``: the CUDA kernel for CUDA tensors at every T, its
plain version for CPU tensors.  Training (``deterministic=False``) takes the
plain rel-shift path with dropout on the attention probabilities, as the
JAX package's training does (``toucan_tpu/nn/attention.py:119-127``): the
kernel has neither dropout nor a backward.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from toucan_tpu_torch.kernels.flash_attention import flash_rel_attention


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _attend(v, scores, mask, dropout_rate, deterministic):
    """JAX's ``_attend``: scores (B, H, T1, T2), mask (B, 1 or T1, T2) bool,
    True on real keys, or None; masked softmax, masked again, dropout
    unless ``deterministic``, then . v, heads merged -> (B, T1, H d)."""
    if mask is not None:
        m = mask[:, None]                                              # (B, 1, 1 or T1, T2)
        scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)
    else:
        attn = torch.softmax(scores, dim=-1)
    if not deterministic:
        attn = F.dropout(attn, dropout_rate, training=True)
    x = attn @ v
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product attention over ``linear_q``/``linear_k``/
    ``linear_v`` projections and ``linear_out``."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, query, key, value, mask=None, deterministic: bool = True):
        """query (B, T1, F), key/value (B, T2, F); mask (B, 1 or T1, T2)
        bool, True on real keys, or None."""
        q = _split_heads(self.linear_q(query), self.h)
        k = _split_heads(self.linear_k(key), self.h)
        v = _split_heads(self.linear_v(value), self.h)
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d_k)
        return self.linear_out(_attend(v, scores, mask, self.dropout_rate, deterministic))


def rel_shift(x):
    """(B, H, T, 2T-1) -> (B, H, T, T); out[i, j] = x[i, T-1-i+j] (the
    Transformer-XL pad/reshape trick, as ``toucan_tpu/nn/attention.py::rel_shift``)."""
    b, h, t, w = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, w + 1, t)
    return x[:, :, 1:].reshape(b, h, t, w)[..., :t]


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def forward(self, query, key, value, pos_emb, mask=None, deterministic: bool = True):
        """query/key/value (B, T, F); pos_emb (1, 2T-1, F); mask (B, 1, T)
        bool, True on real keys, or None."""
        b, t, _ = query.shape
        q = _split_heads(self.linear_q(query), self.h)
        k = _split_heads(self.linear_k(key), self.h).contiguous()
        v = _split_heads(self.linear_v(value), self.h).contiguous()
        p = _split_heads(self.linear_pos(pos_emb), self.h)[0].contiguous()  # (H, 2T-1, d)
        q_u = (q + self.pos_bias_u[None, :, None, :]).contiguous()
        q_v = (q + self.pos_bias_v[None, :, None, :]).contiguous()
        if not deterministic:
            x = self._attend_with_dropout(q_u, q_v, k, v, p, mask)
        else:
            if mask is None:
                lengths = torch.full((b,), t, dtype=torch.int32, device=query.device)
            else:
                lengths = mask.reshape(b, -1)[:, -t:].sum(-1, dtype=torch.int32)
            o = flash_rel_attention(q_u, q_v, k, v, p, lengths)  # f32, as JAX's kernel returns it
            x = o.transpose(1, 2).reshape(b, t, self.h * self.d_k)
        return self.linear_out(x.to(query.dtype))

    def _attend_with_dropout(self, q_u, q_v, k, v, p, mask):
        """The training path: ``_attend`` of (q_u.k + rel_shift(q_v.p)) /
        sqrt(d), with attention dropout."""
        scores = (q_u @ k.transpose(-1, -2) + rel_shift(q_v @ p.transpose(-1, -2)[None])) \
            / math.sqrt(self.d_k)
        return _attend(v, scores, mask, self.dropout_rate, deterministic=False)
