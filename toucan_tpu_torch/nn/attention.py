"""Multi-head attention with Transformer-XL relative position bias.

Reference semantics: ``Layers/Attention.py:113-198``.  Inference
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
            o = self._attend_with_dropout(q_u, q_v, k, v, p, mask)
        else:
            if mask is None:
                lengths = torch.full((b,), t, dtype=torch.int32, device=query.device)
            else:
                lengths = mask.reshape(b, -1)[:, -t:].sum(-1, dtype=torch.int32)
            o = flash_rel_attention(q_u, q_v, k, v, p, lengths)  # f32, as JAX's kernel returns it
        return self.linear_out(o.transpose(1, 2).reshape(b, t, self.h * self.d_k).to(query.dtype))

    def _attend_with_dropout(self, q_u, q_v, k, v, p, mask):
        """The training path: masked softmax of (q_u.k + rel_shift(q_v.p)) /
        sqrt(d), masked again, attention dropout, then . v."""
        scores = (q_u @ k.transpose(-1, -2) + rel_shift(q_v @ p.transpose(-1, -2)[None])) \
            / math.sqrt(self.d_k)
        if mask is not None:
            m = mask[:, None]                                          # (B, 1, 1, T)
            scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
            attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)
        else:
            attn = torch.softmax(scores, dim=-1)
        return F.dropout(attn, self.dropout_rate, training=True) @ v
