"""Multi-head attention with Transformer-XL relative position bias.

Reference semantics ``Layers/Attention.py:113-198``, run through K1's plain
version, ``kernels_plain.py::flash_rel_attention_plain``.  (Frozen copy of
``toucan_tpu_torch/nn/attention.py``, cut to inference.)
"""

import torch
from torch import nn

from bench_h100.reference.kernels_plain import flash_rel_attention_plain


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def forward(self, query, key, value, pos_emb, mask=None):
        """query/key/value (B, T, F); pos_emb (1, 2T-1, F); mask (B, 1, T)
        bool, True on real keys, or None."""
        b, t, _ = query.shape
        q = _split_heads(self.linear_q(query), self.h)
        k = _split_heads(self.linear_k(key), self.h).contiguous()
        v = _split_heads(self.linear_v(value), self.h).contiguous()
        p = _split_heads(self.linear_pos(pos_emb), self.h)[0].contiguous()  # (H, 2T-1, d)
        q_u = (q + self.pos_bias_u[None, :, None, :]).contiguous()
        q_v = (q + self.pos_bias_v[None, :, None, :]).contiguous()
        if mask is None:
            lengths = torch.full((b,), t, dtype=torch.int32, device=query.device)
        else:
            lengths = mask.reshape(b, -1)[:, -t:].sum(-1, dtype=torch.int32)
        o = flash_rel_attention_plain(q_u, q_v, k, v, p, lengths)
        x = o.transpose(1, 2).reshape(b, t, self.h * self.d_k)
        return self.linear_out(x.to(query.dtype))

