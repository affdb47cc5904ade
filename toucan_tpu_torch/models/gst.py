"""GST speaker/style embedding, inference.

Counterpart of ``toucan_tpu/models/gst.py``; reference
``TrainingInterfaces/Spectrogram_to_Embedding/GST.py`` and
``StyleEmbedding.py``.  A spectrogram is tiled cyclically to exactly 812
frames, a reference encoder (eight stride-2 3x3 Conv2d with BatchNorm and
ReLU, then a 2-layer GRU of 256 units) summarizes it, and attention over a
bank of 2000 style tokens gives the 64-dim embedding.  Parameter names are
the reference's state-dict keys (``gst.ref_enc.convs.{3i}``, the batch norm
at ``{3i+1}``, ``gst.ref_enc.gst`` the GRU, ``gst.stl.gst_embs`` and
``gst.stl.mha.linear_{q,k,v,out}``).

``train=True`` is the JAX module's training call: the BatchNorms normalize
with the batch's statistics and update the running ones as flax does
(``nn/convolution.py::train_batch_norm``; ``update_stats=False`` leaves
them as they are, for a step that discards them), and the output carries
gradients.  ``train=False`` (the default) runs on the running statistics
under ``torch.no_grad()``, whatever the module's mode.
"""

import contextlib

import torch
from torch import nn

from toucan_tpu_torch.nn.convolution import batch_norm

GST_FRAMES = 812
MELS = 80
CONV_CHANS = (32, 32, 64, 64, 128, 128, 256, 256)   # 3x3 convs, stride 2, padding 1
REF_DIM = 256       # GRU units, 2 layers
TOKENS = 2000
TOKEN_DIM = 64
HEADS = 8


def tile_to_fixed_frames(spec: torch.Tensor, length: int) -> torch.Tensor:
    """(L, 80), true length -> (812, 80) by cyclic repetition of the
    true-length prefix, as the reference's repeat-doubling loop
    (StyleEmbedding.py:41-52) cuts it at 812."""
    idx = torch.arange(GST_FRAMES, device=spec.device) % max(int(length), 1)
    return spec[idx]


def tile_batch(specs: torch.Tensor, lengths) -> torch.Tensor:
    """``tile_to_fixed_frames`` of each row of (B, L, 80) with its length,
    (B,) of ints or a tensor, without reading the lengths on the host."""
    lengths = torch.as_tensor(lengths, device=specs.device).to(torch.int64).clamp(min=1)
    idx = torch.arange(GST_FRAMES, device=specs.device)[None] % lengths[:, None]
    return torch.gather(specs, 1, idx[..., None].expand(-1, -1, specs.shape[-1]))


class ReferenceEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        layers, cin, freq = [], 1, MELS
        for ch in CONV_CHANS:
            layers += [nn.Conv2d(cin, ch, 3, 2, 1, bias=False), nn.BatchNorm2d(ch), nn.ReLU()]
            cin, freq = ch, (freq - 1) // 2 + 1
        self.convs = nn.Sequential(*layers)
        self.gst = nn.GRU(cin * freq, REF_DIM, 2, batch_first=True)

    def forward(self, speech: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        """speech (B, L, 80) -> (B, 256)."""
        x = speech[:, None]
        for conv, bn in zip(self.convs[::3], self.convs[1::3]):
            x = torch.relu(batch_norm(bn, conv(x), train, update_stats))  # (B, C, L', F')
        b, c, t, f = x.shape
        # channel-major flatten per time step, as the reference views (B, L', C, F')
        x = x.transpose(1, 2).reshape(b, t, c * f)
        _, h = self.gst(x)
        return h[-1]


class _TokenAttention(nn.Module):
    """The style-token layer's 4-linear attention (ESPnet GST layout)."""

    def __init__(self, q_dim: int, k_dim: int, n_feat: int):
        super().__init__()
        self.linear_q = nn.Linear(q_dim, n_feat)
        self.linear_k = nn.Linear(k_dim, n_feat)
        self.linear_v = nn.Linear(k_dim, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)


class StyleTokenLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.gst_embs = nn.Parameter(torch.randn(TOKENS, TOKEN_DIM // HEADS))
        self.mha = _TokenAttention(REF_DIM, TOKEN_DIM // HEADS, TOKEN_DIM)

    def forward(self, ref_embs: torch.Tensor) -> torch.Tensor:
        """(B, 256) -> (B, 64): attention of the reference over the tanh of
        the token bank, 8 heads split from the 64 features."""
        keys = torch.tanh(self.gst_embs)
        b, tokens, h = ref_embs.shape[0], keys.shape[0], HEADS
        q = self.mha.linear_q(ref_embs).view(b, h, -1)
        k = self.mha.linear_k(keys).view(tokens, h, -1)
        v = self.mha.linear_v(keys).view(tokens, h, -1)
        scores = torch.einsum("bhd,thd->bht", q, k) / q.shape[-1] ** 0.5
        out = torch.einsum("bht,thd->bhd", scores.softmax(dim=-1), v).reshape(b, -1)
        return self.mha.linear_out(out)


class _StyleEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.ref_enc = ReferenceEncoder()
        self.stl = StyleTokenLayer()


class StyleEmbedding(nn.Module):
    """Full GST: tiled spectrogram -> reference encoder -> style tokens."""

    def __init__(self):
        super().__init__()
        self.gst = _StyleEncoder()

    def forward(self, spectrograms: torch.Tensor, spectrogram_lengths,
                return_only_refs: bool = False, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        """(B, L, 80), (B,) true lengths -> (B, 64), or the reference
        encoder's (B, 256) with ``return_only_refs``."""
        with contextlib.nullcontext() if train else torch.no_grad():
            tiled = tile_batch(spectrograms, spectrogram_lengths)
            refs = self.gst.ref_enc(tiled, train, update_stats)
            return refs if return_only_refs else self.gst.stl(refs)

    def token_spread_regularizer(self) -> torch.Tensor:
        """The sum of the upper off-diagonal cosine similarities of the token
        bank (the reference's O(N^2) loop, ``GST.py:80-87``, as one gram
        matrix, as ``toucan_tpu/models/gst.py::token_spread_regularizer``)."""
        embs = self.gst.stl.gst_embs
        normed = embs / torch.linalg.vector_norm(embs, dim=1, keepdim=True).clamp(min=1e-8)
        return torch.triu(normed @ normed.T, diagonal=1).sum()
