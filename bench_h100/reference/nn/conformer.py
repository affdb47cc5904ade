"""Conformer encoder/decoder stack.

Reference: ``Layers/Conformer.py:17-134`` and ``Layers/EncoderLayer.py:39-144``:
macaron FFN halves around rel-pos MHSA and a depthwise conv module,
pre-norm residuals, optional articulatory input embedding, language
embedding offset, and the utterance embedding joined by concat+projection
after the stack.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.nn.attention import RelPositionMultiHeadedAttention
from bench_h100.reference.nn.convolution import ConformerConvModule, ConvFeedForward
from bench_h100.reference.nn.norms import LayerNorm
from bench_h100.reference.nn.positional import rel_positional_encoding


class ConformerBlock(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int, cnn_kernel: int):
        super().__init__()
        self.norm_ff_macaron = LayerNorm(size)
        self.feed_forward_macaron = ConvFeedForward(size, linear_units)
        self.norm_mha = LayerNorm(size)
        self.self_attn = RelPositionMultiHeadedAttention(attention_heads, size)
        self.norm_conv = LayerNorm(size)
        self.conv_module = ConformerConvModule(size, cnn_kernel)
        self.norm_ff = LayerNorm(size)
        self.feed_forward = ConvFeedForward(size, linear_units)
        self.norm_final = LayerNorm(size)

    def forward(self, x, pos_emb, mask=None, conv_mask=None):
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        y = self.norm_mha(x)
        x = x + self.self_attn(y, y, y, pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x), mask=conv_mask)
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class Conformer(nn.Module):
    def __init__(self, attention_dim: int = 192, attention_heads: int = 4,
                 linear_units: int = 1536, num_blocks: int = 6, cnn_kernel: int = 7,
                 use_input_embedding: bool = False, input_features: int = 62,
                 input_embedding_hidden: int = 100, use_output_norm: bool = True,
                 utt_embed_dim: Optional[int] = None, lang_embs: Optional[int] = None,
                 dropout_rate: float = 0.0):
        """``dropout_rate`` is taken for the model's signature; inference
        uses none."""
        super().__init__()
        self.attention_dim = attention_dim
        if use_input_embedding:
            self.embed = nn.Sequential(nn.Linear(input_features, input_embedding_hidden),
                                       nn.Tanh(),
                                       nn.Linear(input_embedding_hidden, attention_dim))
        if lang_embs is not None:
            self.language_embedding = nn.Embedding(lang_embs, attention_dim)
        self.encoders = nn.ModuleList(
            ConformerBlock(attention_dim, attention_heads, linear_units, cnn_kernel)
            for _ in range(num_blocks))
        if use_output_norm:
            self.output_norm = LayerNorm(attention_dim)
        if utt_embed_dim is not None:
            self.hs_emb_projection = nn.Linear(attention_dim + utt_embed_dim, attention_dim)

    def forward(self, xs, mask=None, utterance_embedding=None, lang_ids=None, conv_mask=None):
        """xs (B, T, idim); mask (B, 1, T) bool, True on real frames, or None;
        lang_ids (B, 1); conv_mask (B, T, 1) zeroes padded frames before each
        depthwise conv."""
        if hasattr(self, "embed"):
            xs = self.embed(xs)
        if hasattr(self, "language_embedding") and lang_ids is not None:
            xs = xs + self.language_embedding(lang_ids)
        xs, pos_emb = rel_positional_encoding(xs, self.attention_dim)
        for block in self.encoders:
            xs = block(xs, pos_emb, mask, conv_mask)
        if hasattr(self, "output_norm"):
            xs = self.output_norm(xs)
        if hasattr(self, "hs_emb_projection") and utterance_embedding is not None:
            emb = F.normalize(utterance_embedding, dim=-1).to(xs.dtype)
            emb = emb[:, None, :].expand(xs.shape[0], xs.shape[1], emb.shape[-1])
            xs = self.hs_emb_projection(torch.cat([xs, emb], dim=-1))
        return xs
