"""The plain versions of the port's kernels that the reference runs in their place.

Frozen copies: ``flash_rel_attention_plain`` of
``toucan_tpu_torch/kernels/flash_attention.py`` (K1) and
``hifigan_stage_plain`` of ``toucan_tpu_torch/kernels/resstack.py`` (K2),
the latter on the stage's own modules instead of packed weights.  K5's plain
version is ``nn/alias_free.py::alias_free_snake``.
"""

import math

import torch
import torch.nn.functional as F


def flash_rel_attention_plain(q_u, q_v, k, v, p, lengths, scale=None):
    """softmax(((q_u.k) + rel_shift(q_v.p)) * scale) . v with a key mask.

    q_u, q_v, k, v (B, H, T, d); p (H, 2T-1, d) with row T-1 = offset 0;
    lengths (B,) valid key counts; scale 1 / sqrt(d) by default.  Keys >=
    lengths[b] are masked; rows with no valid key give 0; padded query rows
    attend to the valid keys.  bf16 inputs are upcast to f32 first, as the
    JAX kernel's body upcasts them; the result is f32.
    """
    if q_u.dtype == torch.bfloat16:
        q_u, q_v, k, v, p = (x.float() for x in (q_u, q_v, k, v, p))
    b, h, t, d = q_u.shape
    ar = torch.arange(t, device=q_u.device)
    ac = q_u @ k.transpose(-1, -2)                               # (B,H,T,T)
    bd = q_v @ p.transpose(-1, -2)[None]                         # (B,H,T,2T-1)
    rel = (t - 1 - ar[:, None] + ar[None, :]).expand(b, h, t, t)
    scores = (ac + bd.gather(-1, rel)) * (1.0 / math.sqrt(d) if scale is None else scale)
    key_ok = (ar[None, :] < lengths[:, None].to(ar.dtype))[:, None, None, :]
    scores = scores.masked_fill(~key_ok, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores, dim=-1).masked_fill(~key_ok, 0.0)
    return attn @ v


def hifigan_stage_plain(x, stacks, slope):
    """x (B, C, T) -> mean over the stage's residual stacks, each three
    rounds of LReLU, dilated conv, LReLU, conv and the residual sum (the
    copy's ``ResidualStack`` modules hold the 18 convs)."""
    acc = 0.0
    for stack in stacks:
        xb = x
        for c1, c2 in zip(stack.convs1, stack.convs2):
            xt = c1[1](F.leaky_relu(xb, slope))
            xt = c2[1](F.leaky_relu(xt, slope))
            xb = xb + xt
        acc = acc + xb
    return acc / len(stacks)
