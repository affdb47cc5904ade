"""Rel-pos flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_attention.py``.  The kernel is
``csrc/flash_rel_attention.cu``.  ``flash_rel_attention`` launches it for
CUDA tensors and runs ``flash_rel_attention_plain`` for CPU tensors; any
other device raises.  The kernel is built for the head dims in
``BUILT_HEAD_DIMS``; any other d up to 128 goes in zero-padded to the next
of them (``padded_inputs``).  It takes f32 inputs (split TF32 products) or
bf16 inputs (bf16 products, f32 softmax), as the JAX kernel takes the
dtype of its model; the output is f32 either way.  ``flash_rel_attention.bf16``
counts the bf16 instantiation's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from toucan_tpu_torch.kernels import build

BUILT_HEAD_DIMS = (16, 32, 48, 64, 96, 128)
MAX_HEAD_DIM = BUILT_HEAD_DIMS[-1]
DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {torch.float32: "flash_rel_attention_f32", torch.bfloat16: "flash_rel_attention_bf16"}


def padded_inputs(q_u, q_v, k, v, p):
    """(q_u, q_v, k, v, p) with the head dim zero-padded to the next built
    width, or as they are where d is built.  Zero columns add nothing to
    q_u . k or q_v . p, so the scores are those of the true d (scaled by
    1 / sqrt(d) of the true d), and the output's extra columns are 0 and
    cut off.  d <= MAX_HEAD_DIM (``_check`` raises past it)."""
    d = q_u.shape[-1]
    width = next(w for w in BUILT_HEAD_DIMS if w >= d)
    if width == d:
        return q_u, q_v, k, v, p
    return tuple(torch.nn.functional.pad(x, (0, width - d)) for x in (q_u, q_v, k, v, p))


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


def _check(q_u, q_v, k, v, p, lengths):
    b, h, t, d = q_u.shape
    for name, x in (("q_v", q_v), ("k", k), ("v", v)):
        if x.shape != q_u.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(q_u.shape)}")
    if p.shape != (h, 2 * t - 1, d):
        raise ValueError(f"p has shape {tuple(p.shape)}, expected {(h, 2 * t - 1, d)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be an int32 tensor of shape (B,)")
    if q_u.dtype not in DTYPES:
        raise ValueError(f"q_u must be float32 or bfloat16, got {q_u.dtype}")
    for name, x in (("q_u", q_u), ("q_v", q_v), ("k", k), ("v", v), ("p", p)):
        if x.dtype != q_u.dtype:
            raise ValueError(f"{name} must be {q_u.dtype} as q_u is, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for x in (q_v, k, v, p, lengths):
        if x.device != q_u.device:
            raise ValueError("all inputs must be on one device")
    build.check_aligned("flash_rel_attention", q_u=q_u, q_v=q_v, k=k, v=v, p=p)
    build.check_no_grad("flash_rel_attention", q_u=q_u, q_v=q_v, k=k, v=v, p=p)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}: the kernel takes at most "
                         f"{MAX_HEAD_DIM}")
    if t < 1 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape B={b} H={h} T={t}")


def flash_rel_attention(q_u, q_v, k, v, p, lengths):
    """Launch the CUDA kernel on CUDA tensors; plain version on CPU tensors.

    Same arguments as ``flash_rel_attention_plain``, all five float32 or
    all five bfloat16; returns (B, H, T, d) f32.  A head dim the kernel is
    not built for is zero-padded (``padded_inputs``).
    The kernel has no backward: on the card a call with grad enabled on an
    input that requires grad raises ValueError.
    """
    if q_u.device.type == "cpu":
        return flash_rel_attention_plain(q_u, q_v, k, v, p, lengths)
    if q_u.device.type != "cuda":
        raise ValueError(f"flash_rel_attention takes cuda or cpu tensors, got {q_u.device}")
    _check(q_u, q_v, k, v, p, lengths)
    lib = build.load("flash_rel_attention")
    fn = getattr(lib, _ENTRY[q_u.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    b, h, t, d = q_u.shape
    q_u, q_v, k, v, p = padded_inputs(q_u, q_v, k, v, p)
    out = torch.empty(q_u.shape, dtype=torch.float32, device=q_u.device)
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = fn(q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(),
                 p.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, t, q_u.shape[-1],
                 1.0 / math.sqrt(d), stream)
    build.check(lib, err, "flash_rel_attention")
    build.count_launch(flash_rel_attention)
    if q_u.dtype == torch.bfloat16:
        build.count_launch(flash_rel_attention.bf16)
    return out if out.shape[-1] == d else out[..., :d].contiguous()


flash_rel_attention.launches = 0
flash_rel_attention.bf16 = build.LaunchCount("flash_rel_attention bf16")
