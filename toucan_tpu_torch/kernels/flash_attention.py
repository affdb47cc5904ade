"""Rel-pos flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_attention.py``.  The kernel is
``csrc/flash_rel_attention.cu``.  ``flash_rel_attention`` launches it for
CUDA tensors and runs ``flash_rel_attention_plain`` for CPU tensors; any
other device raises.  The kernel is built for the head dims in
``BUILT_HEAD_DIMS``; any other d up to 128 goes in zero-padded to the next
of them (``padded_inputs``).  It takes f32 inputs (split TF32 products) or
bf16 inputs (bf16 products, f32 softmax), as the JAX kernel takes the
dtype of its model; the output is f32 either way.  ``flash_rel_attention.bf16``
counts the bf16 kernel's launches.  The bf16 kernel's launch (tiles, key
splits, grid, shared memory) is ``bf16_geometry``, a function of the
shapes alone; ``flash_rel_attention_split_plain`` is a plain model of its
split-and-combine arithmetic, for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from toucan_tpu_torch.kernels import build

BUILT_HEAD_DIMS = (16, 32, 48, 64, 96, 128)
MAX_HEAD_DIM = BUILT_HEAD_DIMS[-1]
DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {torch.float32: "flash_rel_attention_f32", torch.bfloat16: "flash_rel_attention_bf16"}
SM_COUNT = 132     # H100 SXM
# the bf16 kernel (csrc/flash_rel_attention.cu, namespace bf16): query and
# key tiles, K/V ring stages, p chunk slots, padded BD row (floats)
BF16_QUERY_TILE = 64
BF16_KEY_TILE = 64
_BF16_KV_STAGES, _BF16_P_SLOTS, _BF16_BD_ROW = 3, 3, 88


@dataclasses.dataclass(frozen=True)
class Bf16Geometry:
    """One launch of the bf16 kernel: ``splits`` runs of ``tiles_per_split``
    consecutive key tiles per query tile (the last may be shorter, none is
    empty), ``grid`` = (query tiles x splits, H, B), and the dynamic shared
    memory of one block."""
    query_tile: int
    key_tile: int
    splits: int
    tiles_per_split: int
    grid: tuple
    smem_bytes: int


def bf16_geometry(b: int, h: int, t: int, d: int) -> Bf16Geometry:
    """The bf16 kernel's launch at (B, H, T, d), from the shapes alone (the
    wrapper never reads ``lengths`` on the host, so a CUDA graph can hold
    the call).  Where the B H ceil(T / 64) query tiles are fewer than two
    blocks an SM, the key tiles may go to splits: the count whose estimated
    time is least, the fewest splits on a tie.  The estimate counts, in
    key-tile times, the waves of resident blocks (two an SM up to d = 64,
    else one) times a block's key tiles plus one for its set-up and writes,
    plus one for the combine where there are splits."""
    width = next(w for w in BUILT_HEAD_DIMS if w >= d)
    n_qt, n_kt = -(-t // BF16_QUERY_TILE), -(-t // BF16_KEY_TILE)
    tiles, slots = b * h * n_qt, SM_COUNT * (2 if width <= 64 else 1)
    splits, per = 1, n_kt
    if tiles < 2 * SM_COUNT:
        best = None
        for want in range(1, n_kt + 1):
            p = -(-n_kt // want)
            s = -(-n_kt // p)  # none empty
            cost = -(-tiles * s // slots) * (p + 1) + (s > 1)
            if best is None or cost < best:
                best, splits, per = cost, s, p
    region = 64 * 128 * -(-width // 64)  # 64 rows of 128-byte swizzle rows per 64 columns
    smem = (1024 + region * (2 + 2 * _BF16_KV_STAGES + _BF16_P_SLOTS)
            + 4 * 16 * _BF16_BD_ROW * 4 + 8 * (1 + 2 * _BF16_KV_STAGES + 2 * _BF16_P_SLOTS))
    return Bf16Geometry(BF16_QUERY_TILE, BF16_KEY_TILE, splits, per,
                        (n_qt * splits, h, b), smem)


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


def flash_rel_attention_split_plain(q_u, q_v, k, v, p, lengths, key_tile=BF16_KEY_TILE,
                                    splits=None, scale=None):
    """The bf16 kernel's key splits in plain PyTorch, for the tests: the
    same result as ``flash_rel_attention_plain`` by way of the kernel's
    arithmetic.  The T keys go in tiles of ``key_tile`` to ``splits`` runs
    of consecutive tiles (by default ``bf16_geometry``'s); each split keeps,
    per row and in the log2 domain, the maximum m of its valid scores (-inf
    if none), l = sum 2^(s - m) and o = sum 2^(s - m) v; the combine takes
    M = max m and returns sum 2^(m - M) o / sum 2^(m - M) l, or 0 where M is
    -inf.  The main path never calls it.
    """
    if q_u.dtype == torch.bfloat16:
        q_u, q_v, k, v, p = (x.float() for x in (q_u, q_v, k, v, p))
    b, h, t, d = q_u.shape
    n_kt = -(-t // key_tile)
    if splits is None:
        splits = -(-n_kt // bf16_geometry(b, h, t, d).tiles_per_split)
    per = -(-n_kt // splits)
    splits = -(-n_kt // per)  # none empty
    ar = torch.arange(t, device=q_u.device)
    rel = (t - 1 - ar[:, None] + ar[None, :]).expand(b, h, t, t)
    scores = q_u @ k.transpose(-1, -2) + (q_v @ p.transpose(-1, -2)[None]).gather(-1, rel)
    scores = scores * ((1.0 / math.sqrt(d) if scale is None else scale) * math.log2(math.e))
    key_ok = (ar[None, :] < lengths[:, None].to(ar.dtype))[:, None, None, :]
    scores = scores.masked_fill(~key_ok, -math.inf)
    parts = []
    for s in range(splits):
        sc = scores[..., s * per * key_tile:(s + 1) * per * key_tile]
        m = sc.amax(-1)
        e = torch.exp2(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        parts.append((m, e.sum(-1), e @ v[..., s * per * key_tile:(s + 1) * per * key_tile, :]))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    top = torch.where(torch.isinf(top), 0.0, top)
    l_sum, o_sum = 0.0, 0.0
    for m, l, o in parts:
        w = torch.exp2(m - top)  # 0 for a split with no valid key
        l_sum, o_sum = l_sum + w * l, o_sum + w[..., None] * o
    return torch.where(l_sum[..., None] > 0,
                       o_sum / torch.where(l_sum > 0, l_sum, 1.0)[..., None], 0.0)


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
    b, h, t, d = q_u.shape
    q_u, q_v, k, v, p = padded_inputs(q_u, q_v, k, v, p)
    width = q_u.shape[-1]
    out = torch.empty(q_u.shape, dtype=torch.float32, device=q_u.device)
    ptrs = [x.data_ptr() for x in (q_u, q_v, k, v, p, lengths, out)]
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        if q_u.dtype == torch.float32:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                        ctypes.c_void_p]
            err = fn(*ptrs, b, h, t, width, 1.0 / math.sqrt(d), stream)
        else:
            geo = bf16_geometry(b, h, t, d)
            parts = (None, None)
            if geo.splits > 1:  # the splits' partial rows and their (max, sum)
                parts = (torch.empty((geo.splits, b, h, t, width), dtype=torch.float32,
                                     device=q_u.device),
                         torch.empty((geo.splits, b, h, t, 2), dtype=torch.float32,
                                     device=q_u.device))
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                        ctypes.c_void_p]
            err = fn(*ptrs, *(x if x is None else x.data_ptr() for x in parts), b, h, t, width,
                     geo.splits, geo.tiles_per_split, 1.0 / math.sqrt(d), stream)
    build.check(lib, err, "flash_rel_attention")
    build.count_launch(flash_rel_attention)
    if q_u.dtype == torch.bfloat16:
        build.count_launch(flash_rel_attention.bf16)
    return out if out.shape[-1] == d else out[..., :d].contiguous()


flash_rel_attention.launches = 0
flash_rel_attention.bf16 = build.LaunchCount("flash_rel_attention bf16")
