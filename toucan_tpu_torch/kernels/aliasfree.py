"""Alias-free SnakeBeta (K5): the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_aliasfree.py``.  The kernel is
``csrc/alias_free_snake.cu``; the plain version is
``nn/alias_free.py::alias_free_snake``.  ``alias_free_snake`` launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; any
other device raises.  Unlike the Pallas kernel, which covers the interior
and leaves the edges to its caller, one launch computes every sample,
replicate-padded edges included.  It takes f32 or bf16 x (the JAX kernel
streams its model's dtype): bf16 is read and written as bf16 and computed
in f32, with e^alpha and 1 / (e^beta + eps) rounded to bf16 first;
``alias_free_snake.bf16`` counts that instantiation's launches.

The kernel computes the 2x signal as its even and odd branches with the
four phase filters of ``phase_filters``; ``alias_free_snake_polyphase`` is
the same formula in PyTorch, and ``snake_geometry`` picks each launch's
runs and blocks.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.nn.alias_free import SNAKE_EPS, kaiser_sinc_filter
from toucan_tpu_torch.nn.alias_free import alias_free_snake as alias_free_snake_plain

__all__ = ["alias_free_snake", "alias_free_snake_plain", "alias_free_snake_polyphase",
           "phase_filters", "snake_geometry"]

CHUNK = 256           # samples a warp holds at once: 32 lanes x 8
WARPS_PER_BLOCK = 4
# blocks the H100 runs at once on one SM (the kernel's 128 registers a
# thread); the card is asked in ``_slots``, this is the chooser's default
BLOCKS_PER_SM = 4
# a run's extra cost in chunks: the 10 snakes at its two ends (one a lane)
# and the chunk its pipeline computes before the first output
RUN_OVERHEAD = 0.25


@functools.lru_cache(maxsize=None)
def phase_filters():
    """(up0, up1, dn_even, dn_odd): the 12-tap resampling filter split into
    four 7-tap phase filters, tap p at time offset p - 3:

        y_e[v] = sum_p up0[p] x[v + p - 3],  y_o[v] = sum_p up1[p] x[v + p - 3]
        z[u]   = sum_p dn_even[p] s_e[u + p - 3] + dn_odd[p] s_o[u + p - 3]

    with y_e, y_o the even and odd samples of the 2x signal and s_e, s_o
    their snakes (the split of ``toucan_tpu/nn/alias_free.py::_phase_filters``).
    """
    filt = kaiser_sinc_filter(0.25, 0.3, 12)
    up0, up1, dn_even, dn_odd = (np.zeros(7, np.float32) for _ in range(4))
    for q in range(6):
        up0[q] = 2.0 * filt[11 - 2 * q]
        up1[q + 1] = 2.0 * filt[10 - 2 * q]
        dn_even[q + 1] = filt[2 * q + 1]
        dn_odd[q] = filt[2 * q]
    return up0, up1, dn_even, dn_odd


def alias_free_snake_polyphase(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                               taps=None) -> torch.Tensor:
    """The kernel's formula in PyTorch, in x's dtype: (B, T, C) -> (B, T, C).

    x is clamped to [0, T); the 2x signal is clamped at its own level, so
    the snakes left of 0 are s_e[0] and right of T - 1 are s_o[T - 1].
    ``taps``: the four phase filters (default ``phase_filters()``).
    """
    up0, up1, dn_even, dn_odd = (torch.as_tensor(np.asarray(k), dtype=x.dtype, device=x.device)
                                 for k in (taps or phase_filters()))
    t = x.shape[1]
    xc = x.transpose(1, 2)
    xp = torch.cat([xc[..., :1].expand(*xc.shape[:2], 3), xc,
                    xc[..., -1:].expand(*xc.shape[:2], 3)], dim=-1)
    a = torch.exp(alpha)[:, None]
    ib = 1.0 / (torch.exp(beta)[:, None] + SNAKE_EPS)

    def fir(sig, k):
        return sum(k[p] * sig[..., p:p + t] for p in range(7))

    def snake(y):
        return y + ib * torch.sin(y * a) ** 2

    s_e, s_o = snake(fir(xp, up0)), snake(fir(xp, up1))
    left, right = s_e[..., :1].expand(*s_e.shape[:2], 3), s_o[..., -1:].expand(*s_o.shape[:2], 3)
    z = fir(torch.cat([left, s_e, right], -1), dn_even) + fir(torch.cat([left, s_o, right], -1),
                                                              dn_odd)
    return z.transpose(1, 2)


@dataclass(frozen=True)
class SnakeGeometry:
    """How one K5 launch cuts its work (see ``snake_geometry``)."""

    seg_chunks: int    # chunks of CHUNK samples in one warp's run
    segs_per_row: int  # runs per row of time
    items: int         # runs in all: B x C x segs_per_row
    blocks: int        # blocks of WARPS_PER_BLOCK warps launched
    vector: bool       # float4 loads and stores (every row 16-byte aligned)

    @property
    def warps(self) -> int:
        return self.blocks * WARPS_PER_BLOCK


@functools.lru_cache(maxsize=512)
def snake_geometry(b: int, t: int, c: int, n_sm: int, blocks_per_sm: int = BLOCKS_PER_SM,
                   aligned: bool = True, persistent: bool = True,
                   per_vector: int = 4) -> SnakeGeometry:
    """Pick K5's run length and grid for x (B, T, C).

    A warp walks one run of ``seg_chunks`` chunks of one channel's row.
    The card holds ``n_sm x blocks_per_sm x 4`` warps at once; for each run
    length the estimate is the waves of runs over those slots times the
    run's cost (its chunks plus ``RUN_OVERHEAD``), and the cheapest wins
    (ties: the longer run).  Where there are more runs than slots, the
    grid is the slots and each warp walks runs in turn (persistent); else
    one warp a run.  ``persistent=False`` takes one chunk a run and one
    warp a run.  ``vector``: 16-byte access, only where every row starts on
    a 16-byte boundary (``aligned``: x does, and T is a multiple of
    ``per_vector``, the elements of 16 bytes: 4 f32 or 8 bf16).
    """
    rows, per_row = b * c, -(-t // CHUNK)
    slots = n_sm * blocks_per_sm * WARPS_PER_BLOCK
    best = (1, None)
    if persistent:
        best = None
        for seg in range(1, per_row + 1):
            items = rows * -(-per_row // seg)
            est = -(-items // slots) * (seg + RUN_OVERHEAD)
            if best is None or est <= best[1]:
                best = (seg, est)
    seg = best[0]
    segs = -(-per_row // seg)
    items = rows * segs
    warps = min(items, slots) if persistent else items
    return SnakeGeometry(seg, segs, items, -(-warps // WARPS_PER_BLOCK),
                         aligned and t % per_vector == 0)


_slots_cache: dict = {}


def _slots(device, dtype=torch.float32):
    """(SMs, blocks of K5's ``dtype`` instantiation one SM runs at once) of
    the card, asked once."""
    key = (device.index, dtype)
    if key not in _slots_cache:
        lib = build.load("alias_free_snake")
        fn = lib.alias_free_snake_blocks_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(lib, fn(ctypes.addressof(n), int(dtype == torch.bfloat16)),
                        "alias_free_snake_blocks_per_sm")
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _slots_cache[key] = (n_sm, n.value)
    return _slots_cache[key]


def geometry_for(xt: torch.Tensor, persistent: bool = True) -> SnakeGeometry:
    """The geometry ``alias_free_snake`` launches xt (B, C, T) with on its card."""
    b, c, t = xt.shape
    return snake_geometry(b, t, c, *_slots(xt.device, xt.dtype), xt.data_ptr() % 16 == 0,
                          persistent, 16 // xt.element_size())


_ENTRY = {torch.float32: "alias_free_snake_f32", torch.bfloat16: "alias_free_snake_bf16"}


@functools.lru_cache(maxsize=None)
def _launcher(lib: ctypes.CDLL, dtype: torch.dtype):
    fn = getattr(lib, _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


_TAPS = (ctypes.c_float * 28)(*np.concatenate(phase_filters()).tolist())


def _check(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor):
    """What the kernel needs of its inputs; raises ValueError before a launch."""
    if x.dim() != 3 or x.dtype not in _ENTRY:
        raise ValueError(f"x must be a (B, T, C) float32 or bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, t, c = x.shape
    for name, p in (("alpha", alpha), ("beta", beta)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {x.dtype} ({c},) tensor on {x.device}")
    if t < 1 or b < 1 or c < 1 or b * c * t >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    build.check_no_grad("alias_free_snake", x=x, alpha=alpha, beta=beta)


def alias_free_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 or bf16; alpha, beta (C,) log-scale SnakeBeta
    parameters of x's dtype; the output has x's dtype.
    The kernel walks time innermost: the (B, T, C) view of a contiguous
    (B, C, T) tensor, as the BigVGAN convs leave it, goes in without a copy;
    any other strides are copied to that layout first.  Returns the (B, T, C)
    view of a contiguous (B, C, T) tensor.  The kernel has no backward: on
    the card a call with grad enabled on an input that requires grad raises
    ValueError.
    """
    if x.device.type == "cpu":
        return alias_free_snake_plain(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"alias_free_snake takes cuda or cpu tensors, got {x.device}")
    _check(x, alpha, beta)
    b, t, c = x.shape
    xt = x.transpose(1, 2).contiguous()
    geo = geometry_for(xt)
    out = torch.empty_like(xt)
    lib = build.load("alias_free_snake")
    fn = _launcher(lib, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xt.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
                 ctypes.addressof(_TAPS), b, t, c, geo.seg_chunks, geo.blocks, int(geo.vector),
                 stream)
    build.check(lib, err, "alias_free_snake")
    build.count_launch(alias_free_snake)
    if x.dtype == torch.bfloat16:
        build.count_launch(alias_free_snake.bf16)
    return out.transpose(1, 2)


alias_free_snake.launches = 0
alias_free_snake.bf16 = build.LaunchCount("alias_free_snake bf16")
