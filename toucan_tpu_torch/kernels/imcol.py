"""im2col HiFiGAN stage (K4): the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_imcol.py``.  The kernel is
``csrc/hifigan_imcol.cu``.  One call computes a vocoder stage (three
residual stacks of six convs, averaged) in one of two modes:

- ``int8``: int8 weights with per-output-channel scales, and a *dynamic*
  activation scale per conv and window, a = max|lrelu(conv input)| over
  every row of the window; exact integer sums; f32 residual streams;
- ``bf16``: bf16 conv operands, f32 sums, f32 residual streams (unlike
  K3's bf16 mode, whose stream is bf16).

The JAX kernel's third mode, ``f32``, is numerically the exact stage; in the
port that is K2 (``kernels/resstack.py::hifigan_stage``).

What the JAX kernel computes, in unfolded samples: with the generator's
time fold f (``imcol_fold``), the stage is cut into windows of
(tile + 2 halo) f samples that start every tile f samples, the first at
-halo f; samples outside [0, T) are zero.  In each window the 18 convs run
as *circular* SAME dilated convs (the Pallas kernel builds its taps by
rolling the window), every conv output outside [0, T) is zeroed, and the
central tile f samples are kept.  The wrapped rows are garbage that stays
in the halo, but in int8 they enter the next conv's scale, so the result
depends on the window geometry: the port takes JAX's tile (512 folded
rows) and halo (``imcol_halo``) and computes every row of the window.
f32 and bf16 results do not depend on the tile.

``imcol_stage`` launches the kernel for CUDA tensors and runs
``imcol_stage_plain`` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.kernels.resstack import StageWeights
from toucan_tpu_torch.kernels.stage import (EPW, SMEM_LIMIT, ieee_div, pack_words,
                                            quantize_weight, unpack_words)

MODES = ("int8", "bf16")
_MODE_ID = {"int8": 0, "bf16": 1}
LANES = 128        # the JAX generator's min_lanes: narrower stages are time-folded to it
TILE = 512         # folded output rows per window, the JAX kernel's default
KERNEL_CHANNELS = (32, 64, 128)
_KW = 8            # 32-bit words of input channels staged per step (csrc)
_NT = 512          # threads per block (csrc)


def imcol_fold(channels: int) -> int:
    """The JAX generator's time fold of a stage of ``channels`` channels."""
    return LANES // channels if channels < LANES else 1


@functools.lru_cache(maxsize=None)
def imcol_halo(kernel_sizes: Tuple[int, ...], dilations: Tuple[int, ...], fold: int) -> int:
    """Folded rows of halo per window side, as ``stage_conv_specs`` counts
    them: per stack the sum over its convs of the farthest folded-row
    offset a tap reaches, the widest stack's, rounded up to 8 (64, 40 and 24
    at folds 1, 2 and 4 for kernel sizes 3/7/11 and dilations 1/3/5)."""
    halos = []
    for k in kernel_sizes:
        shrink = 0
        for d in dilations:
            for dd in (d, 1):
                pad = (k - 1) // 2 * dd
                qs = [(r + dd * t - pad) // fold for r in range(fold) for t in range(k)]
                shrink += max(-min(qs), max(qs))
        halos.append(shrink)
    return (max(halos) + 7) // 8 * 8


@dataclass(frozen=True)
class ImcolStage:
    """One stage's 18 convs prepared for a mode, in the packed conv order of
    ``StageWeights``.

    ``w`` is flat: per conv (k, C_in/e, C_out, e), e consecutive input
    channels of one output channel per 32-bit word (int8: e = 4, bf16:
    e = 2).  ``scale`` (18, C) holds the int8 weights' per-output-channel
    scales (ones for bf16), ``bias`` (18, C) the biases.
    """

    mode: str
    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    channels: int
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    slope: float

    def conv_weights(self):
        """(weight (C_out, C_in, k) as float32 values, dilation) per conv."""
        return unpack_words(self.w, self.mode, self.channels, self.kernel_sizes, self.dilations)


def prepare_imcol_stage(sw: StageWeights, mode: str) -> ImcolStage:
    """The stage's weights for ``mode``.  int8 quantizes each conv per
    output channel (scale = absmax / 127, round half to even of w / scale),
    which equals the JAX kernel's per-column quantization of its im2col
    weights: a column holds every tap and input channel of its output
    channel once, among zeros."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    ws, scales = [], []
    ones = torch.ones(sw.channels, device=sw.w.device)
    for w, _, _ in sw.conv_weights():
        if mode == "int8":
            w8, cs = quantize_weight(w)
            ws.append(pack_words(w8, EPW[mode]))
            scales.append(cs)
        else:
            ws.append(pack_words(w.to(torch.bfloat16), EPW[mode]))
            scales.append(ones)
    return ImcolStage(mode, torch.cat(ws).contiguous(), torch.stack(scales).float().contiguous(),
                      sw.b.float().contiguous(), sw.channels, sw.kernel_sizes, sw.dilations,
                      sw.slope)


def _windows(b: int, t: int, fold: int, tile: int, halo: int, device):
    """(number of windows per row, window samples, output samples per window,
    left margin, (B * windows, 1, window samples) in-sequence mask)."""
    n_win = -(-(t // fold) // tile)
    step, left = tile * fold, halo * fold
    width = step + 2 * left
    g = (torch.arange(n_win, device=device)[:, None] * step - left
         + torch.arange(width, device=device)[None, :])
    mask = ((g >= 0) & (g < t)).repeat(b, 1)[:, None, :]
    return n_win, width, step, left, mask


def imcol_stage_plain(x: torch.Tensor, st: ImcolStage, fold: int,
                      tile: int = TILE) -> torch.Tensor:
    """x (B, T, C) f32 -> the stage in st.mode, windowed as the JAX kernel.

    The windows are a batch: circular padding and ``F.conv1d`` per conv, a
    per-window max for the int8 scale.  int8 sums run in float64, where
    integer sums stay exact, and are rounded to f32 as an int32 -> f32
    conversion rounds them.  The order is JAX's: y * (s * (a / 127)) + b,
    then the mask; the residual add; the mean of the three streams / 3.
    """
    b, t, c = x.shape
    if t % fold:
        raise ValueError(f"T = {t} is not a multiple of the fold {fold}")
    int8 = st.mode == "int8"
    halo = imcol_halo(st.kernel_sizes, st.dilations, fold)
    n_win, width, step, left, mask = _windows(b, t, fold, tile, halo, x.device)
    xp = F.pad(x.transpose(1, 2).float(), (left, n_win * step + left - t))
    xw = xp.unfold(2, width, step).permute(0, 2, 1, 3).reshape(b * n_win, c, width)
    convs = iter(st.conv_weights())
    n, acc = 0, 0.0
    for k in st.kernel_sizes:
        xb = xw
        for _ in st.dilations:
            xt = xb
            for _half in range(2):
                w, d = next(convs)
                pad = d * (k - 1) // 2
                v = F.leaky_relu(xt, st.slope)
                bias = st.bias[n][None, :, None]
                if int8:
                    a = v.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-6)
                    q = torch.clamp(torch.round(v * ieee_div(127.0, a)), -127, 127).double()
                    s = F.conv1d(F.pad(q, (pad, pad), mode="circular"), w.double(),
                                 dilation=d).float()
                    y = s * (st.scale[n][None, :, None] * ieee_div(a, 127.0)) + bias
                else:
                    q = v.to(torch.bfloat16).float()
                    y = F.conv1d(F.pad(q, (pad, pad), mode="circular"), w, dilation=d) + bias
                xt = torch.where(mask, y, torch.zeros((), device=y.device))
                n += 1
            xb = xb + xt
        acc = acc + xb[:, :, left:left + step]
    out = ieee_div(acc, float(len(st.kernel_sizes))).reshape(b, n_win, c, step)
    return out.permute(0, 1, 3, 2).reshape(b, n_win * step, c)[:, :t].contiguous()


def _smem_bytes(mode: str, c: int, n_s: int, margin: int, k_max: int) -> int:
    """The kernel's dynamic shared memory: the quantized window with a
    circular margin on each side (rows padded by one word), one step of
    staged weights and the block reduction's slots."""
    cot = 64 if c % 64 == 0 else 32
    return 4 * ((n_s + 2 * margin) * (c // EPW[mode] + 1) + k_max * _KW * cot + _NT // 32)


def _check(x: torch.Tensor, st: ImcolStage, fold: int):
    """What the kernel needs of x and st; raises ValueError before a launch."""
    c = st.channels
    if x.dim() != 3 or x.shape[-1] != c:
        raise ValueError(f"x must be (B, T, {c}), got {tuple(x.shape)}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the kernel takes C in {KERNEL_CHANNELS}, got {c}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if any(t.device != x.device for t in (st.w, st.scale, st.bias)):
        raise ValueError("imcol stage weights must be on the input's device")
    ks, ds = st.kernel_sizes, st.dilations
    if len(ks) != 3 or len(ds) != 3 or list(ks) != sorted(ks) or list(ds) != sorted(ds):
        raise ValueError("the kernel takes 3 stacks x 3 rounds, ascending")
    if x.shape[1] % fold:
        raise ValueError(f"T = {x.shape[1]} is not a multiple of the fold {fold}")
    build.check_no_grad("imcol_stage", x=x, scale=st.scale, bias=st.bias)


def imcol_stage(x: torch.Tensor, st: ImcolStage, fold: int, tile: int = TILE) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 contiguous with C in (32, 64, 128) on the card; ``st``
    from ``prepare_imcol_stage``; ``fold`` the stage's time fold
    (``imcol_fold``).  Returns (B, T, C) f32.  The kernel has no backward:
    on the card a call with grad enabled on an input that requires grad
    raises ValueError.
    """
    if x.device.type == "cpu":
        return imcol_stage_plain(x, st, fold, tile)
    if x.device.type != "cuda":
        raise ValueError(f"imcol_stage takes cuda or cpu tensors, got {x.device}")
    _check(x, st, fold)
    c = st.channels
    ks, ds = st.kernel_sizes, st.dilations
    b, t, _ = x.shape
    halo = imcol_halo(ks, ds, fold)
    step, left = tile * fold, halo * fold
    n_s = step + 2 * left
    margin = (ks[-1] - 1) // 2 * ds[-1]
    smem = _smem_bytes(st.mode, c, n_s, margin, ks[-1])
    if smem > SMEM_LIMIT:
        raise ValueError(f"a window of {n_s} x {c} needs {smem} bytes of shared memory")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_sm = max(1, min(2048 // _NT, (SMEM_LIMIT + 1024) // (smem + 1024)))
    grid = min(b * -(-t // step), n_sm * per_sm)
    out = torch.empty_like(x)
    scratch = torch.empty((grid, 2, n_s, c), device=x.device, dtype=torch.float32)
    lib = build.load("hifigan_imcol")
    fn = lib.hifigan_imcol
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_MODE_ID[st.mode], x.data_ptr(), st.w.data_ptr(), st.scale.data_ptr(),
                 st.bias.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, t, c,
                 ks[0], ks[1], ks[2], ds[0], ds[1], ds[2], step, left, margin, grid, smem,
                 st.slope, stream)
    build.check(lib, err, "imcol_stage")
    imcol_stage.launches += 1
    return out


imcol_stage.launches = 0
