"""Quantized HiFiGAN stage (K3): the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_stage.py``.  The kernel is
``csrc/hifigan_stage_q.cu``.  One call computes the stage of
``kernels/resstack.py`` (three residual stacks of six convs, averaged) in
one of two modes:

- ``int8``: int8 weights with per-output-channel scales, static per-conv
  activation scales from a calibration pass (``calibrate_stage_scales``),
  exact integer sums, one dequant+bias+lrelu+requant chain per conv, and a
  bf16 residual stream;
- ``bf16``: bf16 stream and conv operands, f32 sums.

The JAX kernel's third mode, ``f32``, is numerically the default stage; in
the port that is K2 (``kernels/resstack.py::hifigan_stage``), so K3 takes
the two modes that differ.  ``quantized_stage`` launches the kernel for
CUDA tensors and runs ``quantized_stage_plain`` for CPU tensors; any other
device raises.

The JAX kernel quantizes the time-folded weights per output column; those
column scales equal the per-output-channel scales of the unfolded weight
(a folded column holds every tap and input channel of its output channel
once, among zeros), so the port quantizes the unfolded weight and gets the
same int8 values.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.kernels.resstack import StageWeights, stage_halo

MODES = ("int8", "bf16")
_MODE_ID = {"int8": 0, "bf16": 1}
EPW = {"int8": 4, "bf16": 2}      # elements per 32-bit word of packed weights
SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)
_KW = 8                      # 32-bit words of input channels staged per step


@dataclass(frozen=True)
class QuantizedStage:
    """One stage's 18 convs prepared for a mode, in the packed conv order of
    ``StageWeights``.

    ``w`` is flat: per conv (k, C_in/e, C_out, e), e consecutive input
    channels of one output channel per 32-bit word (int8: e = 4, bf16:
    e = 2).  ``qin`` (18,) holds 127/a of each dilated conv's input (int8;
    1 for bf16), ``deq`` (18, C) the factor on each conv's sum and ``bias``
    (18, C) the bias added after it (the dilated conv's prescaled by 127/a
    of the next conv's input).
    """

    mode: str
    w: torch.Tensor
    qin: torch.Tensor
    deq: torch.Tensor
    bias: torch.Tensor
    channels: int
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    slope: float

    def conv_weights(self):
        """(weight (C_out, C_in, k) as float32 values, dilation) per conv."""
        return unpack_words(self.w, self.mode, self.channels, self.kernel_sizes, self.dilations)


def unpack_words(w: torch.Tensor, mode: str, c: int, kernel_sizes, dilations):
    """(weight (C_out, C_in, k) as float32 values, dilation) per conv of a
    stage's flat packed weights (see ``pack_words``), in packed order."""
    off = 0
    for k in kernel_sizes:
        for d in dilations:
            for dd in (d, 1):
                n, e = k * c * c, EPW[mode]
                wk = w[off:off + n].view(k, c // e, c, e).permute(0, 1, 3, 2)
                yield wk.reshape(k, c, c).permute(2, 1, 0).float(), dd
                off += n


def ieee_div(num, den) -> torch.Tensor:
    """num / den with IEEE rounding, as JAX and the kernels divide, on any
    device.  PyTorch computes ``number / tensor`` as ``reciprocal(tensor) *
    number``, and on CUDA ``tensor / number`` as a product with the number's
    reciprocal; a tensor divided by a tensor is one correctly rounded
    division."""
    like = num if torch.is_tensor(num) else den
    num, den = (torch.as_tensor(v, dtype=like.dtype, device=like.device).expand_as(like)
                for v in (num, den))
    return num / den


def quantize_weight(w: torch.Tensor):
    """(C_out, C_in, k) f32 -> int8 with per-output-channel scales (C_out,):
    scale = absmax / 127 and round(w / scale), both IEEE divisions, so the
    card quantizes as the CPU and JAX do."""
    absmax = w.abs().amax(dim=(1, 2)).clamp_min(1e-12)
    scale = ieee_div(absmax, 127.0)
    return torch.clamp(torch.round(w / scale[:, None, None]), -127, 127).to(torch.int8), scale


def pack_words(w: torch.Tensor, e: int) -> torch.Tensor:
    """(C_out, C_in, k) -> flat (k, C_in/e, C_out, e)."""
    c_out, c_in, k = w.shape
    return w.permute(2, 1, 0).reshape(k, c_in // e, e, c_out).permute(0, 1, 3, 2).reshape(-1)


def quantize_stage(sw: StageWeights, mode: str,
                   act_scales: Optional[torch.Tensor] = None) -> QuantizedStage:
    """Quantize a stage's weights for ``mode``; int8 needs ``act_scales``
    (18,) from ``calibrate_stage_scales``.  Factors are computed in f32 in
    the JAX kernel's order, with IEEE divisions (``ieee_div``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "int8" and act_scales is None:
        raise ValueError("int8 mode requires act_scales (calibrate_stage_scales)")
    c = sw.channels
    ws, qin, deq, bias = [], [], [], []
    convs = list(sw.conv_weights())
    ones = torch.ones(c, device=sw.w.device)
    for n in range(0, len(convs), 2):
        (w1, b1, _), (w2, b2, _) = convs[n], convs[n + 1]
        if mode == "int8":
            a1, a2 = act_scales[n].float(), act_scales[n + 1].float()
            w81, cs1 = quantize_weight(w1)
            w82, cs2 = quantize_weight(w2)
            ws += [pack_words(w81, 4), pack_words(w82, 4)]
            qin += [ieee_div(127.0, a1), torch.ones((), device=a1.device)]
            deq += [ieee_div(cs1 * a1, 127.0) * ieee_div(127.0, a2), ieee_div(cs2 * a2, 127.0)]
            bias += [b1 * ieee_div(127.0, a2), b2]
        else:
            ws += [pack_words(w.to(torch.bfloat16), 2) for w in (w1, w2)]
            qin += [ones[0], ones[0]]
            deq += [ones, ones]
            bias += [b1, b2]
    return QuantizedStage(mode, torch.cat(ws).contiguous(), torch.stack(qin).float().contiguous(),
                          torch.stack(deq).float().contiguous(),
                          torch.stack(bias).float().contiguous(), c, sw.kernel_sizes,
                          sw.dilations, sw.slope)


def calibrate_stage_scales(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """Per-conv input scales a = max|lrelu(conv input)| of the exact f32
    stage on x (B, T, C), in execution order, floored at 1e-6: (18,) f32."""
    convs = iter(sw.conv_weights())
    scales = []
    for k in sw.kernel_sizes:
        xb = x.transpose(1, 2).float()
        for _ in sw.dilations:
            w1, b1, d = next(convs)
            w2, b2, _ = next(convs)
            a = F.leaky_relu(xb, sw.slope)
            scales.append(a.abs().amax())
            m = F.leaky_relu(F.conv1d(a, w1, b1, padding=d * (k - 1) // 2, dilation=d), sw.slope)
            scales.append(m.abs().amax())
            xb = xb + F.conv1d(m, w2, b2, padding=(k - 1) // 2)
    return torch.stack(scales).clamp_min(1e-6)


def _requant(v: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to the symmetric int8 range."""
    return torch.clamp(torch.round(v), -127, 127)


def quantized_stage_plain(x: torch.Tensor, qs: QuantizedStage) -> torch.Tensor:
    """x (B, T, C) f32 -> the stage in qs.mode, with the kernel's arithmetic.

    int8 sums run in float64, where integer sums up to 127^2 * 11 * C stay
    exact (they pass 2^24, which f32 does not hold), and are then rounded
    to f32 as the kernel's int32 -> f32 conversion rounds them.
    """
    int8 = qs.mode == "int8"
    slope = qs.slope
    convs = iter(qs.conv_weights())
    n = 0
    acc = 0.0
    x_bf = x.transpose(1, 2).to(torch.bfloat16)
    for k in qs.kernel_sizes:
        res = x_bf
        for _ in qs.dilations:
            w1, d = next(convs)
            w2, _ = next(convs)
            v = F.leaky_relu(res.float(), slope)
            if int8:
                q = _requant(v * qs.qin[n]).double()
                s1 = F.conv1d(q, w1.double(), padding=d * (k - 1) // 2, dilation=d).float()
                mid = F.leaky_relu(s1 * qs.deq[n][:, None] + qs.bias[n][:, None], slope)
                s2 = F.conv1d(_requant(mid).double(), w2.double(), padding=(k - 1) // 2).float()
                upd = s2 * qs.deq[n + 1][:, None] + qs.bias[n + 1][:, None]
            else:
                q = v.to(torch.bfloat16).float()
                s1 = F.conv1d(q, w1, padding=d * (k - 1) // 2, dilation=d)
                mid = F.leaky_relu(s1 + qs.bias[n][:, None], slope).to(torch.bfloat16).float()
                upd = F.conv1d(mid, w2, padding=(k - 1) // 2) + qs.bias[n + 1][:, None]
            res = (res.float() + upd).to(torch.bfloat16)
            n += 2
        acc = acc + res.float()
    return (acc / len(qs.kernel_sizes)).transpose(1, 2).contiguous()


def _smem_bytes(mode: str, c: int, tile: int, halo: int, k_max: int) -> int:
    """The kernel's dynamic shared memory: two quantized (tile + 2 halo) x C
    operand tiles (rows padded by one word) and one step of staged weights."""
    words_per_row = c // EPW[mode] + 1
    cot = 64 if c % 64 == 0 else 32
    return 4 * (2 * (tile + 2 * halo) * words_per_row + k_max * _KW * cot)


def _blocks_per_sm(smem: int) -> int:
    return max(1, min(8, (SMEM_LIMIT + 1024) // (smem + 1024)))


def stage_tile(mode: str, b: int, t: int, c: int, halo: int, k_max: int, n_sm: int) -> int:
    """Output rows per tile: among the tiles whose operands fit in shared
    memory, the one with the least (waves x rows staged per tile)."""
    best = None
    for tile in (64, 128, 256, 512, 1024, 2048):
        smem = _smem_bytes(mode, c, tile, halo, k_max)
        if smem > SMEM_LIMIT:
            break
        per_wave = n_sm * _blocks_per_sm(smem)
        jobs = b * -(-t // tile)
        cost = -(-jobs // per_wave) * _blocks_per_sm(smem) * (tile + 2 * halo)
        if best is None or cost <= best[0]:
            best = (cost, tile)
    return best[1]


def quantized_stage(x: torch.Tensor, sw, mode: Optional[str] = None,
                    act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 contiguous.  ``sw`` is a ``StageWeights`` (quantized
    here for ``mode``, with ``act_scales`` for int8) or a ``QuantizedStage``
    from ``quantize_stage``.  Returns (B, T, C) f32.
    """
    if isinstance(sw, QuantizedStage):
        if mode not in (None, sw.mode):
            raise ValueError(f"stage was quantized for {sw.mode}, not {mode}")
        qs = sw
    else:
        qs = quantize_stage(sw, mode, act_scales)
    if x.device.type == "cpu":
        return quantized_stage_plain(x, qs)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_stage takes cuda or cpu tensors, got {x.device}")
    c = qs.channels
    if x.dim() != 3 or x.shape[-1] != c:
        raise ValueError(f"x must be (B, T, {c}), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if any(t.device != x.device for t in (qs.w, qs.qin, qs.deq, qs.bias)):
        raise ValueError("quantized stage weights must be on the input's device")
    if len(qs.kernel_sizes) != 3 or len(qs.dilations) != 3 or c % 32 != 0:
        raise ValueError("the kernel takes 3 stacks x 3 rounds and C % 32 == 0")
    if list(qs.kernel_sizes) != sorted(qs.kernel_sizes) or \
            list(qs.dilations) != sorted(qs.dilations):
        raise ValueError("kernel sizes and dilations must be ascending")
    b, t, _ = x.shape
    ks, ds = qs.kernel_sizes, qs.dilations
    halo = stage_halo(ks, ds)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = stage_tile(qs.mode, b, t, c, halo, ks[-1], n_sm)
    smem = _smem_bytes(qs.mode, c, tile, halo, ks[-1])
    grid = min(b * -(-t // tile), n_sm * _blocks_per_sm(smem))
    out = torch.empty_like(x)
    scratch = torch.empty((grid, tile + 2 * halo, c), device=x.device, dtype=torch.bfloat16)
    lib = build.load("hifigan_stage_q")
    fn = lib.hifigan_stage_q
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_MODE_ID[qs.mode], x.data_ptr(), qs.w.data_ptr(), qs.qin.data_ptr(),
                 qs.deq.data_ptr(), qs.bias.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 b, t, c, ks[0], ks[1], ks[2], ds[0], ds[1], ds[2], tile, halo, grid, smem,
                 qs.slope, stream)
    build.check(lib, err, "quantized_stage")
    quantized_stage.launches += 1
    return out


quantized_stage.launches = 0
