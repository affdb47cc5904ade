"""Fused HiFiGAN residual stage: the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_resstack.py``.  The kernel is
``csrc/hifigan_stage.cu``.  ``hifigan_stage`` launches it for CUDA tensors
and runs ``hifigan_stage_plain`` for CPU tensors; any other device raises.
One call computes one vocoder stage: three residual stacks of six convs
each, averaged.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import build


@dataclass(frozen=True)
class StageWeights:
    """The 18 convs of one stage, packed once per weight load.

    ``w`` is flat: for stack s (kernel size kernel_sizes[s]) and round r
    (dilation dilations[r]), the dilated conv then the dilation-1 conv, each
    laid out (k, C_in, C_out).  ``b`` is (18, C).
    """

    w: torch.Tensor
    b: torch.Tensor
    channels: int
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    slope: float = 0.1

    def conv_weights(self):
        """(weight (C_out, C_in, k), bias, dilation) per conv, in packed order."""
        c, off, i = self.channels, 0, 0
        for k in self.kernel_sizes:
            for d in self.dilations:
                for dd in (d, 1):
                    w = self.w[off:off + k * c * c].view(k, c, c).permute(2, 1, 0)
                    yield w, self.b[i], dd
                    off += k * c * c
                    i += 1


def pack_stage(convs: Sequence[Tuple[torch.Tensor, torch.Tensor]], channels: int,
               kernel_sizes, dilations, slope: float = 0.1) -> StageWeights:
    """convs: (weight (C_out, C_in, k), bias) in packed order (see StageWeights)."""
    w = torch.cat([wt.detach().permute(2, 1, 0).reshape(-1) for wt, _ in convs])
    b = torch.stack([bt.detach() for _, bt in convs])
    return StageWeights(w.float().contiguous(), b.float().contiguous(), channels,
                        tuple(kernel_sizes), tuple(dilations), slope)


def hifigan_stage_plain(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """x (B, T, C) -> mean over stacks of the residual-stack outputs."""
    convs = iter(sw.conv_weights())
    xc = x.transpose(1, 2)
    acc = 0.0
    for k in sw.kernel_sizes:
        xb = xc
        for _ in sw.dilations:
            w1, b1, d = next(convs)
            w2, b2, _ = next(convs)
            xt = F.conv1d(F.leaky_relu(xb, sw.slope), w1, b1, padding=d * (k - 1) // 2, dilation=d)
            xt = F.conv1d(F.leaky_relu(xt, sw.slope), w2, b2, padding=(k - 1) // 2)
            xb = xb + xt
        acc = acc + xb
    return (acc / len(sw.kernel_sizes)).transpose(1, 2).contiguous()


def stage_halo(kernel_sizes, dilations) -> int:
    """Rows of receptive field per side of the widest stack (60 for 3/7/11, 1/3/5)."""
    return max((k - 1) // 2 * sum(d + 1 for d in dilations) for k in kernel_sizes)


def _tile_rows(channels: int) -> int:
    return 128 if channels >= 128 else 256 if channels >= 64 else 512


def hifigan_stage(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 contiguous; returns (B, T, C) f32.
    """
    if x.device.type == "cpu":
        return hifigan_stage_plain(x, sw)
    if x.device.type != "cuda":
        raise ValueError(f"hifigan_stage takes cuda or cpu tensors, got {x.device}")
    if x.dim() != 3 or x.shape[-1] != sw.channels:
        raise ValueError(f"x must be (B, T, {sw.channels}), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if sw.w.device != x.device or sw.b.device != x.device:
        raise ValueError("stage weights must be on the input's device")
    if len(sw.kernel_sizes) != 3 or len(sw.dilations) != 3 or sw.channels % 32 != 0:
        raise ValueError("the kernel takes 3 stacks x 3 rounds and C % 32 == 0")
    if list(sw.kernel_sizes) != sorted(sw.kernel_sizes) or \
            list(sw.dilations) != sorted(sw.dilations):
        raise ValueError("kernel sizes and dilations must be ascending")
    b, t, c = x.shape
    tile = min(_tile_rows(c), t)
    halo = stage_halo(sw.kernel_sizes, sw.dilations)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(b * -(-t // tile), 2 * n_sm)
    out = torch.empty_like(x)
    scratch = torch.empty((grid, 2, tile + 2 * halo, c), device=x.device, dtype=torch.float32)
    lib = build.load("hifigan_stage")
    fn = lib.hifigan_stage_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    ks, ds = sw.kernel_sizes, sw.dilations
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), sw.w.data_ptr(), sw.b.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), b, t, c, ks[0], ks[1], ks[2], ds[0], ds[1], ds[2],
                 tile, halo, grid, sw.slope, stream)
    build.check(lib, err, "hifigan_stage")
    hifigan_stage.launches += 1
    return out


hifigan_stage.launches = 0
