"""HiFiGAN generator (Avocodo variant), inference.

Counterpart of ``toucan_tpu/models/vocoders/hifigan.py``; reference
``TrainingInterfaces/Spectrogram_to_Wave/HiFiGAN/HiFiGAN.py:13-179``.
80-band mel frames -> 24 kHz wave through 8*6*4*2 = 384x upsampling.  Each
stage is a transposed conv and then three residual stacks averaged: that
stage is ``kernels/resstack.py::hifigan_stage`` (K2), the CUDA kernel on
CUDA tensors and its plain version on CPU tensors.  That is
``stage_mode="f32"``, the default: the JAX package's "" and "f32" modes
are one function.  With ``stage_mode="int8"`` or ``"bf16"`` the stages
the JAX generator gives its stage kernel run
``kernels/stage.py::quantized_stage`` (K3) instead: those whose folded
width, ``imcol_fold(C) * C``, is 128 or 256 (every stage of the released
512-channel geometry; none of a 192-channel one, whose folded widths are 96
and 120); int8 takes per-stage activation scales from
``calibrate_act_scales``.  The JAX ``stage_indices`` default to all four
stages and the port has no such option.  A stage K3 does not take falls
through to the im2col rule: with ``imcol_mode="int8"`` or ``"bf16"`` the
stages in ``imcol_stages`` with at most 128 channels run
``kernels/imcol.py::imcol_stage`` (K4), whose int8 scales are dynamic per
window; ``imcol_mode="f32"`` is the exact stage, K2, as is every other
stage.  ``imcol_dense`` is
taken for parity with the JAX generator and changes nothing in the port: it
selects the JAX kernel's dense folded weights, which give the same int8
values and exact integer sums, so both compute the port's one stage.
Parameter names are the reference's state-dict keys with weight norm folded.  The Avocodo taps
``out_proj_x1``/``out_proj_x2`` run only with ``return_intermediates=True``
(their only reader is the CoMBD critic of training).

``forward(c, differentiable=True)`` is the training path: every stage runs
``ResidualStack.forward`` on cuDNN convs, with autograd, and no kernel is
launched (the kernels have no backward and their wrappers refuse grad).
The path is chosen by that argument alone, never by the grad mode.  The
default path runs under ``torch.no_grad()`` through the kernels as above.

``dtype=torch.bfloat16`` is the JAX generator's ``dtype=bfloat16``: the
parameters are held in bf16, the input conv, the upsamplers and the output
conv run as bf16 cuDNN convs, and every stage that K3 and K4 do not take
by the rules above runs K3 in its bf16 mode (bf16 stream and conv
operands, f32 sums), where the JAX package runs it in XLA's bf16 convs.
K3 takes bf16 stages of C % 32 == 0 up to 352 channels (a wider stage
raises ValueError on the card); every stage of the released 512-channel
geometry is in range.  The kernels take the stage's input as f32, which
holds every bf16 value exactly, and the stage's output is rounded to bf16
for the next upsampler.  The wave comes back f32.
"""

import copy
from typing import Optional, Tuple

import torch
from torch import nn

from toucan_tpu_torch.kernels.imcol import (ImcolStage, imcol_fold, imcol_stage,
                                            prepare_imcol_stage)
from toucan_tpu_torch.kernels.resstack import StageWeights, hifigan_stage, pack_stage
from toucan_tpu_torch.kernels.stage import (MODES, QuantizedStage, calibrate_stage_scales,
                                            quantize_stage, quantized_stage)
from toucan_tpu_torch.nn.convolution import conv_reach, same_conv


def _at_least_f32(x):
    """f32 from bf16 (the wave comes back f32), float64 kept (a float64 check)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class ResidualStack(nn.Module):
    """LReLU -> dilated conv -> LReLU -> conv, 3 rounds, residual."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope: float):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(slope), same_conv(channels, channels, kernel_size, d))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(slope), same_conv(channels, channels, kernel_size))
            for _ in dilations)

    def forward(self, x):
        """(B, C, T) -> (B, C, T), differentiable (the training path)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(c1(x))
        return x

    def reach(self, q: int) -> int:
        """The last input index that output index ``q`` reads
        (``nn/convolution.py::conv_reach``)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            q = conv_reach(c1[1], conv_reach(c2[1], q))
        return q


class HiFiGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 80, channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Tuple[int, ...] = (8, 6, 4, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 12, 8, 4),
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilations: Tuple[int, ...] = (1, 3, 5), slope: float = 0.1,
                 stage_mode: str = "f32", imcol_mode: Optional[str] = None,
                 imcol_stages: Tuple[int, ...] = (1, 2, 3), imcol_dense: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if stage_mode not in ("f32",) + MODES:
            raise ValueError(f"stage_mode must be 'f32', 'int8' or 'bf16', got {stage_mode!r}")
        if imcol_mode not in (None, "f32") + MODES:
            raise ValueError(f"imcol_mode must be None, 'f32', 'int8' or 'bf16', "
                             f"got {imcol_mode!r}")
        self.stage_mode = stage_mode
        self.imcol_mode = imcol_mode
        self.imcol_stages = tuple(imcol_stages)
        self.slope = slope
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(resblock_dilations)
        self.input_conv = same_conv(in_channels, channels, kernel_size)
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (scale, up_k) in enumerate(zip(upsample_scales, upsample_kernel_sizes)):
            ch = channels // 2 ** (i + 1)
            self.upsamples.append(nn.Sequential(
                nn.LeakyReLU(slope),
                nn.ConvTranspose1d(channels // 2 ** i, ch, up_k, scale,
                                   padding=(up_k - scale) // 2)))
            for k in resblock_kernel_sizes:
                self.blocks.append(ResidualStack(ch, k, resblock_dilations, slope))
        self.out_proj_x1 = same_conv(channels // 4, 1, 7)
        self.out_proj_x2 = same_conv(channels // 8, 1, 7)
        self.output_conv = nn.Sequential(nn.LeakyReLU(0.01), same_conv(ch, 1, kernel_size),
                                         nn.Tanh())
        # the reference's init_weights: conv weights ~ N(0, 0.01)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                nn.init.normal_(m.weight, 0.0, 0.01)
        self._packed = {}
        self._quantized = {}
        self._imcol = {}
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the parameters."""
        return self.input_conv.weight.dtype

    def stage_weights(self, i: int) -> StageWeights:
        """Stage i's 18 convs packed for the kernel, rebuilt only when the
        parameters change (load, device move or in-place update)."""
        n = len(self.resblock_kernel_sizes)
        stacks = self.blocks[i * n:(i + 1) * n]
        convs = [(seq[1].weight, seq[1].bias)
                 for stack in stacks
                 for c1, c2 in zip(stack.convs1, stack.convs2) for seq in (c1, c2)]
        key = tuple((w.data_ptr(), w._version, b.data_ptr(), b._version) for w, b in convs)
        if self._packed.get(i, (None,))[0] != key:
            ch = convs[0][0].shape[0]
            self._packed[i] = (key, pack_stage(convs, ch, self.resblock_kernel_sizes,
                                               self.resblock_dilations, self.slope))
        return self._packed[i][1]

    def quantized_stage_weights(self, i: int, scales=None, mode=None) -> QuantizedStage:
        """Stage i quantized for ``mode`` (default ``stage_mode``) with its
        (18,) activation scales, rebuilt only when the packed weights, the
        mode or the scales tensor change."""
        sw = self.stage_weights(i)
        mode = mode or self.stage_mode
        version = None if scales is None else scales._version
        hit = self._quantized.get(i)
        if hit is None or hit[0] is not sw or hit[1] != mode \
                or hit[2] is not scales or hit[3] != version:
            hit = (sw, mode, scales, version, quantize_stage(sw, mode, scales))
            self._quantized[i] = hit
        return hit[4]

    def imcol_stage_weights(self, i: int) -> ImcolStage:
        """Stage i prepared for ``imcol_mode``, rebuilt only when the packed
        weights or the mode change."""
        sw = self.stage_weights(i)
        hit = self._imcol.get(i)
        if hit is None or hit[0] is not sw or hit[1] != self.imcol_mode:
            hit = (sw, self.imcol_mode, prepare_imcol_stage(sw, self.imcol_mode))
            self._imcol[i] = hit
        return hit[2]

    def runs_stage_kernel(self, i: int) -> bool:
        """Whether stage i runs K3: the JAX generator's rule
        (``toucan_tpu/models/vocoders/hifigan.py::HiFiGANGenerator.__call__``),
        ``stage_mode`` int8 or bf16 and a folded width of 128 or 256."""
        c = self.upsamples[i][1].out_channels
        return self.stage_mode in MODES and imcol_fold(c) * c in (128, 256)

    def runs_imcol(self, i: int) -> bool:
        """Whether stage i runs K4 when K3 does not take it: the JAX
        generator's rule, ``imcol_mode`` set, at most 128 channels and i in
        ``imcol_stages`` (the f32 mode is the exact stage, K2)."""
        return (self.imcol_mode in MODES and i in self.imcol_stages
                and self.upsamples[i][1].out_channels <= 128)

    @property
    def receptive_frames(self) -> Optional[int]:
        """R: the mel frames past a length L that the wave's first 384 L
        samples read, L .. L + R - 1, from the convs' own geometry (13 for
        the released one), so a mel cut at L + R frames or more gives those
        samples unchanged.  None where K4 runs a stage in int8: its scales
        are the max over every row of a window, the rows past L too."""
        if self.imcol_mode == "int8" and any(map(self.runs_imcol, range(len(self.upsamples)))):
            return None
        q = conv_reach(self.output_conv[1], -1)   # the last sample before a frame boundary
        n = len(self.resblock_kernel_sizes)
        for i in reversed(range(len(self.upsamples))):
            q = max(block.reach(q) for block in self.blocks[i * n:(i + 1) * n])
            q = conv_reach(self.upsamples[i][1], q)
        return conv_reach(self.input_conv, q) + 1

    def forward(self, c, act_scales=None, return_intermediates: bool = False,
                differentiable: bool = False):
        """c (B, T, 80) -> wave (B, 384*T, 1); with ``return_intermediates``
        (wave, x2, x1), the Avocodo taps after stages 2 and 1, (B, 192*T, 1)
        and (B, 48*T, 1), in the JAX generator's order.  ``act_scales``:
        {stage: (18,)} from ``calibrate_act_scales``, needed by
        stage_mode="int8".  ``differentiable=True`` runs the training path
        (see the module's docstring)."""
        if differentiable:
            return self._train_forward(c, return_intermediates)
        with torch.no_grad():
            return self._run(c, act_scales, return_intermediates=return_intermediates)

    def _train_forward(self, c, return_intermediates: bool):
        x = self.input_conv(c.to(self.dtype).transpose(1, 2))
        n = len(self.resblock_kernel_sizes)
        taps = {}
        for i, up in enumerate(self.upsamples):
            x = up(x)
            x = sum(block(x) for block in self.blocks[i * n:(i + 1) * n]) / n
            if return_intermediates and i in (1, 2):
                taps[i] = self._tap(i, x)
        wave = _at_least_f32(self.output_conv(x).transpose(1, 2))
        return (wave, taps[2], taps[1]) if return_intermediates else wave

    def _tap(self, i: int, x):
        """The Avocodo tap after stage i (1 or 2) of (B, C, T) -> (B, T, 1)."""
        conv = self.out_proj_x1 if i == 1 else self.out_proj_x2
        return _at_least_f32(conv(x).transpose(1, 2))

    def _run(self, c, act_scales=None, stage_inputs=None, return_intermediates=False):
        """The generator; with a list ``stage_inputs`` it records each
        stage's (B, T, C) input and runs the stages as the JAX calibration
        pass does, ``stage_mode`` aside: K4 where ``imcol_mode`` takes the
        stage, K2 elsewhere (K3 bf16 in a bf16 generator)."""
        dt = self.dtype
        x = self.input_conv(c.to(dt).transpose(1, 2))
        taps = {}
        for i, up in enumerate(self.upsamples):
            x = up(x).transpose(1, 2).contiguous()
            if stage_inputs is not None:
                stage_inputs.append(x)
            x = x.float()  # the kernels' input; exact from bf16
            if stage_inputs is None and self.runs_stage_kernel(i):
                scales = None if act_scales is None else act_scales[i]
                x = quantized_stage(x, self.quantized_stage_weights(i, scales))
            elif self.runs_imcol(i):
                x = imcol_stage(x, self.imcol_stage_weights(i), imcol_fold(x.shape[-1]))
            elif dt == torch.bfloat16:
                x = quantized_stage(x, self.quantized_stage_weights(i, mode="bf16"))
            else:
                x = hifigan_stage(x, self.stage_weights(i))
            x = x.to(dt).transpose(1, 2)
            if return_intermediates and i in (1, 2):
                taps[i] = self._tap(i, x)
        wave = self.output_conv(x).transpose(1, 2).float()
        return (wave, taps[2], taps[1]) if return_intermediates else wave


@torch.no_grad()
def calibrate_act_scales(model: HiFiGANGenerator, mel: torch.Tensor) -> dict:
    """Per-stage activation scales for ``stage_mode="int8"``.

    Runs the generator once on a representative mel (B, T, 80) as the JAX
    package's capture does (``stage_mode`` off: K2, or K4 at the stages
    ``imcol_mode`` takes), records each stage's input and
    computes its per-conv max activations
    (``kernels/stage.py::calibrate_stage_scales``).  A bf16 generator is
    calibrated in f32 on an f32 copy of its weights, as the JAX capture
    clones the model with ``dtype=float32``
    (``toucan_tpu/models/vocoders/hifigan.py:151-159``).  Returns
    ``{stage: (18,) f32}`` on the model's device, to pass as ``act_scales``.
    """
    if model.dtype != torch.float32:
        model = copy.deepcopy(model).float()
    inputs = []
    model._run(mel, stage_inputs=inputs)
    return {i: calibrate_stage_scales(x, model.stage_weights(i)) for i, x in enumerate(inputs)}
