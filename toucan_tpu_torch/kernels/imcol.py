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
``imcol_stage_plain`` for CPU tensors; any other device raises.  On the
card it takes every C <= 128 whose window fits in shared memory
(``imcol_tiling`` picks the launch: one block or a cluster of blocks per
window, and how the kernel walks the conv's taps); a C that is not a
multiple of 4 runs with zero channels added, which change neither the
integer sums nor the window's max.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.kernels.resstack import StageWeights
from toucan_tpu_torch.kernels.stage import (EPW, ONE_BLOCK_SMEM, SMEM_LIMIT, ieee_div,
                                            pack_rows, quantize_weight, unpack_rows)

MODES = ("int8", "bf16")
_MODE_ID = {"int8": 0, "bf16": 1}
LANES = 128        # the JAX generator's min_lanes: narrower stages are time-folded to it
TILE = 512         # folded output rows per window, the JAX kernel's default
MAX_CHANNELS = 128  # the widest stage the JAX generator gives the im2col kernel
MAX_CLUSTER = 4    # blocks per window at most
TWO_BLOCK_SMEM = 115712  # two blocks of at most this share an SM (228 KB, 1 KB reserved a block)
# the kernel's geometry (csrc/hifigan_imcol.cu)
_RT = 256          # output rows per pass: 8 warps x 32 rows
_COT = 32          # output channels per pass
_KW = 8            # 32-bit words of K per step
_ROW_PAD = 4       # words of padding per operand row read by ldmatrix
_WROW = 12         # words per staged weight row (8, padded)
_N_WARPS = 8


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

    ``w`` is flat: per conv (k, C_out, C_in/e, e), e consecutive input
    channels of one output channel per 32-bit word (int8: e = 4, bf16:
    e = 2; ``kernels/stage.py::pack_rows``).  ``scale`` (18, C) holds the int8 weights' per-output-channel
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
        return unpack_rows(self.w, self.channels, self.kernel_sizes, self.dilations)


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
            ws.append(pack_rows(w8))
            scales.append(cs)
        else:
            ws.append(pack_rows(w.to(torch.bfloat16)))
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


def _dequant(s: torch.Tensor, f: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """s * f + b in f32, rounded after the product and after the sum, as the
    kernel's __fmul_rn / __fadd_rn (no FMA)."""
    return s * f + bias


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
                    y = _dequant(s, st.scale[n][None, :, None] * ieee_div(a, 127.0), bias)
                else:
                    q = v.to(torch.bfloat16).float()
                    y = F.conv1d(F.pad(q, (pad, pad), mode="circular"), w, dilation=d) + bias
                xt = torch.where(mask, y, torch.zeros((), device=y.device))
                n += 1
            xb = xb + xt
        acc = acc + xb[:, :, left:left + step]
    out = ieee_div(acc, float(len(st.kernel_sizes))).reshape(b, n_win, c, step)
    return out.permute(0, 1, 3, 2).reshape(b, n_win * step, c)[:, :t].contiguous()


def _smem_bytes(n_s: int, cluster: int, margin: int, wpr: int, k_max: int,
                wslots: int) -> int:
    """The kernel's dynamic shared memory: a block's rows of the quantized
    window with ``margin`` rows more on each side (``wpr`` 32-bit words a
    row, rounded up to 16 bytes), ``wslots`` steps of staged weights (k_max
    x 32 output channels x 12 words), the warp maxima and the cluster's
    slots."""
    rows = -(-n_s // cluster) + 2 * margin
    return 4 * (-(-rows * wpr // 4) * 4 + wslots * k_max * _COT * _WROW + _N_WARPS + cluster)


def _weight_steps(mode: str, c: int, flat: bool, kernel_sizes) -> int:
    """The most distinct weight steps (32 output channels x one chunk of K)
    a conv of the stage has: the buffers that hold a conv's weights whole."""
    cw = c // EPW[mode]
    n_c = -(-c // _COT)
    if not flat:
        return n_c * (cw // _KW)
    return n_c * max(-(-(-(-k * cw // _KW)) // k) for k in kernel_sizes)


def _layouts(mode: str, c: int, kernel_sizes):
    """(flat, words per operand row, weight buffers) the kernel can take at
    C, in order of preference: taps of 8 words read by ldmatrix from rows
    padded by 16 bytes where C / e is a multiple of 8, else (or where those
    rows do not fit) K flattened over (tap, word) from dense rows; each
    conv's weights staged whole, else one step ahead in two buffers."""
    cw = c // EPW[mode]
    rows = ([(False, cw + _ROW_PAD)] if cw % _KW == 0 else []) + [(True, cw)]
    return [(flat, wpr, wslots) for flat, wpr in rows
            for wslots in sorted({max(_weight_steps(mode, c, flat, kernel_sizes), 2), 2},
                                 reverse=True)]


@dataclass(frozen=True)
class ImcolTiling:
    """How one K4 launch cuts its work (see ``imcol_tiling``)."""

    cluster: int     # blocks per window; block r takes rows [r n_s / cluster, (r+1) n_s / cluster)
    clusters: int    # clusters launched (persistent: each walks windows in turn)
    flat: bool       # K walked over flattened (tap, word) steps from dense operand rows
    wpr: int         # 32-bit words per operand row in shared memory
    wslots: int      # weight buffers: all of a conv's steps, or two staged a step ahead
    per_sm: int      # blocks an SM runs at once (1, or 2 at 128 registers a thread)
    windows: int     # B x windows per sample
    window: int      # rows of a window, n_s = step + 2 left
    step: int        # output rows per window (tile x fold)
    left: int        # halo rows on each side (halo x fold)
    margin: int      # operand rows beyond a block's own on each side
    smem: int        # dynamic shared memory of a block, bytes
    channels: int

    @property
    def grid(self) -> int:
        return self.clusters * self.cluster

    @property
    def scratch_bytes(self) -> int:
        """The f32 streams xb and xt of the windows in flight."""
        return self.clusters * 2 * self.window * self.channels * 4


# estimated cost of a window split over a cluster, against its share of one
# block's work: the operand's edge rows cross to the peers, and each conv
# waits at two cluster barriers
CLUSTER_COST = 1.15


@functools.lru_cache(maxsize=512)
def imcol_tiling(mode: str, b: int, t: int, c: int, fold: int, n_sm: int,
                 kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), clusters_in_flight=None,
                 clusters=(1, 2, MAX_CLUSTER), tile: int = TILE) -> ImcolTiling:
    """Pick K4's launch for a stage (B, T, C) at time fold ``fold``.

    The windows are JAX's (``tile`` x fold output rows, ``imcol_halo`` x
    fold rows of halo on each side), B x ceil(T / (tile x fold)) of them.
    A cluster splits a window's rows over its blocks (sizes from
    ``clusters``), and for each size the first of ``_layouts`` that fits
    in shared memory is taken.  ``clusters_in_flight``: ((cluster, clusters
    the card runs at once at one block per SM), ...) as the device reports
    it, default n_sm // cluster.

    - Where the windows are at most half the SMs (48 at stage 1 of 512
      frames), one block per window would leave most of the card idle: the
      smallest cluster that gives every SM a block (else the largest) is
      taken with blocks small enough that two share an SM, at 128
      registers a thread (faster on the H100 than any split at one block
      per SM: ``scripts/k4_variants.py``).
    - Otherwise one block per SM: the estimate is waves x (the block's rows
      rounded up to 256-row passes, for the products, plus its rows, for
      the elementwise passes), times ``CLUSTER_COST`` for a split window;
      the cheapest wins, ties to the smaller cluster.  So 96 windows (stages
      2 and 3 of 512 frames) take one block each: splitting them over 132
      SMs still takes two waves, and measured slower in int8 (in bf16 2-5 %
      faster, where the split leaves room to keep a conv's weights in
      shared memory, which the estimate does not model).

    Raises ValueError for C > 128, C not a multiple of 4 (the wrapper adds
    zero channels first) or a window that fits in no layout."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not 0 < c <= MAX_CHANNELS or c % 4:
        raise ValueError(f"K4 takes C % 4 == 0 up to {MAX_CHANNELS}, got {c}")
    halo = imcol_halo(kernel_sizes, dilations, fold)
    step, left = tile * fold, halo * fold
    n_s = step + 2 * left
    margin = (kernel_sizes[-1] - 1) // 2 * dilations[-1]
    jobs = b * -(-(t // fold) // tile)
    in_flight = dict(clusters_in_flight or ())
    k_max = kernel_sizes[-1]

    def layout(cl, limit):
        fits = [lay for lay in _layouts(mode, c, kernel_sizes)
                if _smem_bytes(n_s, cl, margin, lay[1], k_max, lay[2]) <= limit]
        return fits[0] if fits and n_s // cl >= margin else None

    def tiling(cl, lay, per_sm, slots):
        flat, wpr, wslots = lay
        smem = _smem_bytes(n_s, cl, margin, wpr, k_max, wslots)
        return ImcolTiling(cl, min(jobs, slots), flat, wpr, wslots, per_sm, jobs, n_s, step,
                           left, margin, smem if per_sm == 2 else max(smem, ONE_BLOCK_SMEM), c)

    if 2 * jobs <= n_sm:
        split = [cl for cl in sorted(clusters) if cl > 1 and layout(cl, TWO_BLOCK_SMEM)]
        fill = [cl for cl in split if jobs * cl >= n_sm] or split[-1:]
        if fill:
            cl = fill[0]
            return tiling(cl, layout(cl, TWO_BLOCK_SMEM), 2,
                          2 * max(1, in_flight.get(cl, n_sm // cl)))
    best = None
    for cl in sorted(clusters):
        lay = layout(cl, SMEM_LIMIT)
        if lay is None:
            continue
        slots = max(1, in_flight.get(cl, n_sm // cl))
        rows = -(-n_s // cl)
        cost = -(-jobs // slots) * (-(-rows // _RT) * _RT + rows) * (CLUSTER_COST if cl > 1 else 1)
        if best is None or cost < best[0]:
            best = (cost, tiling(cl, lay, 1, slots))
    if best is None:
        raise ValueError(f"K4 {mode}: a window of {n_s} rows x {c} channels does not fit in "
                         "shared memory")
    return best[1]


_max_clusters_cache: dict = {}


def _clusters_in_flight(device, mode):
    """((cluster, clusters the device runs at once), ...) for K4's cluster
    sizes, at one block per SM."""
    key = (device.index, mode)
    if key not in _max_clusters_cache:
        lib = build.load("hifigan_imcol")
        fn = lib.hifigan_imcol_max_clusters
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        pairs = []
        for cl in (1, 2, MAX_CLUSTER):
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = fn(_MODE_ID[mode], 0, cl, 1, ONE_BLOCK_SMEM, ctypes.addressof(n))
            build.check(lib, err, "hifigan_imcol_max_clusters")
            pairs.append((cl, n.value))
        _max_clusters_cache[key] = tuple(pairs)
    return _max_clusters_cache[key]


def tiling_for(x: torch.Tensor, st: ImcolStage, fold: int, tile: int = TILE,
               clusters=(1, 2, MAX_CLUSTER)) -> ImcolTiling:
    """The tiling ``imcol_stage`` launches x with on its card."""
    b, t, c = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    return imcol_tiling(st.mode, b, t, c, fold, n_sm, st.kernel_sizes, st.dilations,
                        _clusters_in_flight(x.device, st.mode), tuple(clusters), tile)


def widened(st: ImcolStage, c: int) -> ImcolStage:
    """``st`` with zero channels added up to ``c``: zero weights into and out
    of them, zero bias and unit scale, so their stream stays zero and the
    other channels' sums and the window's max are unchanged."""
    pad = c - st.channels
    ws = [pack_rows(F.pad(w, (0, 0, 0, pad, 0, pad)).to(st.w.dtype))
          for w, _ in st.conv_weights()]
    return dataclasses.replace(st, w=torch.cat(ws).contiguous(), channels=c,
                               scale=F.pad(st.scale, (0, pad), value=1.0).contiguous(),
                               bias=F.pad(st.bias, (0, pad)).contiguous())


def _widened(st: ImcolStage) -> ImcolStage:
    """``widened(st, C rounded up to 4)``, made once per ImcolStage and kept
    on it: a captured graph reads the widened weights by address for as
    long as it reads ``st``'s own."""
    cached = st.__dict__.get("_widened")
    if cached is None or cached.w.device != st.w.device:
        cached = widened(st, st.channels + (-st.channels) % 4)
        object.__setattr__(st, "_widened", cached)
    return cached


def _check(x: torch.Tensor, st: ImcolStage, fold: int):
    """What the kernel needs of x and st; raises ValueError before a launch."""
    c = st.channels
    if x.dim() != 3 or x.shape[-1] != c:
        raise ValueError(f"x must be (B, T, {c}), got {tuple(x.shape)}")
    if c > MAX_CHANNELS:
        raise ValueError(f"the kernel takes C up to {MAX_CHANNELS}, got {c}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if any(t.device != x.device for t in (st.w, st.scale, st.bias)):
        raise ValueError("imcol stage weights must be on the input's device")
    ks, ds = st.kernel_sizes, st.dilations
    if len(ks) != 3 or len(ds) != 3 or list(ks) != sorted(ks) or list(ds) != sorted(ds):
        raise ValueError("the kernel takes 3 stacks x 3 rounds, ascending")
    if x.shape[1] % fold:
        raise ValueError(f"T = {x.shape[1]} is not a multiple of the fold {fold}")
    build.check_aligned("imcol_stage", x=x, w=st.w, scale=st.scale, bias=st.bias)
    build.check_no_grad("imcol_stage", x=x, scale=st.scale, bias=st.bias)


def imcol_stage(x: torch.Tensor, st: ImcolStage, fold: int, tile: int = TILE) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 contiguous, C <= 128 on the card; ``st`` from
    ``prepare_imcol_stage``; ``fold`` the stage's time fold
    (``imcol_fold``).  Returns (B, T, C) f32.  A window that does not fit
    in shared memory raises ValueError before a launch (``imcol_tiling``).
    The kernel has no backward: on the card a call with grad enabled on an
    input that requires grad raises ValueError.
    """
    if x.device.type == "cpu":
        return imcol_stage_plain(x, st, fold, tile)
    if x.device.type != "cuda":
        raise ValueError(f"imcol_stage takes cuda or cpu tensors, got {x.device}")
    _check(x, st, fold)
    c = st.channels
    if c % 4:
        wide = _widened(st)
        return imcol_stage(F.pad(x, (0, wide.channels - c)), wide, fold,
                           tile)[..., :c].contiguous()
    ks, ds = st.kernel_sizes, st.dilations
    b, t, _ = x.shape
    tl = tiling_for(x, st, fold, tile)
    out = torch.empty_like(x)
    scratch = torch.empty(tl.scratch_bytes // 4, device=x.device, dtype=torch.float32)
    lib = build.load("hifigan_imcol")
    fn = lib.hifigan_imcol
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_MODE_ID[st.mode], x.data_ptr(), st.w.data_ptr(), st.scale.data_ptr(),
                 st.bias.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, t, c,
                 ks[0], ks[1], ks[2], ds[0], ds[1], ds[2], tl.step, tl.left, tl.margin,
                 int(tl.flat), tl.wpr, tl.wslots, tl.cluster, tl.per_sm, tl.grid, tl.smem,
                 st.slope, stream)
    build.check(lib, err, "imcol_stage")
    build.count_launch(imcol_stage)
    return out


imcol_stage.launches = 0
