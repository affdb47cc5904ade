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
same int8 values.  ``stage_tiling`` picks each launch's cluster and time
tiles.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.kernels.resstack import StageWeights, _tile_cost, stage_halo

MODES = ("int8", "bf16")
_MODE_ID = {"int8": 0, "bf16": 1}
EPW = {"int8": 4, "bf16": 2}      # elements per 32-bit word of packed weights
SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)
ONE_BLOCK_SMEM = 118784      # launched with at least this, a block has its SM to itself
MIN_TILE = 8
MAX_CLUSTER = 4              # blocks per tile at most
# the kernel's geometry (csrc/hifigan_stage_q.cu)
_RT = 256                    # output rows per pass: 8 warps x 32 rows
_COT = 32                    # output channels per pass
_ROW_PAD = 4                 # words of padding per operand row
_WROW = 12                   # words per staged weight row (8, padded)
_NSTAGE = 2                  # weight staging buffers


@dataclass(frozen=True)
class QuantizedStage:
    """One stage's 18 convs prepared for a mode, in the packed conv order of
    ``StageWeights``.

    ``w`` is flat: per conv (k, C_out, C_in/e, e), e consecutive input
    channels of one output channel per 32-bit word (int8: e = 4, bf16:
    e = 2; see ``pack_rows``).  ``qin`` (18,) holds 127/a of each dilated
    conv's input (int8; 1 for bf16), ``deq`` (18, C) the factor on each
    conv's sum and ``bias`` (18, C) the bias added after it (the dilated
    conv's prescaled by 127/a of the next conv's input).
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
        return unpack_rows(self.w, self.channels, self.kernel_sizes, self.dilations)


def unpack_rows(w: torch.Tensor, c: int, kernel_sizes, dilations):
    """(weight (C_out, C_in, k) as float32 values, dilation) per conv of a
    stage's flat packed weights in ``pack_rows``'s layout, in packed order."""
    off = 0
    for k in kernel_sizes:
        for d in dilations:
            for dd in (d, 1):
                yield w[off:off + k * c * c].view(k, c, c).permute(1, 2, 0).float(), dd
                off += k * c * c


def unpack_words(w: torch.Tensor, mode: str, c: int, kernel_sizes, dilations):
    """(weight (C_out, C_in, k) as float32 values, dilation) per conv of a
    stage's flat packed weights in ``pack_words``'s layout, in packed
    order."""
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
    """(C_out, C_in, k) -> flat (k, C_in/e, C_out, e): the layout K3 and K4
    took before their tensor-core kernels, kept to check that ``pack_rows``
    holds the same values."""
    c_out, c_in, k = w.shape
    return w.permute(2, 1, 0).reshape(k, c_in // e, e, c_out).permute(0, 1, 3, 2).reshape(-1)


def pack_rows(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, k) -> flat (k, C_out, C_in): K3's and K4's layout.
    Viewed as 32-bit words, (k, C_out, C_in/e) with e consecutive input
    channels per word, one output channel's words contiguous: the rows of
    the kernels' B tiles."""
    return w.permute(2, 0, 1).reshape(-1)


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
            ws += [pack_rows(w81), pack_rows(w82)]
            qin += [ieee_div(127.0, a1), torch.ones((), device=a1.device)]
            deq += [ieee_div(cs1 * a1, 127.0) * ieee_div(127.0, a2), ieee_div(cs2 * a2, 127.0)]
            bias += [b1 * ieee_div(127.0, a2), b2]
        else:
            ws += [pack_rows(w.to(torch.bfloat16)) for w in (w1, w2)]
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
    operand tiles (rows padded by 16 bytes) and two steps of staged weights
    (k_max taps x 32 output channels x 8 words, rows padded by 16 bytes)."""
    words_per_row = c // EPW[mode] + _ROW_PAD
    return 4 * (2 * (tile + 2 * halo) * words_per_row + _NSTAGE * k_max * _COT * _WROW)


def max_tile(mode: str, c: int, halo: int, k_max: int) -> int:
    """The longest tile whose operands fit in shared memory."""
    words_per_row = c // EPW[mode] + _ROW_PAD
    weights = _NSTAGE * k_max * _COT * _WROW
    return (SMEM_LIMIT // 4 - weights) // (2 * words_per_row) - 2 * halo


@dataclass(frozen=True)
class QuantizedTiling:
    """How one K3 launch cuts its work (see ``stage_tiling``)."""

    tile: int        # the longest tile's output rows (tiles differ by at most 1 row)
    n_tiles: int     # tiles per sample
    cluster: int     # blocks per tile; block r takes channels [r C/cluster, (r+1) C/cluster)
    clusters: int    # clusters launched (persistent: each walks tiles in turn)
    halo: int        # recomputed rows per side
    jobs: int        # B x n_tiles
    smem: int        # dynamic shared memory of a block, bytes

    @property
    def grid(self) -> int:
        return self.clusters * self.cluster


def _cheapest(mode, b, t, c, n_sm, kernel_sizes, dilations, in_flight, clusters):
    """The cheapest tiling over the given cluster sizes (see ``stage_tiling``)."""
    halo = stage_halo(kernel_sizes, dilations)
    top = max_tile(mode, c, halo, kernel_sizes[-1])
    floor = 2 * len(dilations) * sum(kernel_sizes)   # one pass per conv
    most = max(1, t // MIN_TILE)                     # tiles per sample
    best = None
    for cl in clusters:
        slots = max(1, in_flight.get(cl, n_sm // cl))
        waves = 0
        while best is None or waves * floor < best[0][0] * cl:
            waves += 1
            n_tiles = min(-(-waves * slots // b), most)
            tile = -(-t // n_tiles)
            if tile <= top:
                jobs = b * n_tiles
                n_waves = -(-jobs // slots)
                cost = n_waves * _tile_cost(tile, _RT, kernel_sizes, dilations)
                est = (cost / cl, n_waves, cl)
                if best is None or est < best[0]:
                    smem = max(_smem_bytes(mode, c, tile, halo, kernel_sizes[-1]), ONE_BLOCK_SMEM)
                    best = (est, QuantizedTiling(tile, n_tiles, cl, min(jobs, slots), halo, jobs,
                                                 smem))
            if n_tiles == most:
                break
    return best[1]


@functools.lru_cache(maxsize=512)
def stage_tiling(mode: str, b: int, t: int, c: int, n_sm: int, kernel_sizes, dilations,
                 clusters_in_flight=None, max_cluster: int = MAX_CLUSTER) -> QuantizedTiling:
    """Pick K3's cluster and time tiles for one call, one block per SM.

    For a cluster size (1, 2 or 4 blocks, C / cluster a multiple of 32) and
    each number of waves w, each sample is cut into ceil(w x slots / B)
    tiles of equal length (to 1 row), so a wave gives every cluster slot a
    tile; ``clusters_in_flight``: ((cluster, clusters the card runs at
    once), ...) as the device reports it, default n_sm // cluster.  The tile
    must fit in shared memory (``max_tile``).  The estimate is waves x
    ``_tile_cost`` (passes of 256 rows over each conv's valid rows, which
    count the recomputed halo) / cluster, and the cheapest wins (ties:
    fewer waves, then smaller clusters).

    One block per tile comes first.  A tile is split over a cluster (at
    most ``max_cluster`` blocks) only where one block per tile leaves tiles
    shorter than the halo, so that each would recompute over 3x its own
    rows: on the H100 the split halved stage 0 at 512 frames (32-row tiles)
    and gained nothing at stage 1 (187-row tiles), where the operand each
    block builds for all C and the cluster barriers cost what the split
    saves.  Raises ValueError for a width whose operands do not fit: int8
    takes every C % 32 == 0 up to 512, bf16 up to 352."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    halo = stage_halo(kernel_sizes, dilations)
    if c % _COT or max_tile(mode, c, halo, kernel_sizes[-1]) < MIN_TILE:
        raise ValueError(f"K3 {mode} takes C % 32 == 0 whose operands fit in shared memory, "
                         f"got {c}")
    in_flight = dict(clusters_in_flight or ())
    args = (mode, b, t, c, n_sm, kernel_sizes, dilations, in_flight)
    single = _cheapest(*args, (1,))
    clusters = [cl for cl in (1, 2, 4) if cl <= max_cluster and c % (cl * _COT) == 0]
    if single.tile >= halo or len(clusters) == 1:
        return single
    return _cheapest(*args, clusters)


_max_clusters_cache: dict = {}


def _clusters_in_flight(device, mode):
    """((cluster, clusters the device runs at once), ...) for K3's options,
    at one block per SM."""
    key = (device.index, mode)
    if key not in _max_clusters_cache:
        lib = build.load("hifigan_stage_q")
        fn = lib.hifigan_stage_q_max_clusters
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        pairs = []
        for cl in (1, 2, 4):
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = fn(_MODE_ID[mode], cl, ONE_BLOCK_SMEM, ctypes.addressof(n))
            build.check(lib, err, "hifigan_stage_q_max_clusters")
            pairs.append((cl, n.value))
        _max_clusters_cache[key] = tuple(pairs)
    return _max_clusters_cache[key]


def tiling_for(x: torch.Tensor, qs: QuantizedStage,
               max_cluster: int = MAX_CLUSTER) -> QuantizedTiling:
    """The tiling ``quantized_stage`` launches x with on its card."""
    b, t, c = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    return stage_tiling(qs.mode, b, t, c, n_sm, qs.kernel_sizes, qs.dilations,
                        _clusters_in_flight(x.device, qs.mode), max_cluster)


def _check(x: torch.Tensor, qs: QuantizedStage):
    """What the kernel needs of x and qs; raises ValueError before a launch."""
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
    build.check_aligned("quantized_stage", x=x, w=qs.w, deq=qs.deq, bias=qs.bias)
    build.check_no_grad("quantized_stage", x=x, qin=qs.qin, deq=qs.deq, bias=qs.bias)


def quantized_stage(x: torch.Tensor, sw, mode: Optional[str] = None,
                    act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 contiguous.  ``sw`` is a ``StageWeights`` (quantized
    here for ``mode``, with ``act_scales`` for int8) or a ``QuantizedStage``
    from ``quantize_stage``.  Returns (B, T, C) f32.  The kernel has no
    backward: on the card a call with grad enabled on an input that
    requires grad raises ValueError.
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
    _check(x, qs)
    b, t, c = x.shape
    ks, ds = qs.kernel_sizes, qs.dilations
    tl = tiling_for(x, qs)
    out = torch.empty_like(x)
    scratch = torch.empty((tl.clusters, tl.tile + 2 * tl.halo, c), device=x.device,
                          dtype=torch.bfloat16)
    lib = build.load("hifigan_stage_q")
    fn = lib.hifigan_stage_q
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_MODE_ID[qs.mode], x.data_ptr(), qs.w.data_ptr(), qs.qin.data_ptr(),
                 qs.deq.data_ptr(), qs.bias.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 b, t, c, ks[0], ks[1], ks[2], ds[0], ds[1], ds[2], tl.tile, tl.halo,
                 tl.n_tiles, tl.cluster, tl.grid, tl.smem, qs.slope, stream)
    build.check(lib, err, "quantized_stage")
    build.count_launch(quantized_stage)
    return out


quantized_stage.launches = 0
