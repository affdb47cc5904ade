"""Fused HiFiGAN residual stage: the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_resstack.py``.  The kernel is
``csrc/hifigan_stage.cu``.  ``hifigan_stage`` launches it for CUDA tensors
and runs ``hifigan_stage_plain`` for CPU tensors; any other device raises.
One call computes one vocoder stage: three residual stacks of six convs
each, averaged.  ``stage_tiling`` picks each launch's block width (64 or 32
channels), time tile and cluster size; the kernel reads a TF32-split copy
of the weights packed for that block width, which ``hifigan_stage`` makes
once per ``StageWeights`` and width.  The kernel takes C a multiple of 32
up to 128 or of 64 up to 512; any other width up to 512 runs widened with
zero channels (``widened``), which is exact.
"""

from __future__ import annotations

import ctypes
import functools
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


# the streams of all clusters in flight: past this the chooser takes smaller
# tiles.  64 MB ran HiFiGAN's stages 3-6 % faster than 40 on an H100 (the
# windows are read two steps ahead, so a stream need not stay in L2)
L2_SCRATCH_BYTES = 64 << 20
SMEM_BYTES = 232448           # shared memory a block can have on Hopper
MIN_TILE = 8
MAX_CLUSTER = 8   # Hopper's portable cluster size: C = 512 is 8 blocks of 64
MAX_CHANNELS = 512
BLOCK_CHANNELS = (128, 64, 32)


def rows_per_pass(nb: int) -> int:
    """Rows of one M tile of a block of ``nb`` channels: two warpgroups of
    one m64 tile each, or of two at nb = 32."""
    return 256 if nb == 32 else 128


def weight_slots(nb: int) -> int:
    """The kernel's ring of weight steps: 2 slots at nb = 128, else 3."""
    return 2 if nb == 128 else 3


def stage_smem_bytes(nb: int, k_max: int, d_max: int) -> int:
    """The kernel's shared memory for blocks of ``nb`` channels (the
    ``stage_smem`` of csrc/hifigan_stage.cu): ``weight_slots`` weight steps
    of k_max taps x {big, small} x 8 input channels x nb, two window slots
    per warpgroup of {big, small} x 8 channels x (its half of the M tile +
    (k_max - 1) d_max rows), and a full and an empty mbarrier a weight slot."""
    span = rows_per_pass(nb) // 2 + (k_max - 1) * d_max
    return weight_slots(nb) * (k_max * 4 * nb * 16 + 16) + 4 * 4 * span * 16


def _block_options(channels: int, k_max: int, d_max: int):
    """(NB, cluster) pairs K2 can run C channels with: blocks of 128, 64 or
    32 channels in clusters of up to 8, whose shared memory fits a block."""
    return [(nb, channels // nb) for nb in BLOCK_CHANNELS
            if channels % nb == 0 and channels // nb <= MAX_CLUSTER
            and stage_smem_bytes(nb, k_max, d_max) <= SMEM_BYTES]


def kernel_channels(c: int) -> int:
    """The width K2 runs a stage of C channels at: C rounded up to a
    multiple of 32 up to 128, else of 64 (so that blocks of 32, 64 or 128
    channels in clusters of up to 8 cover it).  Raises ValueError past
    MAX_CHANNELS."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"K2 takes 1 .. {MAX_CHANNELS} channels, got {c}")
    step = 32 if c <= 128 else 64
    return -(-c // step) * step


@dataclass(frozen=True)
class StageTiling:
    """How one K2 launch cuts its work (see ``stage_tiling``)."""

    tile: int           # output rows per work unit (time tile)
    cluster: int        # blocks per cluster; block r takes channels [r NB, (r+1) NB)
    block_channels: int  # NB: 128, 64 or 32
    clusters: int       # clusters launched (persistent: each walks tiles in turn)
    halo: int           # recomputed rows per side
    jobs: int           # B x time tiles

    @property
    def grid(self) -> int:
        return self.clusters * self.cluster

    @property
    def variant(self) -> str:
        """The kernel instance the launch takes: ``stage_kernel<NB>``."""
        return f"nb{self.block_channels}"

    def scratch_bytes(self, channels: int) -> int:
        return self.clusters * 2 * (self.tile + 2 * self.halo) * channels * 4


def _conv_rows(n_out, kernel_sizes, dilations):
    """(k, rows) of each conv of a tile that delivers ``n_out`` rows, in
    the kernel's order: each computes the rows later convs read (the tile
    plus what is left of its stack's halo)."""
    for k in kernel_sizes:
        rows = n_out + 2 * ((k - 1) // 2 * sum(d + 1 for d in dilations))
        for d in dilations:
            for dd in (d, 1):
                rows -= (k - 1) * dd
                yield k, rows


def rows_computed_share(b, t, tile, kernel_sizes, dilations) -> float:
    """Rows the convs of a launch compute over the rows they deliver, each
    conv weighted by its taps: what the recomputed halo costs."""
    tiles = -(-t // tile)
    last = t - (tiles - 1) * tile
    computed = sum(n * k * rows for n_out, n in ((tile, tiles - 1), (last, 1))
                   for k, rows in _conv_rows(n_out, kernel_sizes, dilations))
    delivered = t * 2 * len(dilations) * sum(kernel_sizes)
    return computed / delivered


# The chooser's time model of one block, in units of one m64n128k8 split
# product (three wgmmas): the tensor cores' rate at N = NB relative to N =
# 128, a step's fixed cost (barrier, weight wait, the f32 sum) and a conv's
# (cluster barrier, first window read from L2, drain).  Fitted to 18 stage
# timings of the kernel on an H100 (HiFiGAN's four stages at 448 and 2048
# frames, each block width forced in turn): within 5 % RMS, 9 % at worst.
MMA_RATE = {128: 1.0, 64: 0.65, 32: 0.4}
STEP_COST = 3.5
CONV_COST = 96


def _tile_cost(tile, rows_per_pass, kernel_sizes, dilations) -> int:
    """Passes of one block over a tile, weighted by taps: each conv computes
    the rows later convs read, in whole passes of ``rows_per_pass`` rows
    (K3's chooser, ``kernels/stage.py``, weighs its tilings with it)."""
    return sum(k * -(-rows // rows_per_pass)
               for k, rows in _conv_rows(tile, kernel_sizes, dilations))


def _block_time(tile, channels, nb, kernel_sizes, dilations) -> float:
    """One K2 block's time over a tile of ``channels`` channels in blocks
    of ``nb``: each conv computes its rows in whole M tiles of
    ``rows_per_pass(nb)`` rows, k taps x C / 8 steps each."""
    steps, rt = channels // 8, rows_per_pass(nb)
    unit = rt / 64 * nb / 128 / MMA_RATE[nb]
    return sum(steps * -(-rows // rt) * (k * unit + STEP_COST) + CONV_COST
               for k, rows in _conv_rows(tile, kernel_sizes, dilations))


@functools.lru_cache(maxsize=512)
def stage_tiling(b: int, t: int, channels: int, n_sm: int, kernel_sizes, dilations,
                 clusters_in_flight=None) -> StageTiling:
    """Pick K2's block width, time tile and cluster size for one call.

    Options: NB = 128, 64 or 32 channels per block, cluster C / NB of at
    most 8, C first widened by ``kernel_channels``, whose shared memory fits.
    ``clusters_in_flight``: ((cluster, clusters the card runs at once), ...)
    as the device reports it; default n_sm // cluster.  For each option and
    each number of waves w, the tile is the smallest that needs only w
    waves of clusters; the estimate is waves x ``_block_time``, and the
    cheapest wins (ties: fewer waves, then smaller clusters).  So a stage
    fills the card unless its recomputed halo costs more than the idle
    SMs, and a tile never gets so large that the streams of all clusters in
    flight pass ``L2_SCRATCH_BYTES``."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    halo = stage_halo(kernel_sizes, dilations)
    in_flight = dict(clusters_in_flight or ())
    channels = kernel_channels(channels)
    options = _block_options(channels, kernel_sizes[-1], dilations[-1])
    if not options:
        raise ValueError(f"K2's shared memory does not fit kernel size {kernel_sizes[-1]} "
                         f"at dilation {dilations[-1]}")
    floor = min(_block_time(1, channels, nb, kernel_sizes, dilations) for nb, _ in options)
    best = None
    for nb, cs in options:
        slots = max(1, in_flight.get(cs, n_sm // cs))
        max_tiles = -(-t // min(MIN_TILE, t))
        waves = 0
        while waves * floor < (best[0][0] if best else float("inf")):
            waves += 1
            tile = -(-t // min(max(1, waves * slots // b), max_tiles))
            jobs = b * -(-t // tile)
            clusters = min(jobs, slots)
            if clusters * 2 * (tile + 2 * halo) * channels * 4 > L2_SCRATCH_BYTES \
                    and tile > MIN_TILE:
                continue
            n_waves = -(-jobs // slots)
            est = (n_waves * _block_time(tile, channels, nb, kernel_sizes, dilations),
                   n_waves, cs)
            if best is None or est < best[0]:
                best = (est, StageTiling(tile, cs, nb, clusters, halo, jobs))
            if tile <= MIN_TILE:
                break
    return best[1]


def split_tf32(w: torch.Tensor) -> torch.Tensor:
    """(..., 2): w's TF32 (big, small) pair, big = tf32(w), small = tf32(w - big),
    rounded to nearest with ties away from zero as ``cvt.rna.tf32.f32`` does."""
    def rna(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    big = rna(w)
    return torch.stack([big, rna(w - big)], dim=-1).contiguous()


def pack_split_weights(sw: StageWeights, nb: int) -> torch.Tensor:
    """``sw.w``'s TF32 (big, small) pairs as the kernel reads them for blocks
    of ``nb`` channels, conv by conv (k C C 2 floats each): (C / nb, C / 8,
    k, {big, small}, 2, nb, 4), the weight of tap, input channel 8 s + 4 h +
    e, output channel r nb + n at [r, s, tap, ., h, n, e].  So one block's
    weights of one step of 8 input channels are one contiguous run."""
    c, off, parts = sw.channels, 0, []
    for k in sw.kernel_sizes:
        for _ in range(2 * len(sw.dilations)):
            pairs = split_tf32(sw.w[off:off + k * c * c].view(k, c, c))
            parts.append(pairs.view(k, c // 8, 2, 4, c // nb, nb, 2)
                         .permute(4, 1, 0, 6, 2, 5, 3).reshape(-1))
            off += k * c * c
    return torch.cat(parts).contiguous()


def _packed_weights(sw: StageWeights, nb: int) -> torch.Tensor:
    """``pack_split_weights(sw, nb)``, made once per StageWeights and nb."""
    cache = sw.__dict__.setdefault("_tf32_packed", {})
    key = (nb, sw.w.device)
    if key not in cache:
        cache[key] = pack_split_weights(sw, nb)
    return cache[key]


_max_clusters_cache: dict = {}


def _clusters_in_flight(device, channels, kernel_sizes, dilations):
    """((cluster, clusters the device runs at once), ...) for K2's options
    at the kernel's width of ``channels``."""
    channels = kernel_channels(channels)
    key = (device.index, channels, kernel_sizes[-1], dilations[-1])
    if key not in _max_clusters_cache:
        lib = build.load("hifigan_stage")
        fn = lib.hifigan_stage_max_clusters
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        pairs = []
        for nb, _ in _block_options(channels, kernel_sizes[-1], dilations[-1]):
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = fn(channels, channels // nb, kernel_sizes[-1], dilations[-1],
                         ctypes.addressof(n))
            build.check(lib, err, "hifigan_stage_max_clusters")
            pairs.append((channels // nb, n.value))
        _max_clusters_cache[key] = tuple(pairs)
    return _max_clusters_cache[key]


def widened(sw: StageWeights, c: int) -> StageWeights:
    """``sw`` with zero channels added up to ``c``: zero weights into and out
    of them and zero bias, so their stream stays lrelu(0) = 0 through every
    conv and residual, and the other channels' sums gain only exact zeros."""
    pad = c - sw.channels
    convs = [(F.pad(w, (0, 0, 0, pad, 0, pad)), F.pad(b, (0, pad)))
             for w, b, _ in sw.conv_weights()]
    return pack_stage(convs, c, sw.kernel_sizes, sw.dilations, sw.slope)


def _widened(sw: StageWeights) -> StageWeights:
    """``widened(sw, kernel_channels(C))``, made once per StageWeights."""
    cached = sw.__dict__.get("_widened")
    if cached is None or cached.w.device != sw.w.device:
        cached = widened(sw, kernel_channels(sw.channels))
        object.__setattr__(sw, "_widened", cached)
    return cached


def tiling_for(x: torch.Tensor, sw: StageWeights) -> StageTiling:
    """The tiling ``hifigan_stage`` launches x with on its card."""
    b, t, c = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    return stage_tiling(b, t, c, n_sm, tuple(sw.kernel_sizes), tuple(sw.dilations),
                        _clusters_in_flight(x.device, c, sw.kernel_sizes, sw.dilations))


def hifigan_stage(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32 contiguous, C <= 512 on the card; returns (B, T, C)
    f32.  Other widths than the kernel's run widened with zero channels
    (``kernel_channels``, ``widened``).  The kernel has no backward: on the
    card a call with grad enabled on an input that requires grad raises
    ValueError.
    """
    if x.device.type == "cpu":
        return hifigan_stage_plain(x, sw)
    if x.device.type != "cuda":
        raise ValueError(f"hifigan_stage takes cuda or cpu tensors, got {x.device}")
    _check(x, sw)
    b, t, c = x.shape
    wide = kernel_channels(c)
    if wide != c:
        return hifigan_stage(F.pad(x, (0, wide - c)), _widened(sw))[..., :c].contiguous()
    tl = tiling_for(x, sw)
    w = _packed_weights(sw, tl.block_channels)
    out = torch.empty_like(x)
    scratch = torch.empty((tl.clusters, 2, tl.tile + 2 * tl.halo, c), device=x.device,
                          dtype=torch.float32)
    lib = build.load("hifigan_stage")
    fn = lib.hifigan_stage_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
    ks, ds = sw.kernel_sizes, sw.dilations
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), sw.b.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), b, t, c, ks[0], ks[1], ks[2], ds[0], ds[1], ds[2],
                 tl.tile, tl.halo, tl.cluster, tl.grid, sw.slope, stream)
    build.check(lib, err, "hifigan_stage")
    build.count_launch(hifigan_stage)
    build.count_launch(_VARIANTS[tl.variant])
    return out


class _VariantCount:
    """The launches of one kernel instance, kept in ``hifigan_stage.variants``
    ({``StageTiling.variant``: launches}, plain integers) and counted by
    ``build.count_launch`` as the wrapper's own, a CUDA graph's replays too."""

    def __init__(self, name: str):
        self.name = name

    @property
    def launches(self) -> int:
        return hifigan_stage.variants.get(self.name, 0)

    @launches.setter
    def launches(self, n: int):
        hifigan_stage.variants[self.name] = n


hifigan_stage.launches = 0
hifigan_stage.variants = {}
_VARIANTS = {f"nb{nb}": _VariantCount(f"nb{nb}") for nb in BLOCK_CHANNELS}


def _check(x: torch.Tensor, sw: StageWeights):
    """What the kernel needs of x and sw (the wrapper's own copies, out and
    the scratch, are fresh allocations and meet it)."""
    if x.dim() != 3 or x.shape[-1] != sw.channels:
        raise ValueError(f"x must be (B, T, {sw.channels}), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if sw.w.device != x.device or sw.b.device != x.device:
        raise ValueError("stage weights must be on the input's device")
    if len(sw.kernel_sizes) != 3 or len(sw.dilations) != 3:
        raise ValueError("the kernel takes 3 stacks x 3 rounds")
    if sw.channels > MAX_CHANNELS:
        raise ValueError(f"the kernel takes C up to {MAX_CHANNELS}, got {sw.channels}")
    if list(sw.kernel_sizes) != sorted(sw.kernel_sizes) or \
            list(sw.dilations) != sorted(sw.dilations):
        raise ValueError("kernel sizes and dilations must be ascending")
    build.check_aligned("hifigan_stage", x=x)
    build.check_no_grad("hifigan_stage", x=x, w=sw.w, b=sw.b)
