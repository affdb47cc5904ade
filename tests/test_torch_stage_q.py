"""K3's tiling and weight layout, and every kernel wrapper's refusal of
gradients, on the CPU.

The CUDA kernels write their outputs through raw pointers, so on the card
an output has no autograd graph; each wrapper's argument check raises
ValueError before a launch when grad is enabled and an input requires grad.
The checks run here on CPU tensors, as the wrappers run them on CUDA
tensors, while the wrappers themselves take the plain versions for CPU
tensors, which stay differentiable.
"""

import dataclasses

import numpy as np
import pytest
import torch

from toucan_tpu_torch.kernels import aliasfree, flash_attention, imcol, resstack, stage
from toucan_tpu_torch.kernels.aliasfree import alias_free_snake
from toucan_tpu_torch.kernels.flash_attention import flash_rel_attention
from toucan_tpu_torch.kernels.imcol import imcol_fold, imcol_stage, prepare_imcol_stage
from toucan_tpu_torch.kernels.resstack import hifigan_stage, stage_halo
from toucan_tpu_torch.kernels.stage import (EPW, SMEM_LIMIT, _smem_bytes, pack_words,
                                            quantize_stage, quantize_weight, quantized_stage,
                                            stage_tiling, unpack_words)

from test_torch_kernels import _attention_inputs, _stage_weights

torch.set_num_threads(2)

KS, DIL = (3, 7, 11), (1, 3, 5)
N_SM = 132
WRAPPERS = (flash_rel_attention, hifigan_stage, quantized_stage, imcol_stage, alias_free_snake)


def _k1():
    (q_u, q_v, k, v), p, lens = _attention_inputs(8, (8, 3))
    args = [torch.from_numpy(a) for a in (q_u, q_v, k, v, p, lens)]
    return flash_attention._check, args, [0, 1, 2, 3, 4]


def _k2():
    sw = _stage_weights(np.random.RandomState(0), 32, KS, DIL)
    return resstack._check, [torch.zeros(1, 16, 32), sw], [0]


def _k3():
    sw = _stage_weights(np.random.RandomState(0), 32, KS, DIL)
    return stage._check, [torch.zeros(1, 16, 32), quantize_stage(sw, "bf16")], [0]


def _k4():
    sw = _stage_weights(np.random.RandomState(0), 32, KS, DIL)
    return imcol._check, [torch.zeros(1, 16, 32), prepare_imcol_stage(sw, "int8"),
                          imcol_fold(32)], [0]


def _k5():
    args = [torch.zeros(1, 16, 8), torch.zeros(8), torch.zeros(8)]
    return aliasfree._check, args, [0, 1, 2]


def _weights_requiring_grad(kernel, args):
    """The prepared weight tensors of K2-K4 as leaves that require grad."""
    if kernel == "k2":
        sw = args[1]
        return [resstack.StageWeights(sw.w.clone().requires_grad_(), sw.b, sw.channels,
                                      sw.kernel_sizes, sw.dilations)]
    if kernel == "k3":
        qs = args[1]
        return [stage.QuantizedStage(qs.mode, qs.w, qs.qin, qs.deq,
                                     qs.bias.clone().requires_grad_(), qs.channels,
                                     qs.kernel_sizes, qs.dilations, qs.slope)]
    if kernel == "k4":
        st = args[1]
        return [dataclasses.replace(st, scale=st.scale.clone().requires_grad_())]
    return []


@pytest.mark.parametrize("kernel,case", [("k1", _k1), ("k2", _k2), ("k3", _k3), ("k4", _k4),
                                         ("k5", _k5)])
def test_wrappers_refuse_grad(kernel, case):
    """Each of K1-K5's checks raises with grad enabled and an input (or a
    prepared weight tensor) that requires grad, passes under no_grad and
    with no input that requires grad, and launches nothing."""
    check, args, grad_args = case()
    check(*args)
    for i in grad_args:
        bad = list(args)
        bad[i] = args[i].clone().requires_grad_()
        with pytest.raises(ValueError, match="require grad"):
            check(*bad)
        with torch.no_grad():
            check(*bad)
        with torch.inference_mode():
            check(*bad)
    for weights in _weights_requiring_grad(kernel, args):
        with pytest.raises(ValueError, match="require grad"):
            check(args[0], weights, *args[2:])
        with torch.no_grad():
            check(args[0], weights, *args[2:])
    assert all(w.launches == 0 for w in WRAPPERS)


def test_plain_versions_stay_differentiable():
    """On CPU tensors the wrappers run the plain versions, and a gradient
    flows through them."""
    sw = _stage_weights(np.random.RandomState(0), 32, KS, DIL)
    x = torch.randn(1, 16, 32, requires_grad=True)
    hifigan_stage(x, sw).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    x.grad = None
    quantized_stage(x, sw, "bf16").sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    alpha = torch.zeros(32, requires_grad=True)
    alias_free_snake(torch.randn(1, 16, 32), alpha, torch.zeros(32)).sum().backward()
    assert alpha.grad is not None
    assert all(w.launches == 0 for w in WRAPPERS)


# clusters of 1, 2 and 4 blocks the H100 runs at once at one block per SM,
# as cudaOccupancyMaxActiveClusters reports them for K2 (chip_smoke.py)
H100_CLUSTERS = ((4, 30), (2, 66), (1, 132))


@pytest.mark.parametrize("clusters_in_flight", [None, H100_CLUSTERS], ids=["n_sm", "h100"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("frames", [512, 896, 2048])
@pytest.mark.parametrize("b", [1, 4])
def test_k3_tiling_fills_the_card(mode, frames, b, clusters_in_flight):
    """At every HiFiGAN stage shape of the main path (512 channels: stage i
    has 256 / 2^i channels and 8, 48, 192, 384 samples per frame) on 132
    SMs: the operands fit in shared memory, the tiles cover T, each block
    takes a multiple of 32 channels of a cluster of at most 4, and there are
    at least as many tiles as clusters the card runs at once (so at least
    as many blocks as it runs), or one tile covers T."""
    halo = stage_halo(KS, DIL)
    slots = dict(clusters_in_flight or ())
    for scale, c in ((8, 256), (48, 128), (192, 64), (384, 32)):
        t = scale * frames
        tl = stage_tiling(mode, b, t, c, N_SM, KS, DIL, clusters_in_flight)
        in_flight = slots.get(tl.cluster, N_SM // tl.cluster)
        assert tl.halo == halo == 60
        assert tl.cluster in (1, 2, 4) and (c // tl.cluster) % 32 == 0
        assert _smem_bytes(mode, c, tl.tile, halo, KS[-1]) <= tl.smem <= SMEM_LIMIT
        assert tl.tile == -(-t // tl.n_tiles) and tl.jobs == b * tl.n_tiles
        assert tl.jobs >= in_flight or tl.tile >= t
        assert tl.clusters == min(tl.jobs, in_flight)


def test_k3_tiling_splits_only_short_wide_stages():
    """Stage 0 at 512 frames (T = 4096, C = 256) has too few rows to give
    132 blocks tiles longer than the halo: the chooser splits its channels
    over a cluster; capped at one block, it cuts T into one tile per SM.
    Stage 1 (T = 24576, C = 128) gives 187-row tiles and is not split, nor
    is any stage of a batch of 4."""
    tl = stage_tiling("int8", 1, 4096, 256, N_SM, KS, DIL, H100_CLUSTERS)
    assert tl.cluster > 1 and tl.tile > 4096 // N_SM
    one = stage_tiling("int8", 1, 4096, 256, N_SM, KS, DIL, H100_CLUSTERS, max_cluster=1)
    assert (one.cluster, one.jobs, one.clusters) == (1, N_SM, N_SM)
    assert one.tile < one.halo
    assert stage_tiling("int8", 1, 24576, 128, N_SM, KS, DIL, H100_CLUSTERS).cluster == 1
    for scale, c in ((8, 256), (48, 128), (192, 64), (384, 32)):
        assert stage_tiling("int8", 4, scale * 512, c, N_SM, KS, DIL, H100_CLUSTERS).cluster == 1


@pytest.mark.parametrize("mode,widest", [("int8", 512), ("bf16", 352)])
def test_k3_tiling_takes_every_width(mode, widest):
    """Every C % 32 == 0 up to 512 (int8) or 352 (bf16) gets a tiling that
    fits in shared memory; a wider bf16 stage, whose two operand tiles with
    the halo do not fit, raises ValueError (as wider ones than 288 did
    before), and so does C % 32 != 0."""
    for c in range(32, 513, 32):
        if c <= widest:
            tl = stage_tiling(mode, 1, 4096, c, N_SM, KS, DIL)
            assert tl.tile >= stage.MIN_TILE and tl.smem <= SMEM_LIMIT
        else:
            with pytest.raises(ValueError, match="fit in shared memory"):
                stage_tiling(mode, 1, 4096, c, N_SM, KS, DIL)
    with pytest.raises(ValueError):
        stage_tiling(mode, 1, 4096, 48, N_SM, KS, DIL)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_k3_weights_unpack_as_in_the_earlier_layout(mode):
    """K3's weights are packed by output channel, (k, C_out, C_in / e, e):
    ``conv_weights`` gives the same values as the earlier (k, C_in / e,
    C_out, e) packing of the same quantized weights."""
    c = 64
    sw = _stage_weights(np.random.RandomState(3), c, KS, DIL)
    scales = torch.rand(18) + 0.5
    qs = quantize_stage(sw, mode, scales if mode == "int8" else None)
    assert qs.w.numel() == sw.w.numel()
    earlier = []
    for w, _, _ in sw.conv_weights():
        q = quantize_weight(w)[0] if mode == "int8" else w.to(torch.bfloat16)
        earlier.append(pack_words(q, EPW[mode]))
    want = list(unpack_words(torch.cat(earlier), mode, c, KS, DIL))
    got = list(qs.conv_weights())
    assert len(got) == len(want) == 18
    for (wg, dg), (ww, dw) in zip(got, want):
        assert dg == dw and torch.equal(wg, ww)
