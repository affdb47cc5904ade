"""K4's launch and weight layout on the CPU: ``imcol_tiling`` (the cluster,
the walk over K and the shared memory of each launch), the zero channels
added for a width that is not a multiple of 4, and the weights packed by
output channel.  The CUDA kernel itself runs only on the card
(``chip_smoke.py``); these are the parts of its wrapper that decide what it
is given."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from toucan_tpu_torch.kernels import imcol
from toucan_tpu_torch.kernels.imcol import (imcol_fold, imcol_stage_plain, imcol_tiling,
                                            prepare_imcol_stage, widened)
from toucan_tpu_torch.kernels.resstack import pack_stage
from toucan_tpu_torch.kernels.stage import (EPW, SMEM_LIMIT, pack_words, quantize_weight,
                                            unpack_words)

from test_torch_kernels import _stage_weights

torch.set_num_threads(2)

KS, DIL = (3, 7, 11), (1, 3, 5)
N_SM = 132
# clusters of 1, 2 and 4 blocks the H100 runs at once at one block per SM
# (cudaOccupancyMaxActiveClusters, as chip_smoke.py reads it for K2)
H100_CLUSTERS = ((4, 30), (2, 66), (1, 132))
# the stage widths of at most 128 channels that HiFiGAN generators of 64 to
# 1024 channels (powers of two), the released 512 and 192 or 384 channels
# give stages 1-3
WIDTHS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_k4_tiling_fits_every_width(mode, c):
    """At its fold, every width gets a launch whose operand rows, weight
    buffers and slots fit in shared memory; ldmatrix rows (not flat) only
    where C / e is a multiple of 8."""
    fold = imcol_fold(c)
    for b, frames in ((1, 512), (4, 1024), (1, 2048)):
        t = frames * 384 // (2 * c) * 2 if c < 256 else frames
        t -= t % fold
        tl = imcol_tiling(mode, b, t, c, fold, N_SM, KS, DIL, H100_CLUSTERS)
        need = imcol._smem_bytes(tl.window, tl.cluster, tl.margin, tl.wpr, KS[-1], tl.wslots)
        assert need <= tl.smem <= SMEM_LIMIT
        cw = c // EPW[mode]
        assert tl.wpr >= cw and (tl.flat or cw % 8 == 0)
        assert tl.window // tl.cluster >= tl.margin == 25
        assert tl.step == 512 * fold and 1 <= tl.clusters <= tl.windows
        assert tl.scratch_bytes == tl.clusters * 2 * tl.window * c * 4


def test_k4_tiling_refuses_what_does_not_fit():
    """A window that fits in shared memory only split over a cluster runs on
    one (C = 1 of a 16-channel generator, widened to 4, folds 128 samples
    into 67 584 rows a window); one that fits in no cluster, a width above
    128 channels or C % 4 != 0 (which the wrapper widens first) raise."""
    with pytest.raises(ValueError, match="does not fit"):
        imcol_tiling("int8", 1, 512 * 128, 4, 128, N_SM, clusters=(1,))
    assert imcol_tiling("int8", 1, 512 * 128, 4, 128, N_SM).cluster == 4
    with pytest.raises(ValueError, match="does not fit"):
        imcol_tiling("bf16", 1, 8192, 128, 1, N_SM, tile=4096)
    for c, fold in ((256, 1), (6, 21)):
        with pytest.raises(ValueError, match="C % 4"):
            imcol_tiling("int8", 1, 512 * fold, c, fold, N_SM)


@pytest.mark.parametrize("frames,b", [(512, 1), (2048, 1), (1024, 4)])
def test_k4_tiling_on_the_main_path(frames, b):
    """The released geometry's stages 1-3 on the H100: ldmatrix rows in both
    modes.  A stage with at most half as many windows as SMs (48 at stage 1
    of 512 frames) fills the card: clusters of blocks small enough that
    two share an SM, at least one block per SM.  The others take one block
    per window at one block per SM (splitting 96 windows still takes two
    waves of 132 SMs, and measured slower in int8)."""
    for scale, c in ((48, 128), (192, 64), (384, 32)):
        for mode in ("int8", "bf16"):
            tl = imcol_tiling(mode, b, scale * frames, c, imcol_fold(c), N_SM, KS, DIL,
                              H100_CLUSTERS)
            assert not tl.flat
            assert tl.windows == b * -(-scale * frames // imcol_fold(c) // 512)
            if 2 * tl.windows <= N_SM:
                assert tl.cluster > 1 and tl.per_sm == 2 and tl.grid >= N_SM
                assert tl.smem <= imcol.TWO_BLOCK_SMEM
            else:
                assert tl.cluster == tl.per_sm == 1 and tl.grid == min(tl.windows, N_SM)
            one = imcol_tiling(mode, b, scale * frames, c, imcol_fold(c), N_SM, KS, DIL,
                               H100_CLUSTERS, clusters=(1,))
            assert one.cluster == one.per_sm == 1 and one.grid == min(one.windows, N_SM)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_k4_weights_unpack_as_in_the_earlier_layout(mode):
    """K4's weights are packed by output channel, (k, C_out, C_in / e, e):
    ``conv_weights`` gives the same values as the earlier (k, C_in / e,
    C_out, e) packing of the same quantized weights."""
    c = 32
    sw = _stage_weights(np.random.RandomState(3), c, KS, DIL)
    st = prepare_imcol_stage(sw, mode)
    assert st.w.numel() == sw.w.numel()
    earlier = []
    for w, _, _ in sw.conv_weights():
        q = quantize_weight(w)[0] if mode == "int8" else w.to(torch.bfloat16)
        earlier.append(pack_words(q, EPW[mode]))
    want = list(unpack_words(torch.cat(earlier), mode, c, KS, DIL))
    got = list(st.conv_weights())
    assert len(got) == len(want) == 18
    for (wg, dg), (ww, dw) in zip(got, want):
        assert dg == dw and torch.equal(wg, ww)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_widened_stage_is_the_same_stage(mode):
    """A width that is not a multiple of 4 (C = 6, fold 21) runs with zero
    channels added: the widened stage on the zero-padded input gives the
    stage's output bit for bit, and its added channels stay zero."""
    g = torch.Generator().manual_seed(0)
    c = 6
    convs = [(torch.randn(c, c, k, generator=g) / math.sqrt(k * c),
              0.1 * torch.randn(c, generator=g)) for k in KS for _ in range(6)]
    st = prepare_imcol_stage(pack_stage(convs, c, KS, DIL, 0.1), mode)
    x = torch.randn(1, 21 * 40, c, generator=g)
    want = imcol_stage_plain(x, st, 21, tile=32)
    wide = widened(st, 8)
    got = imcol_stage_plain(F.pad(x, (0, 2)), wide, 21, tile=32)
    assert wide.channels == 8 and wide.w.dtype == st.w.dtype
    assert torch.equal(got[..., :c], want) and not got[..., c:].any()
