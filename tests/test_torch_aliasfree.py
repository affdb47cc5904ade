"""K5's polyphase form, launch geometry and checks, on the CPU.

The CUDA kernel (``csrc/alias_free_snake.cu``) computes the 2x signal as its
even and odd branches with the four phase filters the wrapper passes it
(``kernels/aliasfree.py::phase_filters``), and walks runs of 256-sample
chunks chosen by ``snake_geometry``.  Here the taps, applied by the same
formula in PyTorch (``alias_free_snake_polyphase``), are held against the
plain version (``nn/alias_free.py::alias_free_snake``) within 1e-6 and
against the JAX package's split; the chooser is held to fill the card at
the main path's shapes and never to ask for float4 access to a row that
does not start on a 16-byte boundary.  The kernel itself is held against
the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from toucan_tpu.nn.alias_free import _phase_filters as jax_phase_filters
from toucan_tpu_torch.kernels import aliasfree
from toucan_tpu_torch.kernels.aliasfree import (CHUNK, alias_free_snake,
                                                alias_free_snake_plain,
                                                alias_free_snake_polyphase, phase_filters,
                                                snake_geometry)

torch.set_num_threads(2)

N_SM = 132
# BigVGAN's stages at 512 channels: (samples per mel frame, channels)
STAGES = ((8, 256), (48, 128), (192, 64), (384, 32))


def _inputs(b, t, c, seed=0, scale=1.0):
    rng = np.random.RandomState(seed + 7 * t + c)
    x = torch.from_numpy((scale * rng.randn(b, t, c)).astype(np.float32))
    alpha, beta = (torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32)) for _ in range(2))
    return x, alpha, beta


def test_phase_filters_are_the_jax_split():
    for ours, theirs in zip(phase_filters(), jax_phase_filters()):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    # the zero taps the kernel skips at compile time
    up0, up1, dn_even, dn_odd = phase_filters()
    assert up0[6] == up1[0] == dn_even[0] == dn_odd[6] == 0


def test_kernel_gets_the_phase_filters():
    """The 28 floats the wrapper hands the kernel, in its (up0, up1,
    dn_even, dn_odd) order."""
    np.testing.assert_array_equal(np.asarray(aliasfree._TAPS, np.float32),
                                  np.concatenate(phase_filters()))


@pytest.mark.parametrize("c", [1, 20, 32])
@pytest.mark.parametrize("t", [1, 7, 8, 40, 4099])
def test_polyphase_taps_match_plain(t, c):
    """The kernel's formula with the taps it is given, replicate edges
    included (T = 1 is all edge), against the plain version.  The formula
    runs in float64 on the f32 taps, so what is left is the plain version's
    own f32 rounding (up to 2 ulp of |z| <= 6 here)."""
    x, alpha, beta = _inputs(2, t, c)
    taps = [np.frombuffer(aliasfree._TAPS, np.float32)[7 * i:7 * i + 7] for i in range(4)]
    got = alias_free_snake_polyphase(x.double(), alpha.double(), beta.double(), taps)
    want = alias_free_snake_plain(x, alpha, beta)
    assert got.shape == want.shape == (2, t, c)
    assert (got.float() - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("frames,b", [(512, 1), (896, 1), (2048, 1), (512, 4), (896, 4),
                                      (1024, 4), (2048, 4)])
def test_geometry_fills_the_card(frames, b):
    """At every stage shape of the main path: at least one block per SM,
    every warp slot busy where there are runs enough, each run's samples
    covered once, and float4 access (T is a multiple of 8 there)."""
    slots = N_SM * aliasfree.BLOCKS_PER_SM * aliasfree.WARPS_PER_BLOCK
    for scale, c in STAGES:
        t = scale * frames
        geo = snake_geometry(b, t, c, N_SM)
        per_row = -(-t // CHUNK)
        assert geo.blocks >= N_SM
        assert geo.segs_per_row == -(-per_row // geo.seg_chunks)
        assert (geo.segs_per_row - 1) * geo.seg_chunks < per_row
        assert geo.items == b * c * geo.segs_per_row
        assert geo.warps >= min(geo.items, slots) and geo.warps <= max(slots, geo.items) + 3
        # runs are balanced over the slots: the busiest warp walks at most
        # one run more than the average
        assert -(-geo.items // geo.warps) * geo.seg_chunks <= \
            b * c * per_row / geo.warps + geo.seg_chunks
        assert geo.vector


@pytest.mark.parametrize("t", [4099, 8194, 6, 1])
def test_geometry_never_vectorizes_unaligned_rows(t):
    """Rows of (B, C, T) start on a 16-byte boundary only if T % 4 == 0 and
    x does: any other shape takes the scalar path everywhere."""
    for aligned in (True, False):
        assert not snake_geometry(1, t, 20, N_SM, aligned=aligned).vector
    assert not snake_geometry(1, 4096, 20, N_SM, aligned=False).vector
    assert snake_geometry(1, 4096, 20, N_SM, aligned=True).vector


def test_one_tile_geometry():
    """``persistent=False``: one chunk a run, one warp a run."""
    geo = snake_geometry(1, 98304, 64, N_SM, persistent=False)
    assert geo.seg_chunks == 1 and geo.items == 64 * 384
    assert geo.warps >= geo.items > N_SM * aliasfree.BLOCKS_PER_SM * aliasfree.WARPS_PER_BLOCK


def test_wrapper_checks_before_launch():
    """Grad, a meta device and bad shapes raise ValueError before a launch
    (the checks run here on CPU tensors as the wrapper runs them on CUDA
    tensors)."""
    x, alpha, beta = _inputs(1, 64, 20)
    aliasfree._check(x, alpha, beta)
    with pytest.raises(ValueError, match="require grad"):
        aliasfree._check(x, alpha.clone().requires_grad_(), beta)
    with torch.no_grad():
        aliasfree._check(x.clone().requires_grad_(), alpha, beta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        alias_free_snake(x.to("meta"), alpha.to("meta"), beta.to("meta"))
    for bad in (x[0], x.double(), x[:, :0]):
        with pytest.raises(ValueError):
            aliasfree._check(bad, alpha, beta)
    with pytest.raises(ValueError, match="alpha"):
        aliasfree._check(x, alpha[:-1], beta)
    assert alias_free_snake.launches == 0
