"""K1's bf16 kernel launch and its split-and-combine arithmetic, on the CPU.

No kernel runs here: ``bf16_geometry`` is the pure function of the shapes
that the wrapper launches the bf16 kernel with (key splits, grid, shared
memory), and ``flash_rel_attention_split_plain`` is the plain model of the
kernel's splits and their combine, held to ``flash_rel_attention_plain``
on seeded numpy inputs at 2e-5 (TOL_K1 of ``chip_smoke.py``: the model
only reorders f32 sums and takes 2^x for e^x, ~1e-7 apart).
"""

import numpy as np
import pytest
import torch

from toucan_tpu_torch.kernels.flash_attention import (BUILT_HEAD_DIMS, SM_COUNT, bf16_geometry,
                                                      flash_rel_attention_plain,
                                                      flash_rel_attention_split_plain)

TOL = 2e-5
SMEM_LIMIT = 232448  # 227 KB, what one block of the H100 can take
SHAPES = [(1, 4, 2048, 48), (1, 4, 128, 48), (2, 4, 2048, 48), (1, 4, 896, 48),
          (4, 4, 1024, 48), (2, 4, 2048, 96), (3, 4, 4099, 48), (3, 4, 1000, 48),
          (3, 4, 127, 48), (1, 1, 1, 16), (1, 2, 65, 40), (1, 1, 640, 128)]


@pytest.mark.parametrize("b,h,t,d", SHAPES)
def test_splits_cover_each_key_tile_once(b, h, t, d):
    geo = bf16_geometry(b, h, t, d)
    n_kt = -(-t // geo.key_tile)
    runs = [range(s * geo.tiles_per_split, min((s + 1) * geo.tiles_per_split, n_kt))
            for s in range(geo.splits)]
    assert all(len(r) for r in runs), "an empty split"
    assert sorted(k for r in runs for k in r) == list(range(n_kt))
    assert geo.grid == (-(-t // geo.query_tile) * geo.splits, h, b)


@pytest.mark.parametrize("t", [1, 2, 63, 64, 65, 127, 128, 129, 1000, 2048, 4099])
def test_no_split_is_empty(t):
    for b, h in ((1, 1), (1, 4), (2, 4)):
        geo = bf16_geometry(b, h, t, 48)
        assert (geo.splits - 1) * geo.tiles_per_split < -(-t // geo.key_tile)


@pytest.mark.parametrize("d", BUILT_HEAD_DIMS)
def test_shared_memory_fits(d):
    smem = bf16_geometry(1, 4, 2048, d).smem_bytes
    assert smem <= SMEM_LIMIT
    if d <= 64:  # two blocks an SM, each with its 1 KB of reserved shared memory
        assert 2 * (smem + 1024) <= 233472


def test_main_path_shapes_fill_the_card():
    # the decoder at the 2048-frame bucket: its 128 query tiles get key
    # splits, every SM busy within one wave of two blocks an SM
    dec = bf16_geometry(1, 4, 2048, 48)
    blocks = dec.grid[0] * dec.grid[1] * dec.grid[2]
    assert dec.splits > 1 and SM_COUNT <= blocks <= 2 * SM_COUNT
    # the encoder at the 128-phone bucket has two key tiles: a split would
    # halve a block's work but add the combine's launch, measured slower
    enc = bf16_geometry(1, 4, 128, 48)
    assert enc.splits == 1
    # large grids are never split
    assert bf16_geometry(3, 4, 4099, 48).splits == 1


def _inputs(rng, b, h, t, d, dtype):
    xs = [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4)]
    xs.append(rng.standard_normal((h, 2 * t - 1, d)).astype(np.float32))
    return [torch.from_numpy(x).to(dtype) for x in xs]


# (B, H, T, d, lengths, key tile, splits): a split wholly past lengths[b]
# (T = 13 in 4 splits of tiles of 2, lengths 3), lengths 0 and 1, T not a
# multiple of the tile, one split, the default geometry's splits (None)
SPLIT_CASES = [(2, 2, 13, 16, [3, 13], 2, 4), (3, 2, 13, 16, [0, 1, 13], 4, 3),
               (2, 1, 1, 16, [0, 1], 4, None), (1, 2, 7, 48, [7], 4, 1),
               (2, 2, 30, 16, [30, 9], 8, 2), (1, 2, 130, 48, [101], 64, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d,lengths,key_tile,splits", SPLIT_CASES)
def test_split_model_matches_plain(b, h, t, d, lengths, key_tile, splits, dtype):
    rng = np.random.default_rng(sum(lengths) + 7 * t)
    args = _inputs(rng, b, h, t, d, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = flash_rel_attention_plain(*args, lens)
    got = flash_rel_attention_split_plain(*args, lens, key_tile=key_tile, splits=splits)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= TOL
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))


def test_default_split_count_is_the_geometry_s():
    # at B=1 H=2 T=130 the three key tiles go to three splits
    assert bf16_geometry(1, 2, 130, 48).splits == 3
