"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, which is
held here against the Pallas kernels in interpret mode and against the
JAX package's plain (XLA) paths.  The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.kernels.folded_conv import fold_time, unfold_time
from toucan_tpu.kernels.pallas_attention import flash_rel_attention as jax_flash
from toucan_tpu.kernels.pallas_resstack import fused_folded_resstacks
from toucan_tpu.models.vocoders.hifigan import ResidualStack
from toucan_tpu.nn.attention import RelPositionMultiHeadedAttention as JaxRelMHA
from toucan_tpu_torch.kernels.flash_attention import flash_rel_attention
from toucan_tpu_torch.kernels.resstack import (hifigan_stage, hifigan_stage_plain,
                                               pack_stage, stage_halo)
from toucan_tpu_torch.nn.attention import RelPositionMultiHeadedAttention

torch.set_num_threads(2)

ATTN_CASES = [(8, (8, 3)), (23, (23, 17)), (40, (33, 40)), (130, (130, 0))]


def _attention_inputs(t, lengths, b=2, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    return qkv, p, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("t,lengths", ATTN_CASES)
def test_flash_plain_matches_pallas_interpret(t, lengths):
    (q_u, q_v, k, v), p, lens = _attention_inputs(t, lengths)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q_u, q_v, k, v, p, lens)), interpret=True))
    got = flash_rel_attention(*map(torch.from_numpy, (q_u, q_v, k, v, p, lens))).numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :, :n], want[b, :, :n], atol=2e-5)
    assert flash_rel_attention.launches == 0


@pytest.mark.parametrize("t,lengths", ATTN_CASES)
def test_rel_attention_module_matches_xla_path(t, lengths):
    """Every row, padded query rows included, against the XLA path."""
    b, f, h = 2, 64, 4
    rng = np.random.RandomState(1)
    x = rng.randn(b, t, f).astype(np.float32)
    pos = rng.randn(1, 2 * t - 1, f).astype(np.float32)
    mask = np.arange(t)[None, None, :] < np.asarray(lengths)[:, None, None]
    ref = JaxRelMHA(h, f, 0.0, use_flash=False)
    variables = ref.init(jax.random.PRNGKey(0), x, x, x, pos, mask=mask)
    params = jax.tree.map(np.asarray, variables["params"])
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        params[name]["bias"] = rng.randn(f).astype(np.float32) * 0.1
    want = np.asarray(ref.apply({"params": params}, x, x, x, pos, mask=mask))

    port = RelPositionMultiHeadedAttention(h, f)
    sd = {"pos_bias_u": params["pos_bias_u"], "pos_bias_v": params["pos_bias_v"],
          "linear_pos.weight": params["linear_pos"]["kernel"].T}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        sd[f"{name}.weight"] = params[name]["kernel"].T
        sd[f"{name}.bias"] = params[name]["bias"]
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})
    got = port(*map(torch.from_numpy, (x, x, x, pos)), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on another device raises instead of falling back."""
    (q_u, q_v, k, v), p, lens = _attention_inputs(8, (8, 3))
    meta = [torch.from_numpy(a).to("meta") for a in (q_u, q_v, k, v, p, lens)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_rel_attention(*meta)
    sw = _stage_weights(np.random.RandomState(0), 32, (3, 7, 11), (1, 3, 5))
    with pytest.raises(ValueError, match="cuda or cpu"):
        hifigan_stage(torch.zeros(1, 16, 32, device="meta"), sw)
    assert flash_rel_attention.launches == 0 and hifigan_stage.launches == 0


def _stack_params(rng, kernel_sizes, dilations, c):
    return [[tuple(rng.randn(*shape).astype(np.float32) * 0.05
                   for shape in ((ks, c, c), (c,), (ks, c, c), (c,)))
             for _ in dilations] for ks in kernel_sizes]


def _stage_weights(rng, c, kernel_sizes, dilations, params=None):
    """Pack JAX-layout (k, C_in, C_out) stack params for the port."""
    params = params or _stack_params(rng, kernel_sizes, dilations, c)
    convs = []
    for stack in params:
        for w1, b1, w2, b2 in stack:
            for w, bias in ((w1, b1), (w2, b2)):
                convs.append((torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))),
                              torch.from_numpy(bias)))
    return pack_stage(convs, c, kernel_sizes, dilations)


def _residual_stacks_mean(x, params, kernel_sizes, dilations):
    outs = []
    for stack, ks in zip(params, kernel_sizes):
        variables = {"params": {}}
        for i, (w1, b1, w2, b2) in enumerate(stack):
            variables["params"][f"conv1_{i}"] = {"kernel": w1, "bias": b1}
            variables["params"][f"conv2_{i}"] = {"kernel": w2, "bias": b2}
        outs.append(ResidualStack(x.shape[-1], ks, dilations).apply(variables, x))
    return np.asarray(sum(outs) / len(outs))


def test_stage_plain_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    c, fold, ks, dil = 8, 4, (3, 7, 11), (1, 3, 5)
    params = _stack_params(rng, ks, dil, c)
    x = rng.randn(2, 256, c).astype(np.float32) * 0.3
    jparams = [[tuple(map(jnp.asarray, conv)) for conv in stack] for stack in params]
    want = np.asarray(unfold_time(fused_folded_resstacks(
        fold_time(jnp.asarray(x), fold), jparams, fold, ks, dil, tile=64, interpret=True), fold))
    got = hifigan_stage(torch.from_numpy(x), _stage_weights(rng, c, ks, dil, params)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got, _residual_stacks_mean(x, params, ks, dil),
                               atol=2e-4, rtol=2e-3)
    assert hifigan_stage.launches == 0


@pytest.mark.parametrize("t", [250, 61])
def test_stage_plain_ragged_length(t):
    """A length that is a multiple of no tile, against the mean of the
    JAX package's ResidualStack modules."""
    rng = np.random.RandomState(2)
    c, ks, dil = 16, (3, 7, 11), (1, 3, 5)
    params = _stack_params(rng, ks, dil, c)
    x = rng.randn(1, t, c).astype(np.float32) * 0.3
    got = hifigan_stage_plain(torch.from_numpy(x), _stage_weights(rng, c, ks, dil, params))
    np.testing.assert_allclose(got.numpy(), _residual_stacks_mean(x, params, ks, dil),
                               atol=2e-4, rtol=2e-3)


def test_stage_weights_unpack_to_the_packed_convs():
    rng = np.random.RandomState(3)
    c, ks, dil = 8, (3, 7, 11), (1, 3, 5)
    params = _stack_params(rng, ks, dil, c)
    sw = _stage_weights(rng, c, ks, dil, params)
    flat = [(w, b, d) for stack in params for (w1, b1, w2, b2) in stack
            for w, b, d in ((w1, b1, None), (w2, b2, 1))]
    unpacked = list(sw.conv_weights())
    assert len(unpacked) == 18 and sw.w.numel() == 2 * 3 * sum(ks) * c * c
    for (w, b, _), (pw, pb, _) in zip(flat, unpacked):
        np.testing.assert_array_equal(pw.numpy(), w.transpose(2, 1, 0))
        np.testing.assert_array_equal(pb.numpy(), b)
    assert [d for _, _, d in unpacked] == [d for _ in ks for dd in dil for d in (dd, 1)]


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest on the bit pattern,
    ties away from zero, as cvt.rna.tf32.f32 does."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_products(split):
    """An f64 product of TF32 operands, as the tensor cores form it: single
    TF32 (big . big) or split TF32 (big . big + big . small + small . big,
    with small = tf32(x - big))."""
    def parts(x):
        big = _tf32(x)
        return big.double(), _tf32(x.float() - big).double()

    def product(op, a, b):
        (ab, as_), (bb, bs) = parts(a), parts(b)
        out = op(ab, bb)
        return out + op(ab, bs) + op(as_, bb) if split else out
    return product


def _attention_case(rng):
    (q_u, q_v, k, v), p, lens = _attention_inputs(128, (128,), b=1, h=2, d=48, seed=7)
    args = [torch.from_numpy(a).double() for a in (q_u, q_v, k, v, p)]
    return args + [torch.from_numpy(lens)]


def _stage_case(rng):
    """One stage at C = 64, T = 256 with conv weights at unit gain (std
    1/sqrt(k C)): at HiFiGAN's init std of 0.01 the convs hardly move the
    stream, and single TF32 passes too."""
    c, ks, dil = 64, (3, 7, 11), (1, 3, 5)
    params = [[(rng.randn(k, c, c) / np.sqrt(k * c), rng.randn(c) * 0.1,
                rng.randn(k, c, c) / np.sqrt(k * c), rng.randn(c) * 0.1)
               for _ in dil] for k in ks]
    params = [[tuple(a.astype(np.float32) for a in conv) for conv in stack] for stack in params]
    sw = _stage_weights(rng, c, ks, dil, params)
    sw = type(sw)(sw.w.double(), sw.b.double(), c, ks, dil, sw.slope)
    return [torch.from_numpy(rng.randn(1, 256, c).astype(np.float32)).double(), sw]


@pytest.mark.parametrize("kernel", ["flash_rel_attention", "hifigan_stage"])
def test_split_tf32_keeps_f32_accuracy(monkeypatch, kernel):
    """Why K1 and K2 multiply in split TF32: with every product of the plain
    version formed from TF32 operands (emulated in f64), single TF32 misses
    the kernels' tolerances against f64 and split TF32 stays inside them."""
    import toucan_tpu_torch.kernels.resstack as resstack
    from toucan_tpu_torch.kernels.flash_attention import flash_rel_attention_plain

    rng = np.random.RandomState(8)
    if kernel == "flash_rel_attention":
        fn, args = flash_rel_attention_plain, _attention_case(rng)
        target, name, original = torch.Tensor, "__matmul__", torch.Tensor.__matmul__

        def within(got, want):
            return (got - want).abs().max().item() <= 2e-5
    else:
        fn, args = hifigan_stage_plain, _stage_case(rng)
        target, name, original = resstack.F, "conv1d", torch.nn.functional.conv1d

        def within(got, want):
            return ((got - want).abs() - 2e-3 * want.abs()).max().item() <= 2e-4
    want = fn(*args)
    errors = {}
    for split in (False, True):
        product = _tf32_products(split)
        if kernel == "flash_rel_attention":
            emulated = lambda a, b: product(original, a, b)  # noqa: E731
        else:  # the bias is added once, outside the products
            emulated = lambda a, w, bias, **kw: product(  # noqa: E731
                lambda x, y: original(x, y, **kw), a, w) + bias[:, None]
        monkeypatch.setattr(target, name, emulated)
        got = fn(*args)
        monkeypatch.undo()
        errors[split] = within(got, want)
    assert errors == {False: False, True: True}


def test_weight_split_is_two_tf32_parts():
    """The K2 wrapper's weight copy: big and small are TF32 values, big is
    the TF32 rounding of w, and big + small is w to 2^-22 relative."""
    from toucan_tpu_torch.kernels.resstack import split_tf32

    w = torch.from_numpy(np.random.RandomState(9).randn(4096).astype(np.float32))
    pairs = split_tf32(w)
    big, small = pairs[..., 0], pairs[..., 1]
    assert pairs.shape == (4096, 2) and pairs.is_contiguous()
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(big, _tf32(w))
    assert ((big.double() + small.double() - w.double()).abs()
            <= 2.0 ** -22 * w.double().abs()).all()


# clusters of 8, 4, 2 and 1 blocks the H100 runs at once with K2's shared
# memory, as cudaOccupancyMaxActiveClusters reports them (chip_smoke.py)
H100_CLUSTERS = ((8, 15), (4, 30), (2, 66), (1, 132))
HIFIGAN_STAGES = ((8, 256), (48, 128), (192, 64), (384, 32))  # (samples a frame, C)


@pytest.mark.parametrize("clusters_in_flight", [None, H100_CLUSTERS], ids=["n_sm", "h100"])
@pytest.mark.parametrize("frames,b", [(512, 1), (896, 1), (2048, 1), (512, 4), (896, 4),
                                      (1024, 4), (2048, 4)])
def test_stage_tiling_fills_the_card(frames, b, clusters_in_flight):
    """At every stage shape of the main path (HiFiGAN, 512 channels: stage
    i has 256 / 2^i channels and 8, 48, 192, 384 samples per frame) on 132
    SMs: enough tiles for every cluster slot the card has but fewer than B
    (a sample's tiles are a whole number, so 30 slots take 7 tiles each of
    4 samples), or one tile covering T; the halo of the widest stack; each
    block 128, 64 or 32 channels of a cluster of at most 8; the streams
    under the L2 budget."""
    from toucan_tpu_torch.kernels.resstack import L2_SCRATCH_BYTES, MAX_CLUSTER, stage_tiling

    ks, dil, n_sm = (3, 7, 11), (1, 3, 5), 132
    slots = dict(clusters_in_flight or ())
    for scale, c in HIFIGAN_STAGES:
        t = scale * frames
        tl = stage_tiling(b, t, c, n_sm, ks, dil, clusters_in_flight)
        assert tl.halo >= stage_halo(ks, dil) == 60
        assert tl.cluster * tl.block_channels == c and tl.cluster <= MAX_CLUSTER
        assert tl.block_channels in (128, 64, 32)
        assert tl.jobs == b * -(-t // tl.tile)
        assert tl.jobs > slots.get(tl.cluster, n_sm // tl.cluster) - b or tl.tile >= t
        assert tl.clusters == min(tl.jobs, slots.get(tl.cluster, n_sm // tl.cluster))
        assert tl.scratch_bytes(c) <= L2_SCRATCH_BYTES


def test_wrappers_refuse_misaligned_views():
    """K1 and K2 move their inputs with 16-byte accesses, which fault on the
    card at a misaligned address: a contiguous view that does not start on
    a 16-byte boundary raises ValueError before any launch (the checks run
    here on CPU tensors, as the wrappers run them on CUDA tensors)."""
    from toucan_tpu_torch.kernels import flash_attention, resstack

    (q_u, q_v, k, v), p, lens = _attention_inputs(8, (8, 3))
    args = [torch.from_numpy(a) for a in (q_u, q_v, k, v, p, lens)]
    flash_attention._check(*args)
    shifted = torch.zeros(args[2].numel() + 1)[1:].view(args[2].shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="k must start on a 16-byte boundary"):
        flash_attention._check(args[0], args[1], shifted, *args[3:])

    sw = _stage_weights(np.random.RandomState(0), 32, (3, 7, 11), (1, 3, 5))
    x = torch.zeros(1, 16, 32)
    resstack._check(x, sw)
    with pytest.raises(ValueError, match="x must start on a 16-byte boundary"):
        resstack._check(torch.zeros(x.numel() + 2)[2:].view(x.shape), sw)
    assert flash_rel_attention.launches == 0 and hifigan_stage.launches == 0


def test_stage_tiling_takes_clusters_of_at_most_four():
    """The cluster limit: C = 256 takes 2 blocks of 128 channels, 4 of 64
    or 8 of 32; C = 512 (a 1024-channel generator's stage 0) 4 of 128 or 8
    of 64, Hopper's portable cluster size and the kernel's limit; C = 1024
    raises rather than pick a cluster the kernel rejects.  (Named for the
    limit of 4 it pinned before K2 took clusters of 8.)"""
    from toucan_tpu_torch.kernels.resstack import MAX_CLUSTER, stage_tiling

    tl = stage_tiling(1, 4096, 256, 132, (3, 7, 11), (1, 3, 5))
    assert (tl.cluster, tl.block_channels) in ((2, 128), (4, 64), (8, 32))
    tl = stage_tiling(1, 4096, 512, 132, (3, 7, 11), (1, 3, 5))
    assert (tl.cluster, tl.block_channels) in ((4, 128), (MAX_CLUSTER, 64)) and MAX_CLUSTER == 8
    with pytest.raises(ValueError, match="channels, got 1024"):
        stage_tiling(1, 4096, 1024, 132, (3, 7, 11), (1, 3, 5))


@pytest.mark.parametrize("c", [4, 8, 16, 20, 32, 48, 96, 160, 192, 256, 320, 384, 448, 512])
def test_stage_tiling_takes_every_width(c):
    """Every C up to 512 gets a tiling at the kernel's width (C rounded up
    to a multiple of 32 up to 128, of 64 past it): blocks of 128, 64 or 32
    channels, clusters of at most 8, at the 512-frame shape of a stage that
    wide and at 64 frames."""
    from toucan_tpu_torch.kernels.resstack import MAX_CLUSTER, kernel_channels, stage_tiling

    wide = kernel_channels(c)
    assert wide % 32 == 0 and c <= wide < c + (32 if c <= 128 else 64) and wide >= 32
    for t in (8 * 512 * 256 // max(c, 32), 64 * 8):
        tl = stage_tiling(1, t, c, 132, (3, 7, 11), (1, 3, 5))
        assert tl.cluster * tl.block_channels == wide and tl.cluster <= MAX_CLUSTER
        assert tl.block_channels in (128, 64, 32) and tl.jobs == -(-t // tl.tile)


@pytest.mark.parametrize("c", [32, 64, 96, 128, 192, 256, 320, 384, 448, 512])
def test_stage_block_options_by_width(c):
    """The options the chooser weighs at a kernel width: blocks of 128, 64
    or 32 channels where C divides into at most 8 of them; every width up
    to 512 has one."""
    from toucan_tpu_torch.kernels.resstack import MAX_CLUSTER, _block_options

    options = _block_options(c, 11, 5)
    want = [(nb, c // nb) for nb in (128, 64, 32) if c % nb == 0 and c // nb <= MAX_CLUSTER]
    assert options == want and options


@pytest.mark.parametrize("frames,stage,variant,cluster,tile,jobs", [
    (448, 0, "nb128", 2, 55, 66), (448, 1, "nb128", 1, 163, 132), (448, 2, "nb64", 1, 652, 132),
    (448, 3, "nb32", 1, 1304, 132), (2048, 0, "nb128", 2, 249, 66), (2048, 1, "nb128", 1, 373, 264),
    (2048, 2, "nb64", 1, 745, 528), (2048, 3, "nb32", 1, 1490, 528)])
def test_stage_tiling_variant_and_tile_by_shape(frames, stage, variant, cluster, tile, jobs):
    """The variant, cluster and tile the chooser takes at the served shapes
    (the interactive cells' typical 448-frame bucket and 2048 frames) on
    the H100's clusters in flight: the widest block a stage's channels
    allow (blocks of 32 and 64 only at C = 32 and 64, whose wgmmas cannot
    be wider), one wave of clusters that fills the card where the streams
    fit the scratch budget, else the tile halved and the waves doubled."""
    from toucan_tpu_torch.kernels.resstack import L2_SCRATCH_BYTES, stage_tiling

    scale, c = HIFIGAN_STAGES[stage]
    tl = stage_tiling(1, scale * frames, c, 132, (3, 7, 11), (1, 3, 5), H100_CLUSTERS)
    assert (tl.variant, tl.cluster, tl.tile, tl.jobs) == (variant, cluster, tile, jobs)
    assert tl.clusters == min(jobs, dict(H100_CLUSTERS)[cluster])
    assert tl.scratch_bytes(c) <= L2_SCRATCH_BYTES


@pytest.mark.parametrize("nb,k_max,d_max,fits", [
    (128, 11, 5, True), (64, 11, 5, True), (32, 11, 5, True), (128, 3, 1, True),
    (128, 11, 13, True), (128, 11, 14, False), (64, 11, 31, True), (64, 11, 32, False),
    (32, 11, 51, True), (32, 11, 52, False)])
def test_stage_shared_memory_budget(nb, k_max, d_max, fits):
    """K2's shared memory (2 weight slots of k_max x 4 x NB x 16 bytes at NB
    = 128, else 3; 2 window slots a warpgroup of 4 x (its half of the M
    tile + (k_max - 1) d_max) x 16 bytes; two mbarriers a weight slot):
    HiFiGAN's kernel sizes and dilations fit a block's 227 KB in every
    variant (209, 164 and 113 KB at k = 11, d = 5); an option that does
    not fit is not offered, and a stage no option fits raises."""
    from toucan_tpu_torch.kernels.resstack import (SMEM_BYTES, _block_options, rows_per_pass,
                                                   stage_smem_bytes, stage_tiling, weight_slots)

    span = rows_per_pass(nb) // 2 + (k_max - 1) * d_max
    assert rows_per_pass(nb) == (256 if nb == 32 else 128)
    assert weight_slots(nb) == (2 if nb == 128 else 3)
    assert stage_smem_bytes(nb, k_max, d_max) == \
        weight_slots(nb) * (k_max * 4 * nb * 16 + 16) + 4 * 4 * span * 16
    assert (stage_smem_bytes(nb, k_max, d_max) <= SMEM_BYTES) == fits
    assert ((nb, 128 // nb) in _block_options(128, k_max, d_max)) == fits
    if not fits and nb == 32:
        with pytest.raises(ValueError, match="shared memory"):
            stage_tiling(1, 4096, 128, 132, (3, 7, k_max), (1, 3, d_max))


@pytest.mark.parametrize("nb", [128, 64, 32])
def test_stage_packed_weights_layout(nb):
    """The kernel's weight copy for blocks of NB channels: each conv's TF32
    (big, small) pairs at [r, s, tap, big/small, h, n, e] for input channel
    8 s + 4 h + e and output channel r NB + n, conv after conv, so one
    block's step of 8 input channels is one contiguous run."""
    from toucan_tpu_torch.kernels.resstack import pack_split_weights, split_tf32

    rng = np.random.RandomState(11)
    c, ks, dil = 128, (3, 7, 11), (1, 3, 5)
    sw = _stage_weights(rng, c, ks, dil)
    packed = pack_split_weights(sw, nb)
    assert packed.shape == (2 * sw.w.numel(),) and packed.is_contiguous()
    off = 0
    for conv, (w, _, _) in enumerate(sw.conv_weights()):
        k = w.shape[-1]
        pairs = split_tf32(w.permute(2, 1, 0).contiguous())   # (tap, C_in, C_out, 2)
        idx = np.random.RandomState(conv).randint(0, [k, c, c, 2], size=(16, 4))
        for tap, ci, co, part in idx:
            r, n = divmod(co, nb)
            s, h, e = ci // 8, ci % 8 // 4, ci % 4
            at = off + (((((r * (c // 8) + s) * k + tap) * 2 + part) * 2 + h) * nb + n) * 4 + e
            assert packed[at] == pairs[tap, ci, co, part]
        off += 2 * k * c * c
    assert off == packed.numel()


@pytest.mark.parametrize("t,tile,want", [(3584, 120, 1.3674), (3584, 224, 1.1959),
                                         (4096, 4096, 1.0107), (100, 7, 7.5833)])
def test_stage_rows_computed_share(t, tile, want):
    """Rows the convs compute over the rows they deliver, weighted by taps:
    stage 0 at 448 frames cut into 30 tiles of 120 rows recomputes x1.37 of
    its rows (the parent's tiling there), into 16 of 224 x1.20; one tile
    over T only its sequence edges; a ragged last tile counts its own rows."""
    from toucan_tpu_torch.kernels.resstack import rows_computed_share

    assert rows_computed_share(1, t, tile, (3, 7, 11), (1, 3, 5)) == pytest.approx(want, abs=1e-4)


def test_stage_variants_count_with_launches(monkeypatch):
    """``hifigan_stage.variants`` counts each launch under the kernel instance
    it took, as ``build.count_launch`` counts the wrapper: at once outside a
    capture, at each replay of a captured graph."""
    from toucan_tpu_torch.kernels import build, resstack

    monkeypatch.setattr(resstack.hifigan_stage, "variants", {})
    build.count_launch(resstack._VARIANTS["nb64"])
    assert resstack.hifigan_stage.variants == {"nb64": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with build.CaptureTally() as tally:
        build.count_launch(resstack._VARIANTS["nb32"])
        build.count_launch(resstack._VARIANTS["nb32"])
    tally.replayed()
    assert resstack.hifigan_stage.variants == {"nb64": 1, "nb32": 2}
    assert set(resstack._VARIANTS) == {f"nb{nb}" for nb in resstack.BLOCK_CHANNELS}


def test_stage_kernel_name_is_what_the_roofline_reads():
    """``k2_roofline_pct`` finds K2's launches in the device trace by the name
    ``stage_kernel``: the kernel the wrapper launches still has it (each
    template instance), and K3's ``stage_q_kernel`` does not match."""
    import re
    from pathlib import Path

    from bench_h100.metrics.k2_roofline_pct import PATTERN
    from toucan_tpu_torch.kernels import build

    names = {}
    for src in ("hifigan_stage", "hifigan_stage_q"):
        text = (Path(build.SRC_DIR) / f"{src}.cu").read_text()
        names[src] = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                text)
        launched = re.findall(r"cudaLaunchKernelEx\([^,]+,\s*(\w+)", text) + \
            re.findall(r"(\w+)(?:<[^>]*>)?<<<", text)
        assert launched and set(launched) <= set(names[src]), (src, launched)
    assert names["hifigan_stage"] == ["stage_kernel"]
    for nb in (64, 32):
        traced = f"void (anonymous namespace)::stage_kernel<{nb}>(float const*, float const*, " \
                 "float const*, float*, float*, (anonymous namespace)::StageArgs)"
        assert re.search(PATTERN, traced)
    for name in names["hifigan_stage_q"]:
        assert not re.search(PATTERN, f"void (anonymous namespace)::{name}<1>(int)")


def _sequential_conv1d(x, w, b, padding=0, dilation=1):
    """conv1d summed in one fixed order, input channel by input channel and
    tap by tap, as K2 walks them: added zero channels come last and add
    exact zeros.  (The CPU library's convs block 48 and 64 channels
    differently, which moves the last bit.)"""
    k = w.shape[-1]
    xp = torch.nn.functional.pad(x, (padding, padding))
    t = xp.shape[-1] - dilation * (k - 1)
    out = b[None, :, None].expand(x.shape[0], -1, t).clone()
    for ci in range(x.shape[1]):
        for tap in range(k):
            out += w[None, :, ci, tap, None] * xp[:, ci, None, tap * dilation:tap * dilation + t]
    return out


@pytest.mark.parametrize("c", [4, 16, 48])
def test_widened_stage_is_exact(monkeypatch, c):
    """A stage widened with zero channels to the kernel's width gives, in
    its first C channels, the unwidened stage bit for bit, and zeros in the
    others (unit-gain weights, HiFiGAN's kernel sizes and dilations)."""
    from toucan_tpu_torch.kernels import resstack
    from toucan_tpu_torch.kernels.resstack import kernel_channels, widened

    rng = np.random.RandomState(10 + c)
    ks, dil = (3, 7, 11), (1, 3, 5)
    convs = [(torch.from_numpy((rng.randn(c, c, k) / np.sqrt(k * c)).astype(np.float32)),
              torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)))
             for k in ks for _ in range(6)]
    sw = pack_stage(convs, c, ks, dil)
    x = torch.from_numpy(rng.randn(1, 40, c).astype(np.float32))
    wide = kernel_channels(c)
    monkeypatch.setattr(resstack.F, "conv1d", _sequential_conv1d)
    want = hifigan_stage_plain(x, sw)
    got = hifigan_stage_plain(torch.nn.functional.pad(x, (0, wide - c)), widened(sw, wide))
    monkeypatch.undo()
    assert got.shape == (1, 40, wide)
    assert torch.equal(got[..., :c], want)
    assert not got[..., c:].any()
    assert hifigan_stage.launches == 0


@pytest.mark.parametrize("d", [8, 40, 96, 128])
def test_padded_head_dims_match_unpadded(d):
    """K1 takes any head dim up to 128 zero-padded to the next width it is
    built for, with the softmax scale of the true d: on the plain version
    the padded call gives the unpadded output, and zeros in the padding."""
    from toucan_tpu_torch.kernels.flash_attention import (BUILT_HEAD_DIMS,
                                                          flash_rel_attention_plain,
                                                          padded_inputs)

    (q_u, q_v, k, v), p, lens = _attention_inputs(40, (40, 23), d=d, seed=d)
    args = [torch.from_numpy(a) for a in (q_u, q_v, k, v, p)]
    padded = padded_inputs(*args)
    width = padded[0].shape[-1]
    assert width == min(w for w in BUILT_HEAD_DIMS if w >= d)
    assert all(a.shape[:-1] == b.shape[:-1] and b.shape[-1] == width
               for a, b in zip(args, padded))
    lengths = torch.from_numpy(lens)
    want = flash_rel_attention_plain(*args, lengths)
    got = flash_rel_attention_plain(*padded, lengths, scale=1.0 / np.sqrt(d))
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(), atol=2e-6)
    assert not got[..., d:].any()
    assert flash_rel_attention(*args, lengths).shape == want.shape


def test_head_dim_past_128_raises():
    """d > 128 raises ValueError before any launch (the checks run here on
    CPU tensors, as the wrapper runs them on CUDA tensors)."""
    from toucan_tpu_torch.kernels import flash_attention

    (q_u, q_v, k, v), p, lens = _attention_inputs(8, (8, 3), d=136)
    args = [torch.from_numpy(a) for a in (q_u, q_v, k, v, p, lens)]
    with pytest.raises(ValueError, match="head dim 136 > 128"):
        flash_attention._check(*args)
    assert flash_rel_attention.launches == 0
