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
                                               pack_stage)
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
