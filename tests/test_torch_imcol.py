"""The port's im2col HiFiGAN stage (K4) against the JAX package's, on the CPU.

``kernels/imcol.py::imcol_stage`` runs its plain version here; it is held
against the JAX ``fused_imcol_resstacks`` in interpret mode on the same
inputs, made as ``tests/test_pallas_imcol.py`` makes them, with T not a
multiple of the tile: int8 within 1e-5 of max|y| (the same int8 weights,
the same per-window scales, exact integer sums; only f32 rounding of the
dequant chain can differ, see ``CONTRACTED``), bf16 within 1e-2 of max|y|
(f32 sums of bf16 products in another order, amplified through 18 convs of
gain ~3).

Through the generator the conv kernels are scaled by 0.5: an int8 stage
turns any f32 difference upstream (the transposed convs sum in another
order) into rounding flips, and at the seeded unit gain those flips put the
port's int8 wave 5.6e-3 to 7e-3 from JAX's, as far as a wiring error would.  At 0.5
the port's int8 wave is within 1e-6 of JAX's, while running K2 at a stage
JAX gives K4 misses by 3e-4; bf16 is within 1e-3 of the peak (3.4e-5 of
9.3e-2 measured, K2 in its place misses by 1.6e-4).  The unit gain is held
to a bound from the quantization noise itself
(``test_generator_imcol_unit_gain``).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from toucan_tpu.kernels.folded_conv import fold_time, unfold_time
from toucan_tpu.kernels.pallas_imcol import (build_imcol_weight, fused_imcol_resstacks,
                                             quantize_weight, stage_conv_specs)
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu.models.vocoders.hifigan import calibrate_act_scales as jax_calibrate_act
from toucan_tpu_torch.kernels import imcol as imcol_module
from toucan_tpu_torch.kernels.imcol import (imcol_fold, imcol_halo, imcol_stage,
                                            imcol_stage_plain, prepare_imcol_stage)
from toucan_tpu_torch.models.vocoders import hifigan as hifigan_mod
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator, calibrate_act_scales
from toucan_tpu_torch.weights import hifigan_from_jax

from test_torch_kernels import _stage_weights
from test_torch_modules import seeded_variables
from test_torch_quantized_vocoder import _gain

torch.set_num_threads(2)

KS, DIL = (3, 7, 11), (1, 3, 5)
CASES = [(1, 16, 200), (2, 16, 240), (4, 8, 400), (2, 48, 240)]   # (fold, C, T), tile 32


def _params(rng, c):
    """Stack params as ``tests/test_pallas_imcol.py::make_params`` makes them."""
    return [[tuple(a.astype(np.float32) for a in (
        0.3 * rng.randn(k, c, c), 0.1 * rng.randn(c), 0.3 * rng.randn(k, c, c), 0.1 * rng.randn(c)))
        for _ in DIL] for k in KS]


# XLA on the CPU contracts JAX's int8 dequant chain ``y * scale + b`` into
# one FMA; the port's plain version and its CUDA kernel round twice, as the
# JAX source reads.  At C = 48 and these weights (a stream up to 1.2e4) the
# one-rounding differences flip int8 roundings downstream: the port misses
# JAX by 3.2e-3 of the peak (1 830 of 23 040 elements over 1e-5), a tenth of
# JAX's own int8 noise, while its chain rounded once (``_fused``) meets JAX
# within 2e-7.  The narrower cases stay within 1e-5 either way.
CONTRACTED = {(2, 48, 240)}


def _fused(s, f, b):
    """s * f + b rounded once, as an FMA rounds it: the product is exact in
    float64 and the sum rounds there, then to f32."""
    return (s.double() * f.double() + b.double()).float()


@functools.lru_cache(maxsize=None)
def _case(fold, c, t):
    rng = np.random.RandomState(2)
    x = rng.randn(2, t, c).astype(np.float32)
    params = _params(rng, c)
    return x, params, _stage_weights(rng, c, KS, DIL, params)


@functools.lru_cache(maxsize=None)
def _jax_stage(fold, c, t, mode, dense=False):
    x, params, _ = _case(fold, c, t)
    fn = jax.jit(lambda xx, p: unfold_time(fused_imcol_resstacks(
        fold_time(xx, fold), p, fold, tile=32, mode=mode, dense=dense, interpret=True), fold))
    return np.asarray(fn(jnp.asarray(x), params))


def _snr(got, want):
    return 10 * np.log10((want ** 2).mean() / ((got - want) ** 2).mean())


def _port_stage(fold, c, t, mode):
    x, _, sw = _case(fold, c, t)
    return imcol_stage(torch.from_numpy(x), prepare_imcol_stage(sw, mode), fold, tile=32).numpy()


@pytest.mark.parametrize("fold", [1, 2, 4, 8, 16, 32])
def test_halo_is_the_pallas_kernels(fold):
    assert imcol_halo(KS, DIL, fold) == stage_conv_specs(KS, DIL, fold)[1]
    assert imcol_halo(KS, DIL, fold) == stage_conv_specs(KS, DIL, fold, dense=True)[1]


@pytest.mark.parametrize("fold,c,t", CASES)
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_k4_plain_matches_pallas_interpret(fold, c, t, mode, monkeypatch):
    want = _jax_stage(fold, c, t, mode)
    got = _port_stage(fold, c, t, mode)
    peak = np.abs(want).max()
    assert got.shape == want.shape and peak > 1
    if mode == "int8" and (fold, c, t) in CONTRACTED:
        exact = _jax_stage(fold, c, t, "f32")
        assert np.abs(got - want).max() <= np.abs(want - exact).max() / 10
        monkeypatch.setattr(imcol_module, "_dequant", _fused)
        got = _port_stage(fold, c, t, mode)
    assert np.abs(got - want).max() <= (1e-5 if mode == "int8" else 1e-2) * peak
    assert imcol_stage.launches == 0


def test_k4_windows_are_circular(monkeypatch):
    """The fold-1 int8 case with zero-padded instead of circular windows
    misses the Pallas kernel by about 17 of 700: the rows the kernel's roll
    wraps around enter the next conv's scale."""
    fold, c, t = CASES[0]
    want = _jax_stage(fold, c, t, "int8")
    peak = np.abs(want).max()
    assert np.abs(_port_stage(fold, c, t, "int8") - want).max() <= 1e-5 * peak
    pad = F.pad
    monkeypatch.setattr(F, "pad", lambda x, p, mode="constant": pad(x, p))
    assert np.abs(_port_stage(fold, c, t, "int8") - want).max() > 1e-2 * peak


def test_dense_weights_give_the_same_stage():
    """JAX's dense folded weights (``imcol_dense``) and its sparse im2col
    weights both agree with the port's one int8 stage."""
    fold, c, t = CASES[1]
    got = _port_stage(fold, c, t, "int8")
    for dense in (False, True):
        want = _jax_stage(fold, c, t, "int8", dense)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fold,conv", [(1, 0), (2, 9), (4, 16)])
def test_int8_weights_equal_pallas_quantize_weight(fold, conv):
    """The port's per-output-channel int8 weights, placed by JAX's im2col
    index map, are JAX's quantized im2col weights; its scales are JAX's
    column scales."""
    x, params, sw = _case(*CASES[0])
    st = prepare_imcol_stage(sw, "int8")
    w8, d = list(st.conv_weights())[conv]
    stack, rnd, half = conv // 6, conv % 6 // 2, conv % 2
    w = params[stack][rnd][2 * half]
    want_w8, want_scale = quantize_weight(build_imcol_weight(jnp.asarray(w), fold, d))
    got_w8 = build_imcol_weight(jnp.asarray(w8.numpy().transpose(2, 1, 0)), fold, d)
    np.testing.assert_array_equal(np.asarray(got_w8), np.asarray(want_w8, np.float32))
    np.testing.assert_array_equal(np.tile(st.scale[conv].numpy(), fold), np.asarray(want_scale))


def test_imcol_stage_raises_off_cpu_and_cuda():
    x, _, sw = _case(*CASES[0])
    st = prepare_imcol_stage(sw, "int8")
    with pytest.raises(ValueError, match="cuda or cpu"):
        imcol_stage(torch.zeros(1, 32, 16, device="meta"), st, 1)
    with pytest.raises(ValueError, match="multiple of the fold"):
        imcol_stage(torch.zeros(1, 30, 16), st, 4)
    with pytest.raises(ValueError, match="mode"):
        prepare_imcol_stage(sw, "f32")
    with pytest.raises(ValueError, match="imcol_mode"):
        HiFiGANGenerator(channels=64, imcol_mode="")
    assert imcol_stage.launches == 0


def test_stage_routing(monkeypatch):
    """stage_mode int8/bf16 wins over imcol_mode (K3 everywhere); otherwise
    the stages in imcol_stages with at most 128 channels run K4 at the JAX
    generator's fold, the rest K2; imcol_mode "f32" is K2."""
    calls = []
    for name in ("hifigan_stage", "quantized_stage", "imcol_stage"):
        real = getattr(hifigan_mod, name)
        monkeypatch.setattr(hifigan_mod, name, functools.partial(
            lambda real, name, x, *a: calls.append((name, x.shape[-1], a[1:])) or real(x, *a),
            real, name))
    mel = torch.zeros(1, 2, 80)
    full = HiFiGANGenerator(imcol_mode="int8")
    assert [full.runs_imcol(i) for i in range(4)] == [False, True, True, True]
    assert [imcol_fold(c) for c in (256, 128, 64, 32)] == [1, 1, 2, 4]
    for kw, want in [
            (dict(imcol_mode="int8"), ["hifigan_stage"] + ["imcol_stage"] * 3),
            (dict(imcol_mode="bf16", imcol_stages=(0, 2)),
             ["imcol_stage", "hifigan_stage", "imcol_stage", "hifigan_stage"]),
            (dict(imcol_mode="f32"), ["hifigan_stage"] * 4),
            (dict(imcol_mode="int8", stage_mode="bf16"), ["quantized_stage"] * 4)]:
        calls.clear()
        HiFiGANGenerator(channels=64, **kw)(mel)
        assert [c[0] for c in calls] == want, kw
        assert all(a == (imcol_fold(c),) for n, c, a in calls if n == "imcol_stage")


@pytest.fixture(scope="module")
def voc_vars():
    return _gain(seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                  jnp.zeros((1, 16, 80))), 0.5)


def _port_generator(voc_vars, **kw):
    gen = HiFiGANGenerator(channels=64, **kw)
    gen.load_state_dict(hifigan_from_jax(voc_vars))
    return gen.eval()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_generator_imcol_matches_jax(voc_vars, mode):
    mel = np.random.RandomState(5).randn(1, 8, 80).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, m: JaxHiFiGAN(channels=64, imcol_mode=mode).apply(v, m))(
        voc_vars, mel))[..., 0]
    got = _port_generator(voc_vars, imcol_mode=mode)(torch.from_numpy(mel))[..., 0].numpy()
    assert got.shape == want.shape == (1, 8 * 384)
    assert np.abs(got - want).max() <= (1e-6 if mode == "int8" else 1e-3 * np.abs(want).max())


def test_generator_imcol_unit_gain():
    """At the seeded unit gain, where upstream f32 order flips int8
    roundings, the port's int8 wave departs from JAX's by less than JAX's
    int8 wave departs from its exact one (max error and SNR), and from the
    port's exact wave with an SNR above 25 dB (``tests/test_pallas_stage.py``'s
    bound)."""
    voc = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                           jnp.zeros((1, 16, 80)))
    mel = np.random.RandomState(5).randn(1, 8, 80).astype(np.float32)
    want, jax_exact = (np.asarray(jax.jit(lambda v, m: JaxHiFiGAN(
        channels=64, imcol_mode=mode).apply(v, m))(voc, mel))[..., 0] for mode in ("int8", ""))
    gen = _port_generator(voc, imcol_mode="int8")
    got = gen(torch.from_numpy(mel))[..., 0].numpy()
    gen.imcol_mode = None
    exact = gen(torch.from_numpy(mel))[..., 0].numpy()
    assert np.abs(got - want).max() <= np.abs(want - jax_exact).max()
    assert _snr(got, want) > _snr(want, jax_exact)
    assert _snr(got, exact) > 25


@pytest.mark.parametrize("dense", [False, True])
def test_calibration_with_imcol_matches_jax(voc_vars, dense):
    """JAX's calibration pass runs the im2col stages (it clears only
    stage_mode); the port's records each stage's input the same way."""
    mel = np.random.RandomState(5).randn(1, 8, 80).astype(np.float32)
    want = jax.jit(lambda v, m: jax_calibrate_act(
        JaxHiFiGAN(channels=64, imcol_mode="int8", imcol_dense=dense), v, m))(voc_vars, mel)
    got = calibrate_act_scales(_port_generator(voc_vars, imcol_mode="int8", imcol_dense=dense),
                               torch.from_numpy(mel))
    assert set(got) == set(want) == {0, 1, 2, 3}
    for i in got:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)
