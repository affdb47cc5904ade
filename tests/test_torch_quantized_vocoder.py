"""The port's quantized HiFiGAN serving (K3) against the JAX package's, on the CPU.

``kernels/stage.py::quantized_stage`` runs its plain version here; it is
held against the JAX ``fused_stage_resstacks`` in interpret mode on the
same activation scales.  int8: within 1e-3 of max|out| (the two take the
same int8 weights and exact integer sums; a requantization that lands on
the other side of a rounding boundary, from f32 sums of another order
upstream, moves one element by a quantum); bf16: within 1e-2 of max|out|
(f32 sums of bf16 products in another order, rounded to bf16 at every
round).  Both modes hold against the exact f32 stage at the JAX package's
own bounds (``tests/test_pallas_stage.py``): max error under 6 % of
max|out| and SNR above 25 dB.  Calibration agrees with JAX at rtol 1e-5.
Through the interfaces: scales at rtol 1e-5, the int8 wave within 1e-2 of
JAX's and within 0.05 of the exact path (see ``_gain`` for the weights).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.kernels.folded_conv import fold_time, unfold_time
from toucan_tpu.kernels.pallas_stage import calibrate_stage_scales as jax_calibrate
from toucan_tpu.kernels.pallas_stage import fused_stage_resstacks
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu.models.vocoders.hifigan import calibrate_act_scales as jax_calibrate_act
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.kernels.resstack import hifigan_stage_plain, stage_halo
from toucan_tpu_torch.kernels.stage import (MIN_TILE, SMEM_LIMIT, _smem_bytes,
                                            calibrate_stage_scales, quantize_stage,
                                            quantized_stage, stage_tiling)
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders import hifigan as hifigan_mod
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator, calibrate_act_scales
from toucan_tpu_torch.weights import hifigan_from_jax, toucan_tts_from_jax

from test_torch_interface import TINY
from test_torch_kernels import _stage_weights
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

KS, DIL = (3, 7, 11), (1, 3, 5)


def _params(rng, c, scale=0.3):
    """Stack params as ``tests/test_pallas_stage.py`` makes them."""
    return [[tuple(a.astype(np.float32) for a in (
        rng.randn(k, c, c) * scale / np.sqrt(k * c), rng.randn(c) * 0.01,
        rng.randn(k, c, c) * scale / np.sqrt(k * c), rng.randn(c) * 0.01))
        for _ in DIL] for k in KS]


def _case(fold, c, t, seed=0):
    rng = np.random.RandomState(seed)
    params = _params(rng, c)
    x_f = rng.randn(2, t, fold * c).astype(np.float32)
    return params, x_f, np.asarray(unfold_time(jnp.asarray(x_f), fold)), \
        _stage_weights(rng, c, KS, DIL, params)


def _snr(got, want):
    return 10 * np.log10((want ** 2).mean() / ((got - want) ** 2).mean())


@pytest.mark.parametrize("fold,c", [(2, 64), (4, 32), (1, 128)])
@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_k3_plain_matches_pallas_interpret(fold, c, t, mode):
    params, x_f, x, sw = _case(fold, c, t)
    jparams = [[tuple(map(jnp.asarray, conv)) for conv in stack] for stack in params]
    scales = np.asarray(jax_calibrate(jnp.asarray(x_f), jparams, fold, KS, DIL))
    want = np.asarray(unfold_time(fused_stage_resstacks(
        jnp.asarray(x_f), jparams, fold, KS, DIL,
        act_scales=jnp.asarray(scales) if mode == "int8" else None, tile=128, mode=mode,
        interpret=True), fold))
    got = quantized_stage(torch.from_numpy(x), sw, mode, torch.from_numpy(scales)).numpy()
    peak = np.abs(want).max()
    err = np.abs(got - want)
    differ = int((err > 0).sum())
    bound = (1e-3 if mode == "int8" else 1e-2) * peak
    assert err.max() <= bound, (err.max(), bound, f"{differ} of {err.size} elements differ")
    exact = hifigan_stage_plain(torch.from_numpy(x), sw).numpy()
    assert np.abs(got - exact).max() / np.abs(exact).max() < 0.06
    assert _snr(got, exact) > 25
    assert quantized_stage.launches == 0


@pytest.mark.parametrize("fold,c", [(2, 64), (1, 128)])
def test_calibrate_stage_scales_matches_jax(fold, c):
    params, x_f, x, sw = _case(fold, c, 256, seed=1)
    jparams = [[tuple(map(jnp.asarray, conv)) for conv in stack] for stack in params]
    want = np.asarray(jax_calibrate(jnp.asarray(x_f), jparams, fold, KS, DIL))
    got = calibrate_stage_scales(torch.from_numpy(x), sw).numpy()
    assert got.shape == (18,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_int8_without_scales_raises():
    _, _, x, sw = _case(2, 64, 64)
    with pytest.raises(ValueError, match="act_scales"):
        quantized_stage(torch.from_numpy(x), sw, "int8")
    with pytest.raises(ValueError, match="mode"):
        quantize_stage(sw, "int4")
    gen = HiFiGANGenerator(channels=64, stage_mode="int8")
    with pytest.raises(ValueError, match="act_scales"):
        gen(torch.zeros(1, 4, 80))


def test_quantized_stage_raises_off_cpu_and_cuda():
    _, _, _, sw = _case(2, 64, 64)
    with pytest.raises(ValueError, match="cuda or cpu"):
        quantized_stage(torch.zeros(1, 16, 64, device="meta"), sw, "bf16")
    assert quantized_stage.launches == 0


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_stage_tiles_fit_shared_memory(mode):
    """The tile the CUDA wrapper picks for each HiFiGAN stage shape (512 and
    2048 mel frames, B = 1 and 4) fits the card's shared memory, and a short
    stage takes the smallest tiles."""
    halo = stage_halo(KS, DIL)
    for frames in (512, 2048):
        for b in (1, 4):
            for scale, c in ((8, 256), (48, 128), (192, 64), (384, 32)):
                tl = stage_tiling(mode, b, scale * frames, c, 132, KS, DIL)
                assert _smem_bytes(mode, c, tl.tile, halo, KS[-1]) <= tl.smem <= SMEM_LIMIT
    tl = stage_tiling(mode, 1, 40, 256, 132, KS, DIL)
    assert (tl.tile, tl.n_tiles) == (MIN_TILE, 40 // MIN_TILE)


def test_int8_weights_are_the_folded_column_quantization():
    """The port's per-output-channel int8 weights equal the JAX kernel's
    per-column quantization of the time-folded weights."""
    from toucan_tpu.kernels.folded_conv import fold_conv_kernel
    from toucan_tpu.kernels.pallas_stage import _quantize_weight_cols

    params, _, _, sw = _case(4, 32, 64, seed=2)
    qs = quantize_stage(sw, "int8", torch.ones(18))
    w1 = params[2][2][0]   # k = 11, d = 5
    w8_f, _ = _quantize_weight_cols(fold_conv_kernel(jnp.asarray(w1), 4, 5))
    port = list(qs.conv_weights())[16][0].numpy()     # (C_out, C_in, k)
    want = np.asarray(fold_conv_kernel(jnp.asarray(port.transpose(2, 1, 0)), 4, 5))
    np.testing.assert_array_equal(np.asarray(w8_f, np.float32), want)


def test_stage_mode_f32_is_the_default_generator():
    """One name for the exact path (K2): "f32" is the default, and the JAX
    package's other name for it, "", is refused."""
    assert HiFiGANGenerator(channels=64).stage_mode == "f32"
    with pytest.raises(ValueError, match="stage_mode"):
        HiFiGANGenerator(channels=64, stage_mode="")


def _gain(tree, g):
    """Conv kernels scaled by g.  The int8 path turns any f32 difference
    upstream (conv sums in another order) into rounding flips, so two
    correct int8 runs differ by up to their quantization noise, max|int8 -
    exact|.  With the seeded unit-gain kernels that noise reaches 1.3e-2 of
    a 0.33 peak wave, above the 1e-2 bar; at 0.8 it is 2.8e-3 of 0.15.  The
    unit gain is held to a bound from the quantization noise itself
    (``test_quantize_vocoder_unit_gain``)."""
    return {k: _gain(v, g) if isinstance(v, dict) else
            (g * v).astype(np.float32) if k == "kernel" or k.endswith("_kernel") else v
            for k, v in tree.items()}


def _pair(gain):
    """The JAX interface and a maker of port interfaces on the same tiny
    seeded weights, HiFiGAN conv kernels scaled by ``gain``."""
    tts_vars = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32),
                                method=JaxToucanTTS.infer)
    voc_vars = _gain(seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                      jnp.zeros((1, 16, 80))), gain)
    emb = np.random.RandomState(2).randn(64).astype(np.float32)
    kw = dict(default_embedding=emb, language="en", use_g2p=False)
    jax_iface = JaxInterface(tts_vars, voc_vars, None, config=JaxConfig(**TINY),
                             vocoder=JaxHiFiGAN(channels=64), **kw)

    def port():
        """A fresh port interface on the same weights (quantize_vocoder
        switches its vocoder for good)."""
        return ToucanTTSInterface(toucan_tts_from_jax(tts_vars), hifigan_from_jax(voc_vars),
                                  config=ToucanTTSConfig(**TINY),
                                  vocoder=HiFiGANGenerator(channels=64), device="cpu", **kw)
    return jax_iface, port, voc_vars


@pytest.fixture(scope="module")
def pair():
    return _pair(0.8)


def test_calibrate_act_scales_matches_jax(pair):
    _, port, voc_vars = pair
    mel = np.random.RandomState(5).randn(1, 24, 80).astype(np.float32)
    want = jax.jit(lambda v, m: jax_calibrate_act(JaxHiFiGAN(channels=64), v, m))(voc_vars, mel)
    got = calibrate_act_scales(port().vocoder, torch.from_numpy(mel))
    assert set(got) == set(want) == {0, 1, 2, 3}
    for i in got:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)


def test_quantize_vocoder_matches_jax(pair):
    jax_iface, make_port, _ = pair
    port = make_port()
    mel = np.random.RandomState(6).randn(1, 24, 80).astype(np.float32)
    ipa = "~ðɪs ɪz ə tˈɛst~#"
    z = (0.8 * np.random.RandomState(3).randn(32 * 16, 80)).astype(np.float32)
    exact = port(ipa, input_is_phones=True, glow_noise=z)
    with pytest.warns(UserWarning):
        want_scales = jax_iface.quantize_vocoder(calibration_mel=mel)
    got_scales = port.quantize_vocoder(calibration_mel=mel)
    for i in want_scales:
        np.testing.assert_allclose(got_scales[i].numpy(), np.asarray(want_scales[i]), rtol=1e-5)
    assert port.vocoder.stage_mode == "int8"
    want = jax_iface(ipa, input_is_phones=True, glow_noise=z)
    got = port(ipa, input_is_phones=True, glow_noise=z)
    assert got.shape == want.shape == exact.shape and len(got) > 0
    assert np.abs(got - want).max() <= 1e-2
    assert np.abs(got - exact).max() < 0.05
    assert quantized_stage.launches == 0


def test_quantize_vocoder_unit_gain():
    """At the seeded unit gain the port's int8 wave departs from JAX's by
    less than JAX's int8 wave departs from its exact one (max error and
    SNR), and from the port's exact wave with an SNR above 25 dB
    (``tests/test_pallas_stage.py``'s bound)."""
    jax_iface, make_port, _ = _pair(1.0)
    port = make_port()
    mel = np.random.RandomState(6).randn(1, 24, 80).astype(np.float32)
    ipa = "~ðɪs ɪz ə tˈɛst~#"
    z = (0.8 * np.random.RandomState(3).randn(32 * 16, 80)).astype(np.float32)
    exact = port(ipa, input_is_phones=True, glow_noise=z)
    jax_exact = jax_iface(ipa, input_is_phones=True, glow_noise=z)
    with pytest.warns(UserWarning):
        jax_iface.quantize_vocoder(calibration_mel=mel)
    port.quantize_vocoder(calibration_mel=mel)
    want = jax_iface(ipa, input_is_phones=True, glow_noise=z)
    got = port(ipa, input_is_phones=True, glow_noise=z)
    assert got.shape == want.shape == exact.shape and len(got) > 0
    noise = np.abs(want - jax_exact).max()
    assert 0 < np.abs(got - want).max() <= noise
    assert _snr(got, want) > _snr(want, jax_exact)
    assert _snr(got, exact) > 25


def test_quantize_vocoder_default_mel_and_given_scales(pair):
    """The default calibration mel comes from the acoustic model on the
    built-in pangram; scales of an earlier calibration can be given back."""
    port = pair[1]()
    scales = port.quantize_vocoder()
    assert set(scales) == {0, 1, 2, 3}
    assert all(v.shape == (18,) and bool((v > 0).all()) for v in scales.values())
    again = port.quantize_vocoder(act_scales={i: v.numpy() for i, v in scales.items()})
    assert all(torch.equal(again[i], scales[i]) for i in scales)
    wave = port("~hɛlˈoʊ wˈɜːld~#", input_is_phones=True)
    assert len(wave) > 0 and np.isfinite(wave).all()


def test_quantize_vocoder_rejects_bigvgan(pair):
    iface = ToucanTTSInterface(pair[1]().model.state_dict(), BigVGAN(channels=64).state_dict(),
                               config=ToucanTTSConfig(**TINY), vocoder=BigVGAN(channels=64),
                               use_g2p=False, device="cpu")
    with pytest.raises(ValueError, match="HiFiGAN"):
        iface.quantize_vocoder(calibration_mel=np.zeros((1, 8, 80), np.float32))


@pytest.fixture(scope="module")
def voc192():
    """A 192-channel generator's seeded variables: stages of 96, 48, 24 and
    12 channels, which the JAX generator folds to 96, 96, 120 and 120 lanes."""
    return seeded_variables(JaxHiFiGAN(channels=192), np.random.RandomState(4),
                            jnp.zeros((1, 10, 80)))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_stage_mode_routes_as_jax(voc192, mode):
    """The JAX generator gives its stage kernel only the stages whose folded
    width is 128 or 256 (``toucan_tpu/models/vocoders/hifigan.py:243-244``):
    at 192 channels none, so its int8 and bf16 waves are the exact one, and
    its calibration returns no scale.  The port sent every stage to K3 and,
    on its own calibration's scales, missed JAX's int8 wave by 1.0e-2 (of a
    0.285 peak); routed as JAX routes, it meets the wave tolerance."""
    mel = np.random.RandomState(7).randn(1, 10, 80).astype(np.float32)
    scales = jax.jit(lambda v, m: jax_calibrate_act(JaxHiFiGAN(channels=192), v, m))(voc192, mel)
    assert scales == {}
    want = np.asarray(jax.jit(lambda v, m: JaxHiFiGAN(channels=192, stage_mode=mode).apply(
        v, m, act_scales=scales))(voc192, mel))[..., 0]
    gen = HiFiGANGenerator(channels=192)
    gen.load_state_dict(hifigan_from_jax(voc192))
    gen.eval()
    port_scales = calibrate_act_scales(gen, torch.from_numpy(mel))
    gen.stage_mode = mode
    got = gen(torch.from_numpy(mel), act_scales=port_scales)[..., 0].numpy()
    assert got.shape == want.shape == (1, 10 * 384)
    assert np.abs(got - want).max() <= 2e-5


def test_stage_mode_routing_per_stage(monkeypatch):
    """Per stage: K3 where the folded width is 128 or 256 (every stage of
    the released 512 channels), else the im2col rule (K4 at the stages of
    ``imcol_stages`` with at most 128 channels), else K2."""
    calls = []
    for name in ("hifigan_stage", "quantized_stage", "imcol_stage"):
        real = getattr(hifigan_mod, name)
        monkeypatch.setattr(hifigan_mod, name, functools.partial(
            lambda real, name, x, *a: calls.append(name) or real(x, *a), real, name))
    released = HiFiGANGenerator(stage_mode="int8")
    assert [released.runs_stage_kernel(i) for i in range(4)] == [True] * 4
    scales = {i: torch.ones(18) for i in range(4)}
    for channels, kw, want in [
            (192, dict(stage_mode="int8"), ["hifigan_stage"] * 4),
            (192, dict(stage_mode="bf16", imcol_mode="int8"),
             ["hifigan_stage"] + ["imcol_stage"] * 3),
            (64, dict(stage_mode="int8", imcol_mode="bf16"), ["quantized_stage"] * 4),
            (384, dict(stage_mode="int8", imcol_mode="int8"),
             ["hifigan_stage"] + ["imcol_stage"] * 3)]:
        calls.clear()
        HiFiGANGenerator(channels=channels, **kw)(torch.zeros(1, 10, 80), act_scales=scales)
        assert calls == want, (channels, kw)
    assert quantized_stage.launches == 0
