"""The port's BigVGAN slice against the JAX package's, on the CPU.

K5 (``kernels/aliasfree.py``) runs its plain version here; it is held
against the JAX ``alias_free_snake`` and against the Pallas kernel in
interpret mode (through ``alias_free_snake_folded``, which patches the
edges the kernel leaves out) at atol 2e-5, the bar the JAX package holds its
own folded and Pallas paths to (``tests/test_bigvgan_folded.py``).  The port's
BigVGAN gets seeded variables in the JAX layout through
``weights.bigvgan_from_jax``; its wave is held to 2e-5, the interface's to
2e-4 (the mel's own difference of up to 3e-4 passes through the vocoder, as
in ``test_torch_interface.py``), with equal durations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.compat.torch_vocoder import convert_bigvgan
from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.kernels.folded_conv import fold_time, unfold_time
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.bigvgan import BigVGAN as JaxBigVGAN
from toucan_tpu.nn.alias_free import alias_free_snake as jax_alias_free_snake
from toucan_tpu.nn.alias_free import alias_free_snake_folded
from toucan_tpu.nn.alias_free import kaiser_sinc_filter as jax_kaiser_sinc_filter
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.kernels.aliasfree import alias_free_snake
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.nn.alias_free import kaiser_sinc_filter
from toucan_tpu_torch.weights import bigvgan_from_jax, toucan_tts_from_jax

from test_torch_interface import IPA, TINY
from test_torch_modules import _flatten, seeded_variables

torch.set_num_threads(2)


def _snake_inputs(t, c=8, b=2, seed=0):
    rng = np.random.RandomState(seed + t)
    x = rng.randn(b, t, c).astype(np.float32)
    alpha = (0.3 * rng.randn(c)).astype(np.float32)
    beta = (0.3 * rng.randn(c)).astype(np.float32)
    return x, alpha, beta


def test_filter_copy_is_equal():
    np.testing.assert_array_equal(kaiser_sinc_filter(0.25, 0.3, 12),
                                  jax_kaiser_sinc_filter(0.25, 0.3, 12))


@pytest.mark.parametrize("t", [8, 16, 40, 64])
def test_k5_plain_matches_jax(t):
    x, alpha, beta = _snake_inputs(t)
    want = np.asarray(jax_alias_free_snake(*map(jnp.asarray, (x, alpha, beta))))
    got = alias_free_snake(*map(torch.from_numpy, (x, alpha, beta))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert alias_free_snake.launches == 0


@pytest.mark.parametrize("t", [8, 16, 40, 64])
@pytest.mark.parametrize("f", [1, 2, 4])
def test_k5_plain_matches_pallas_interpret(t, f):
    x, alpha, beta = _snake_inputs(t, seed=1)
    want = np.asarray(unfold_time(alias_free_snake_folded(
        fold_time(jnp.asarray(x), f), jnp.asarray(alpha), jnp.asarray(beta), f,
        pallas=True, pallas_interpret=True), f))
    got = alias_free_snake(*map(torch.from_numpy, (x, alpha, beta))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert alias_free_snake.launches == 0


def test_k5_time_innermost_view():
    """The (B, T, C) view of a (B, C, T) tensor, as BigVGAN passes it, gives
    the same values and keeps its strides."""
    x, alpha, beta = _snake_inputs(40, c=5)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    got = alias_free_snake(xt, torch.from_numpy(alpha), torch.from_numpy(beta))
    want = alias_free_snake(torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(beta))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.transpose(1, 2).is_contiguous()


def test_k5_raises_off_cpu_and_cuda():
    meta = torch.zeros(1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        alias_free_snake(meta, torch.zeros(8, device="meta"), torch.zeros(8, device="meta"))
    assert alias_free_snake.launches == 0


def _bigvgan_variables(variables, rng, gain=0.8):
    """Seeded variables, with two changes for BigVGAN: alpha/beta get 0.3 x
    N(0, 1), so every activation bends its input; and every conv kernel is
    scaled by ``gain``.  At the seeded unit gain the residual AMP blocks grow
    the signal until tanh saturates (mean |wave| 0.81) and the two packages'
    f32 sines, amplified through 73 activations, differ by up to 4e-5; at
    0.8 the wave peaks near 0.56 and they agree to 1e-6.  The unit gain has
    its own test, ``test_bigvgan_wave_matches_jax_unit_gain``."""
    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif "alpha" in k or "beta" in k:
                out[k] = (0.3 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "kernel" or k.endswith("_kernel"):
                out[k] = (gain * v).astype(np.float32)
            else:
                out[k] = v
        return out
    return fill(variables)


# one AMP block of two rounds per stage (17 activations): the interpret-mode
# Pallas path and the interface's compile stay short
SMALL = dict(channels=64, resblock_kernel_sizes=(3,))


def _vocoder(seed, small=False, gain=0.8):
    kw = SMALL if small else dict(channels=64)
    dil = dict(resblock_dilations=((1, 3),)) if small else {}
    model = JaxBigVGAN(use_folding=False, **kw, **dil)
    rng = np.random.RandomState(seed)
    variables = _bigvgan_variables(seeded_variables(model, rng, jnp.zeros((1, 8, 80)),
                                                   return_intermediates=True), rng, gain)
    port = BigVGAN(**kw, **(dict(resblock_dilations=(1, 3)) if small else {}))
    port.load_state_dict(bigvgan_from_jax(variables))
    return model, variables, port.eval()


def _inference(variables):
    return {"params": {k: v for k, v in variables["params"].items()
                       if not k.startswith("out_proj")}}


@pytest.fixture(scope="module")
def vocoder():
    return _vocoder(11)


@pytest.fixture(scope="module")
def small_vocoder():
    return _vocoder(12, small=True)


def test_weights_round_trip_bigvgan(vocoder):
    _, variables, port = vocoder
    back = convert_bigvgan({k: v.numpy() for k, v in port.state_dict().items()})
    want, got = _flatten(variables), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_bigvgan_from_jax_zeroes_missing_taps(vocoder):
    _, variables, _ = vocoder
    params = {k: v for k, v in variables["params"].items() if not k.startswith("out_proj")}
    sd = bigvgan_from_jax({"params": params})
    assert not sd["out_proj_x1.weight"].any() and sd["out_proj_x2.weight"].shape == (1, 8, 7)
    BigVGAN(channels=64).load_state_dict(sd)


@pytest.mark.parametrize("frames", [8, 13])
def test_bigvgan_wave_matches_jax(vocoder, frames):
    model, variables, port = vocoder
    mel = np.random.RandomState(frames).randn(1, frames, 80).astype(np.float32)
    want = np.asarray(model.apply(_inference(variables), mel))
    got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == (1, frames * 384, 1)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert alias_free_snake.launches == 0


def test_bigvgan_wave_matches_jax_unit_gain():
    """At the seeded unit gain, where tanh saturates and 73 f32 sines amplify
    rounding, two exact f32 formulations of BigVGAN differ measurably: the
    JAX package's time-folded and plain generators, by about 2e-5 on this
    input.  The port is held within 4x that spread, measured here."""
    model, variables, port = _vocoder(11, gain=1.0)
    mel = np.random.RandomState(8).randn(1, 8, 80).astype(np.float32)
    want = np.asarray(model.apply(_inference(variables), mel))
    folded = np.asarray(JaxBigVGAN(channels=64, use_folding=True).apply(_inference(variables),
                                                                         mel))
    spread = np.abs(folded - want).max()
    assert 0 < spread < 1e-4
    got = port(torch.from_numpy(mel)).numpy()
    assert np.abs(got - want).max() <= 4 * spread, (np.abs(got - want).max(), spread)


def test_bigvgan_wave_matches_jax_pallas_act(small_vocoder):
    """Against the JAX BigVGAN on its folded layout with every folded
    activation through the Pallas kernel (interpret mode)."""
    _, variables, port = small_vocoder
    mel = np.random.RandomState(3).randn(1, 8, 80).astype(np.float32)
    fast = JaxBigVGAN(**SMALL, resblock_dilations=((1, 3),), pallas_act=True,
                      pallas_interpret=True)
    want = np.asarray(fast.apply(_inference(variables), mel))
    got = port(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def _tts_variables():
    return seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                            jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                            utterance_embedding=jnp.zeros((1, 64)),
                            lang_ids=jnp.zeros((1, 1), jnp.int32), method=JaxToucanTTS.infer)


def test_interface_bigvgan_matches_jax(small_vocoder):
    _, variables, port_voc = small_vocoder
    tts_vars = _tts_variables()
    emb = np.random.RandomState(2).randn(64).astype(np.float32)
    jax_iface = JaxInterface(tts_vars, _inference(variables), None, default_embedding=emb,
                             config=JaxConfig(**TINY),
                             vocoder=JaxBigVGAN(**SMALL, resblock_dilations=((1, 3),)),
                             language="en", use_g2p=False)
    port = ToucanTTSInterface(toucan_tts_from_jax(tts_vars), port_voc.state_dict(),
                              config=ToucanTTSConfig(**TINY), vocoder=port_voc,
                              default_embedding=emb, language="en", use_g2p=False,
                              device="cpu")
    z = (0.8 * np.random.RandomState(3).randn(32 * 16, 80)).astype(np.float32)
    want = jax_iface(IPA, input_is_phones=True, glow_noise=z, return_duration_pitch_energy=True)
    got = port(IPA, input_is_phones=True, glow_noise=z, return_duration_pitch_energy=True)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape and len(got[0]) > 0
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)


def test_interface_builds_bigvgan_by_name():
    tts_sd = toucan_tts_from_jax(_tts_variables())
    voc_sd = BigVGAN().state_dict()
    iface = ToucanTTSInterface(tts_sd, voc_sd, config=ToucanTTSConfig(**TINY),
                               vocoder="bigvgan", use_g2p=False, device="cpu")
    assert isinstance(iface.vocoder, BigVGAN)
    with pytest.raises(ValueError, match="vocoder"):
        ToucanTTSInterface(tts_sd, voc_sd, config=ToucanTTSConfig(**TINY), vocoder="wavenet",
                           use_g2p=False, device="cpu")
