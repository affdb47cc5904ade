"""The port's modules against the JAX package's, on the same weights.

A small ToucanTTS and HiFiGAN get seeded random variables in the JAX
package's layout (``seeded_variables``).  The variables go to the port through
``toucan_tpu_torch.weights`` and both packages run the same numpy inputs on
the CPU.  Tolerances: 1e-5 per module, 1e-4 through the glow, 3e-4 for
mel/pitch/energy of ``infer`` (the bar the JAX package holds against the
reference, ``tests/test_toucan_parity.py``), 2e-5 for the HiFiGAN wave
(``tests/test_vocoder_parity.py``); integer durations are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.compat.torch_toucan import convert_toucan_tts
from toucan_tpu.compat.torch_vocoder import convert_hifigan
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu.nn.conformer import ConformerBlock as JaxConformerBlock
from toucan_tpu.nn.length_regulator import length_regulate as jax_length_regulate
from toucan_tpu.nn.length_regulator import regulate_durations as jax_regulate
from toucan_tpu.nn.positional import relative_position_encoding as jax_rel_pos
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.nn.length_regulator import length_regulate, regulate_durations
from toucan_tpu_torch.nn.positional import relative_position_encoding
from toucan_tpu_torch.weights import hifigan_from_jax, toucan_tts_from_jax

torch.set_num_threads(2)

# two blocks per conformer and five glow blocks (two shared WaveNet cores)
TINY = dict(adim=32, aheads=2, enc_layers=2, enc_units=64, dec_layers=2, dec_units=64,
            duration_layers=2, pitch_layers=2, energy_layers=1, duration_chans=16,
            pitch_chans=16, energy_chans=16, glow_blocks=5, glow_hidden=16,
            utt_embed_dim=64, lang_embs=100)


def seeded_variables(model, rng, *args, **kwargs):
    """The model's variable tree, filled with seeded numpy values.

    Shapes come from tracing ``model.init`` (no compile).  Nothing is zero
    or one where JAX would initialise it so: biases, norms, BatchNorm
    statistics, ActNorm, the coupling ``end`` convs and the language
    embedding all get random values, so every part of a comparison is live.
    """
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kwargs))
    return _fill(shapes, rng)


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "var":
        a = rng.uniform(0.5, 1.5, shape)
    elif name == "p":                       # InvConvNear permutation
        a = np.eye(shape[0])[rng.permutation(shape[0])]
    elif name == "sign_s":
        a = rng.choice([-1.0, 1.0], shape)
    elif name == "scale":
        a = 1.0 + 0.1 * rng.randn(*shape)
    elif (name == "kernel" and path[-2] != "end") or name.endswith("_kernel"):
        a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    else:                                   # biases, statistics, embeddings, end
        a = 0.1 * rng.randn(*shape)
    return a.astype(np.float32)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def tts():
    model = JaxToucanTTS(JaxConfig(**TINY))
    variables = seeded_variables(model, np.random.RandomState(0), jnp.zeros((1, 8, 62)),
                                 jnp.array([8]), 32, utterance_embedding=jnp.zeros((1, 64)),
                                 lang_ids=jnp.zeros((1, 1), jnp.int32),
                                 method=JaxToucanTTS.infer)
    port = ToucanTTS(ToucanTTSConfig(**TINY))
    port.load_state_dict(toucan_tts_from_jax(variables))
    return model, variables, port.eval()


@pytest.fixture(scope="module")
def vocoder():
    model = JaxHiFiGAN(channels=64)
    variables = seeded_variables(model, np.random.RandomState(1), jnp.zeros((1, 16, 80)),
                                 return_intermediates=True)
    port = HiFiGANGenerator(channels=64)
    port.load_state_dict(hifigan_from_jax(variables))
    return model, variables, port.eval()


def _text_batch(rng, b=2, t=10, lengths=(10, 7)):
    text = (rng.rand(b, t, 62) > 0.5).astype(np.float32)
    return text, np.asarray(lengths, np.int32)


def _masks(lengths, t):
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return mask[:, None, :], mask[..., None].astype(np.float32)


def test_weights_round_trip_toucan(tts):
    _, variables, port = tts
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_toucan_tts(sd, enc_layers=TINY["enc_layers"], dec_layers=TINY["dec_layers"],
                              duration_layers=TINY["duration_layers"],
                              pitch_layers=TINY["pitch_layers"],
                              energy_layers=TINY["energy_layers"],
                              glow_blocks=TINY["glow_blocks"])
    want, got = _flatten(variables), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_weights_round_trip_hifigan(vocoder):
    _, variables, port = vocoder
    back = convert_hifigan({k: v.numpy() for k, v in port.state_dict().items()})
    want, got = _flatten(variables), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_relative_position_table_is_equal():
    np.testing.assert_array_equal(relative_position_encoding(9, 32).numpy(),
                                  np.asarray(jax_rel_pos(9, 32)))


def test_conformer_block(tts):
    _, variables, port = tts
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 32).astype(np.float32)
    mask, cmask = _masks((12, 7), 12)
    pos = np.asarray(jax_rel_pos(12, 32))
    block = JaxConformerBlock(32, 2, 64, 7)
    want = block.apply({"params": variables["params"]["encoder"]["block_0"],
                        "batch_stats": variables["batch_stats"]["encoder"]["block_0"]},
                       x, pos, mask, conv_mask=cmask)
    got = port.encoder.encoders[0](_t(x), _t(pos), _t(mask, torch.bool), _t(cmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_encoder_with_language_and_utterance_embedding(tts):
    model, variables, port = tts
    rng = np.random.RandomState(3)
    text, lens = _text_batch(rng)
    mask, cmask = _masks(lens, text.shape[1])
    utt = rng.randn(2, 64).astype(np.float32)
    lang = np.asarray([[3], [41]], np.int32)
    want = model.apply(variables, text, mask, utt, lang, conv_mask=cmask,
                       method=lambda m, *a, **k: m.encoder(*a, **k))
    got = port.encoder(_t(text), _t(mask, torch.bool), _t(utt), _t(lang, torch.long),
                       conv_mask=_t(cmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_predictors_with_conditional_layer_norm(tts):
    model, variables, port = tts
    rng = np.random.RandomState(4)
    enc = rng.randn(2, 10, 32).astype(np.float32)
    utt = rng.randn(2, 64).astype(np.float32)
    utt /= np.linalg.norm(utt, axis=-1, keepdims=True)
    _, cmask = _masks((10, 6), 10)

    def run(m, x, u, cm):
        return (m.duration_predictor(x, utt_embed=u, is_inference=True, input_mask=cm),
                m.pitch_predictor(x, utt_embed=u, input_mask=cm),
                m.energy_predictor(x, utt_embed=u, input_mask=cm))

    want = model.apply(variables, enc, utt, cmask, method=run)
    args = (_t(enc), _t(utt), _t(cmask))
    np.testing.assert_array_equal(port.duration_predictor(*args).numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(port.pitch_predictor(*args).detach().numpy(),
                               np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(port.energy_predictor(*args).detach().numpy(),
                               np.asarray(want[2]), atol=1e-5)


def test_length_regulator_with_all_zero_row():
    rng = np.random.RandomState(5)
    xs = rng.randn(3, 6, 8).astype(np.float32)
    ds = rng.randint(0, 4, size=(3, 6)).astype(np.int32)
    ds[1] = 0  # the reference's all-zero fallback
    want_ds = np.asarray(jax_regulate(jnp.asarray(ds)))
    got_ds = regulate_durations(_t(ds, torch.int32))
    np.testing.assert_array_equal(got_ds.numpy(), want_ds)
    want = np.asarray(jax_length_regulate(jnp.asarray(xs), jnp.asarray(want_ds), 32))
    got = length_regulate(_t(xs), got_ds, 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_postnet_with_mask(tts):
    model, variables, port = tts
    rng = np.random.RandomState(6)
    mel = rng.randn(2, 24, 80).astype(np.float32)
    _, cmask = _masks((24, 15), 24)
    want = model.apply(variables, mel, mask=cmask,
                       method=lambda m, x, mask: m.conv_postnet(x, mask=mask))
    got = port.conv_postnet(_t(mel), mask=_t(cmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_glow_sample(tts):
    model, variables, port = tts
    rng = np.random.RandomState(7)
    z = (0.8 * rng.randn(2, 24, 80)).astype(np.float32)
    mel = rng.randn(2, 24, 80).astype(np.float32)
    enc = rng.randn(2, 24, 32).astype(np.float32)
    _, cmask = _masks((24, 17), 24)
    want = model.apply(variables, z, mel, enc, cmask,
                       method=lambda m, *a: m.post_flow.sample(*a))
    got = port.post_flow.sample(_t(z), _t(mel), _t(enc), _t(cmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("gold_durations", [False, True])
def test_infer_end_to_end(tts, gold_durations):
    model, variables, port = tts
    rng = np.random.RandomState(8)
    text, lens = _text_batch(rng, t=12, lengths=(12, 9))
    utt = rng.randn(2, 64).astype(np.float32)
    lang = np.asarray([[3], [41]], np.int32)
    max_frames = 64
    noise = (0.8 * rng.randn(2, max_frames, 80)).astype(np.float32)
    durations = rng.randint(1, 5, size=(2, 12)).astype(np.int32) if gold_durations else None
    want = model.apply(variables, text, lens, max_frames, utterance_embedding=utt,
                       lang_ids=lang, gold_durations=durations, glow_noise=noise,
                       method=JaxToucanTTS.infer)
    got = port.infer(_t(text), _t(lens, torch.long), max_frames, utterance_embedding=_t(utt),
                     lang_ids=_t(lang, torch.long),
                     gold_durations=None if durations is None else _t(durations, torch.int32),
                     glow_noise=_t(noise))
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[2], want[2])           # durations
    np.testing.assert_array_equal(got[5], want[5])           # mel lengths
    for i in (0, 1, 3, 4):                                   # before, after, pitch, energy
        np.testing.assert_allclose(got[i], want[i], atol=3e-4)


def test_hifigan_wave(vocoder):
    model, variables, port = vocoder
    mel = np.random.RandomState(9).randn(2, 20, 80).astype(np.float32)
    want = np.asarray(model.apply(variables, mel))
    got = port(_t(mel)).numpy()
    assert got.shape == (2, 20 * 384, 1)
    np.testing.assert_allclose(got, want, atol=2e-5)
