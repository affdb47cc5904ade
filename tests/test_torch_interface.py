"""The port's ToucanTTSInterface against the JAX package's, end to end.

Both interfaces get the same seeded weights (JAX layout, carried to the
port by ``toucan_tpu_torch.weights``) and the same glow noise.  Durations
must be equal; the wave within 2e-4: the vocoder alone is held to 2e-5 in
``test_torch_modules.py``, and here the mel's own difference of up to 3e-4
passes through it.
"""

import wave as wave_mod

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.utils.device import f32_precision
from toucan_tpu_torch.weights import hifigan_from_jax, toucan_tts_from_jax

from test_torch_modules import seeded_variables

torch.set_num_threads(2)

TINY = dict(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1, dec_units=64,
            duration_layers=1, pitch_layers=1, energy_layers=1, duration_chans=16,
            pitch_chans=16, energy_chans=16, glow_blocks=2, glow_hidden=16,
            utt_embed_dim=64, lang_embs=100)
IPA = "~ðɪs ɪz ə tˈɛst~#"
TEXTS = [IPA, "~hɛlˈoʊ wˈɜːld~#", "~ə ʃˈɔːɹt wˈʌn~#"]


@pytest.fixture(scope="module")
def pair():
    tts_vars = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32),
                                method=JaxToucanTTS.infer)
    voc_vars = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                jnp.zeros((1, 16, 80)))
    emb = np.random.RandomState(2).randn(64).astype(np.float32)
    jax_iface = JaxInterface(tts_vars, voc_vars, None, default_embedding=emb,
                             config=JaxConfig(**TINY), vocoder=JaxHiFiGAN(channels=64),
                             language="en", use_g2p=False)
    port = ToucanTTSInterface(toucan_tts_from_jax(tts_vars), hifigan_from_jax(voc_vars),
                              config=ToucanTTSConfig(**TINY),
                              vocoder=HiFiGANGenerator(channels=64), default_embedding=emb,
                              language="en", use_g2p=False, device="cpu")
    return jax_iface, port


@pytest.mark.parametrize("knobs", [{}, dict(duration_scaling_factor=1.5, pitch_variance_scale=0.6,
                                             energy_variance_scale=1.4,
                                             pause_duration_scaling_factor=2.0)])
def test_call_matches_jax_interface(pair, knobs):
    jax_iface, port = pair
    z = (0.8 * np.random.RandomState(3).randn(32 * 16, 80)).astype(np.float32)
    want = jax_iface(IPA, input_is_phones=True, glow_noise=z, return_duration_pitch_energy=True,
                     **knobs)
    got = port(IPA, input_is_phones=True, glow_noise=z, return_duration_pitch_energy=True,
               **knobs)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape and len(got[0]) > 0
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, atol=3e-4)


def _batch_inputs(iface):
    phones = [iface.text2phone.string_to_features(t, input_phonemes=True) for t in TEXTS]
    lens = np.asarray([len(p) for p in phones], np.int32)
    text = np.zeros((len(TEXTS), 32, 62), np.float32)
    for i, p in enumerate(phones):
        text[i, :len(p)] = p
    return text, lens


def test_fused_batch_matches_jax(pair):
    jax_iface, port = pair
    text, lens = _batch_inputs(port)
    rng = np.random.RandomState(4)
    utt = rng.randn(3, 64).astype(np.float32)
    lang = np.asarray([[12], [12], [3]], np.int32)
    noise = (0.8 * rng.randn(3, 512, 80)).astype(np.float32)
    knobs = (1.0, 1.0, 1.0, 1.0)
    want = jax_iface._e2e_fn(32, 512, False)(
        jax_iface.tts_variables, jax_iface.vocoder_variables, jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(utt), jnp.asarray(lang), jnp.asarray(noise),
        jnp.asarray(knobs, jnp.float32))
    got = port._e2e(torch.tensor(text), torch.tensor(lens, dtype=torch.long), 512,
                    torch.tensor(utt), torch.tensor(lang, dtype=torch.long),
                    torch.tensor(noise), knobs)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[2], want[2])      # durations
    np.testing.assert_array_equal(got[5], want[5])      # mel lengths
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    np.testing.assert_allclose(got[1], want[1], atol=3e-4)


def test_synthesize_batch_rows_equal_single_runs(pair):
    _, port = pair
    port.generator.manual_seed(5)
    waves = port.synthesize_batch(TEXTS, input_is_phones=True)
    port.generator.manual_seed(5)
    noise = port._noise(3, 512)
    text, lens = _batch_inputs(port)
    utt = port._utt(1)
    lang = torch.tensor([[port.lang_id]])
    for i, w in enumerate(waves):
        single, *_, mel_len = port._e2e(torch.tensor(text[i:i + 1]),
                                        torch.tensor(lens[i:i + 1], dtype=torch.long), 512,
                                        utt, lang, noise[i:i + 1])
        assert len(w) == int(mel_len[0]) * 384 > 0
        np.testing.assert_allclose(w, single[0, :len(w)].numpy(), atol=1e-5)


def test_vocode_equals_the_fused_path(pair):
    """Vocoding the trimmed mel alone equals the fused text -> wave call:
    the zeroed padding lies outside every kept sample's receptive field."""
    _, port = pair
    text, lens = _batch_inputs(port)
    noise = torch.tensor(0.8 * np.random.RandomState(6).randn(1, 512, 80), dtype=torch.float32)
    wave, after, *_, mel_len = port._e2e(torch.tensor(text[:1]),
                                         torch.tensor(lens[:1], dtype=torch.long), 512,
                                         port._utt(1), torch.tensor([[port.lang_id]]), noise)
    n = int(mel_len[0])
    np.testing.assert_allclose(port._vocode(after[0, :n].numpy()), wave[0, :n * 384].numpy(),
                               atol=1e-5)


def test_synthesize_batch_multilingual(pair):
    _, port = pair
    waves = port.synthesize_batch(["~hɛlˈoʊ wˈɜːld~#", "~hˈaloː vˈɛlt~#"], input_is_phones=True,
                                  languages=["en", "de"])
    assert len(waves) == 2 and all(len(w) > 0 and np.isfinite(w).all() for w in waves)


def test_explicit_durations_set_length(pair):
    _, port = pair
    n = len(port.text2phone.string_to_features(IPA, input_phonemes=True))
    wave, dur, _, _ = port(IPA, input_is_phones=True, durations=np.full(n, 4),
                           return_duration_pitch_energy=True)
    assert np.all((dur == 4) | (dur == 0)) and len(wave) == int(dur.sum()) // 2 * 2 * 384


def test_read_to_file_writes_24khz_wav(pair, tmp_path):
    _, port = pair
    path = tmp_path / "out.wav"
    samples = port.read_to_file([IPA, "~hɛlˈoʊ~#"], path, input_is_phones=True)
    with wave_mod.open(str(path), "rb") as f:
        assert f.getframerate() == 24000 and f.getsampwidth() == 2
        assert f.getnframes() == len(samples) > 2 * 10600


def test_entry_point_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToucanTTSInterface({}, {}, config=ToucanTTSConfig(**TINY))


@pytest.mark.parametrize("cudnn_tf32,matmul_tf32,policy", [
    pytest.param(cudnn_tf32, matmul_tf32, policy,
                 id="-".join(([] if policy is None else [policy])
                             + [str(cudnn_tf32), str(matmul_tf32)]))
    for policy in (None, "default")
    for cudnn_tf32, matmul_tf32 in ((True, True), (True, False), (False, True), (False, False))])
def test_call_runs_f32_and_restores_tf32_flags(pair, cudnn_tf32, matmul_tf32, policy):
    """``__call__`` runs its convs and matmuls under the interface's
    ``matmul_precision`` whatever the caller's TF32 flags (PyTorch's default
    turns TF32 on for cuDNN convs): in f32 by default (``policy`` None, the
    interface as built), with TF32 on under "default"; and leaves the flags
    as it found them."""
    _, port = pair
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    inside = (False, False) if policy is None else (True, True)
    seen = []
    hook = port.vocoder.register_forward_pre_hook(
        lambda *_: seen.append((cudnn.allow_tf32, matmul.allow_tf32)))
    try:
        if policy is not None:
            port.matmul_precision = policy
        cudnn.allow_tf32, matmul.allow_tf32 = cudnn_tf32, matmul_tf32
        port(IPA, input_is_phones=True)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (cudnn_tf32, matmul_tf32)
        with f32_precision():
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (cudnn_tf32, matmul_tf32)
    finally:
        hook.remove()
        cudnn.allow_tf32, matmul.allow_tf32 = before
        port.matmul_precision = "float32"
    assert seen == [inside]


def test_call_pins_ieee_under_the_newer_precision_api(pair):
    """Once a caller has set PyTorch's newer ``fp32_precision`` switches
    (after which reading ``allow_tf32`` raises), ``__call__`` runs with
    cuDNN conv, cuDNN RNN and matmul at "ieee" and restores the caller's
    values after it."""
    _, port = pair
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    switches = (cudnn.conv, cudnn.rnn, matmul)
    before = [s.fp32_precision for s in switches]
    seen = []
    hook = port.vocoder.register_forward_pre_hook(
        lambda *_: seen.append([s.fp32_precision for s in switches]))
    try:
        cudnn.conv.fp32_precision = cudnn.rnn.fp32_precision = "tf32"
        matmul.fp32_precision = "tf32"
        port(IPA, input_is_phones=True)
        assert [s.fp32_precision for s in switches] == ["tf32"] * 3
        with f32_precision():
            assert [s.fp32_precision for s in switches] == ["ieee"] * 3
        assert [s.fp32_precision for s in switches] == ["tf32"] * 3
    finally:
        hook.remove()
        for s, value in zip(switches, before):
            s.fp32_precision = value
    assert seen == [["ieee"] * 3]
    cudnn.allow_tf32, matmul.allow_tf32  # the legacy flags read again
