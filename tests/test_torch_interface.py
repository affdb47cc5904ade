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
from torch import nn

from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch.frontend.inventory import feature_index
from toucan_tpu_torch.infer.interface import (SAMPLES_PER_FRAME, SENTENCE_JOIN_SILENCE,
                                              ToucanTTSInterface, acoustic_step)
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
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


def whole_step(port, *args, **kwargs):
    """Text -> wave over every decoded frame, as the JAX interface's step
    computes it: the port's acoustic step (``acoustic_step``'s arguments),
    then its vocoder on the whole masked mel.  Returns (wave, after,
    durations, pitch, energy, mel_lengths)."""
    with torch.inference_mode():
        mel, *outs = acoustic_step(port.model, *args, **kwargs)
        return (port._vocoder_call(mel)[..., 0], *outs)


def utterance(port, b=1):
    """The port's default utterance embedding, (b, 64)."""
    return torch.tensor(np.tile(port.default_utterance_embedding[None], (b, 1)))


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
    got = whole_step(port, torch.tensor(text), torch.tensor(lens, dtype=torch.long), 512,
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
    noise = port._draws(3, 32, 512)["noise"]
    text, lens = _batch_inputs(port)
    utt = utterance(port)
    lang = torch.tensor([[port.lang_id]])
    for i, w in enumerate(waves):
        single, *_, mel_len = whole_step(port, torch.tensor(text[i:i + 1]),
                                         torch.tensor(lens[i:i + 1], dtype=torch.long), 512,
                                         utt, lang, noise[i:i + 1])
        assert len(w) == int(mel_len[0]) * 384 > 0
        np.testing.assert_allclose(w, single[0, :len(w)].numpy(), atol=1e-5)


def test_vocode_equals_the_fused_path(pair):
    """Vocoding the trimmed mel alone equals vocoding the whole masked mel:
    the zeroed padding lies outside every kept sample's receptive field."""
    _, port = pair
    text, lens = _batch_inputs(port)
    noise = torch.tensor(0.8 * np.random.RandomState(6).randn(1, 512, 80), dtype=torch.float32)
    wave, after, *_, mel_len = whole_step(port, torch.tensor(text[:1]),
                                          torch.tensor(lens[:1], dtype=torch.long), 512,
                                          utterance(port), torch.tensor([[port.lang_id]]), noise)
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


# ----------------------------------------------------- the vocoder's frame cut

def port_with(vocoder, glow=True):
    """A port interface on seeded torch weights (no JAX) with this vocoder
    module; ``glow=False``: no post-flow, so a mel keeps an odd length."""
    torch.manual_seed(0)
    config = ToucanTTSConfig(**TINY, use_postflow=glow)
    return ToucanTTSInterface(ToucanTTS(config).state_dict(), vocoder.state_dict(), config=config,
                              vocoder=vocoder, default_embedding=np.zeros(64, np.float32),
                              language="en", use_g2p=False, device="cpu")


def step_inputs(port, frames: int):
    """``_run_e2e``'s inputs for IPA with durations that sum to ``frames``
    (the word boundaries take none)."""
    phones = port.text2phone.string_to_features(IPA, input_phonemes=True)
    text = np.zeros((1, 32, phones.shape[1]), np.float32)
    text[0, :len(phones)] = phones
    speaking = np.flatnonzero(phones[:, feature_index()["word-boundary"]] != 1)
    durations = np.zeros((1, 32), np.int32)
    durations[0, speaking] = 1
    durations[0, speaking[0]] += frames - len(speaking)
    return dict(text=torch.tensor(text), text_lengths=torch.tensor([len(phones)]),
                utt=utterance(port), lang=torch.tensor([[port.lang_id]]),
                knobs=torch.ones(4), durations=torch.tensor(durations), pitch=None, energy=None)


@pytest.mark.parametrize("make", [lambda: HiFiGANGenerator(channels=64),
                                  lambda: BigVGAN(channels=32)], ids=["hifigan", "bigvgan"])
def test_cut_step_equals_the_whole_padded_mel(make):
    """A step whose mel ends R frames before its frame bucket (the least
    margin the cut leaves, R the vocoder's receptive frames) vocodes that
    bucket alone, in its bucket and eagerly alike, and delivers the
    samples of the whole padded mel vocoded."""
    port = port_with(make(), glow=False)
    reach = port.vocoder.receptive_frames
    length = 128 - reach
    inputs = step_inputs(port, length)
    noise = torch.zeros(1, 512, 80)
    wave, after, dur, _, _, lens = port._run_e2e(512, noise, **inputs)
    assert int(lens[0]) == length and wave.shape == (1, 128 * SAMPLES_PER_FRAME)
    assert list(port._vocoder_cache) == [(1, 128)] and port.counters["steps_uncut"] == 0
    assert after.shape[1] == 512
    port._eager = True
    eager = port._run_e2e(512, noise, **inputs)
    port._eager = False
    np.testing.assert_array_equal(wave.numpy(), eager[0].numpy())
    whole, *_ = whole_step(port, max_frames=512, noise=noise, **inputs)
    assert whole.shape == (1, 512 * SAMPLES_PER_FRAME)
    keep = length * SAMPLES_PER_FRAME
    np.testing.assert_allclose(wave[0, :keep].numpy(), whole[0, :keep].numpy(), atol=1e-5)


class Foreign(nn.Module):
    """A vocoder module that gives no receptive frames."""

    def __init__(self):
        super().__init__()
        self.inner = HiFiGANGenerator(channels=32)

    def forward(self, mel):
        return self.inner(mel)


@pytest.mark.parametrize("make", [lambda: HiFiGANGenerator(channels=64, imcol_mode="int8"),
                                  Foreign], ids=["imcol-int8", "foreign"])
def test_step_stays_uncut_without_receptive_frames(make):
    """K4's int8 stages (their scales see every row of a window) and a
    vocoder module without ``receptive_frames`` vocode every decoded frame,
    through the acoustic step's bucket and the vocoder's bucket of all the
    step's frames: the wave is the vocoder's of the acoustic step's whole
    mel, and ``steps_uncut`` counts each such step."""
    port = port_with(make())
    assert port._reach is None
    noise, inputs = torch.zeros(1, 512, 80), step_inputs(port, 40)
    wave, *_, lens = port._run_e2e(512, noise, **inputs)
    assert int(lens[0]) == 40 and wave.shape == (1, 512 * SAMPLES_PER_FRAME)
    assert port.counters["steps_uncut"] == 1
    assert list(port._e2e_cache) == [(1, 32, 512, True, False, False)]
    assert list(port._vocoder_cache) == [(1, 512)]
    whole, *_ = whole_step(port, max_frames=512, noise=noise, **inputs)
    np.testing.assert_array_equal(wave.numpy(), whole.numpy())


def test_read_to_file_wav_equals_the_calls_joined(pair, tmp_path):
    """The WAV of a page holds the ``__call__`` waves of its sentences on
    the same noise, joined by the silences: each sentence's vocoder step,
    enqueued before the next sentence's acoustic step, is fetched intact."""
    _, port = pair
    path = tmp_path / "page.wav"
    port.generator.manual_seed(21)
    port.read_to_file(TEXTS, path, input_is_phones=True)
    port.generator.manual_seed(21)
    silence = np.zeros(SENTENCE_JOIN_SILENCE, np.float32)
    joined = np.concatenate([silence] + [x for t in TEXTS
                                         for x in (port(t, input_is_phones=True), silence)])
    with wave_mod.open(str(path), "rb") as f:
        got = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    np.testing.assert_array_equal(got, (np.clip(joined, -1, 1) * 32767).astype(np.int16))
