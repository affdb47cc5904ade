"""The port's audio front end and GST embedding against the JAX package's, on the CPU.

The mel filters, loudness, resampling and trimming are numpy copies and must
be equal; the log-mel is a torch ``rfft`` against JAX's (``jnp.fft.rfft`` on
the CPU), held to 2e-4 (after resampling, within 4 decades of the peak:
see ``test_audio_preprocessor_at_24k_matches_jax``).  ``StyleEmbedding``
gets seeded weights in the reference layout, converted to JAX variables by
``compat/torch_gst.py``; it is
held to 3e-4, the bar of ``tests/test_gst_parity.py`` against the reference,
and ``weights.style_embedding_from_jax`` must give the weights back exactly.
``set_utterance_embedding`` from a 24 kHz wave runs the whole chain on both
interfaces; the embeddings agree within 3e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.compat.torch_gst import convert_style_embedding
from toucan_tpu.frontend import audio as jax_audio
from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.models.gst import StyleEmbedding as JaxStyleEmbedding
from toucan_tpu.models.gst import tile_to_fixed_frames as jax_tile
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch.frontend import audio
from toucan_tpu_torch.infer.interface import ToucanTTSInterface, write_wav
from toucan_tpu_torch.models.gst import StyleEmbedding, tile_to_fixed_frames
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.weights import hifigan_from_jax, style_embedding_from_jax, toucan_tts_from_jax

from test_torch_interface import TINY
from test_torch_modules import seeded_variables

torch.set_num_threads(2)


def speech_like(sr, seconds, seed=0):
    """A seeded wave with voiced partials, noise and silent edges."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wave = sum(np.sin(h * phase) / h for h in range(1, 8)) + 0.1 * rng.randn(len(t))
    env = np.clip(np.minimum(t - 0.2, seconds - 0.2 - t) * 10, 0, 1)
    return (0.3 * wave * env).astype(np.float32)


def test_filters_and_numpy_dsp_are_copies():
    np.testing.assert_array_equal(audio.mel_filterbank(), jax_audio.mel_filterbank())
    wave = speech_like(24000, 1.0)
    np.testing.assert_array_equal(audio.normalize_loudness(wave, 24000),
                                  jax_audio.normalize_loudness(wave, 24000))
    trimmed = audio.trim_silence(wave, 24000)
    want = jax_audio.trim_silence(wave, 24000)
    np.testing.assert_array_equal(trimmed[0], want[0])
    assert trimmed[1:] == want[1:]


def test_resample_is_the_numpy_path(monkeypatch):
    monkeypatch.setenv("TOUCAN_NATIVE_RESAMPLE", "0")
    wave = speech_like(24000, 0.5)
    np.testing.assert_array_equal(audio.resample(wave, 24000, 16000),
                                  jax_audio.resample(wave, 24000, 16000))


@pytest.mark.parametrize("seconds", [0.3, 1.01])
def test_log_mel_matches_jax(seconds):
    wave = speech_like(16000, seconds, seed=1)
    want = np.asarray(jax_audio.log_mel_spectrogram(jnp.asarray(wave)))
    got = audio.log_mel_spectrogram(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (1 + len(wave) // 256, 80)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_audio_preprocessor_at_24k_matches_jax(monkeypatch):
    monkeypatch.setenv("TOUCAN_NATIVE_RESAMPLE", "0")
    wave = speech_like(24000, 1.2, seed=2)
    kw = dict(input_sr=24000, output_sr=16000, cut_silence=True)
    want = jax_audio.AudioPreprocessor(**kw).audio_to_mel_spec_tensor(wave)
    got = audio.AudioPreprocessor(**kw).audio_to_mel_spec_tensor(wave, device="cpu").numpy()
    assert got.shape == want.shape and got.shape[0] == 80
    # bands 71-79 lie above the resampler's roll-off, 4 to 9 decades under
    # the peak, in the f32 FFT's round-off; there the log magnifies
    # differences of 1e-7 of the peak up to 3e-3
    top = want.max()
    np.testing.assert_allclose(got[want > top - 4], want[want > top - 4], atol=2e-4)
    np.testing.assert_allclose(10.0 ** got, 10.0 ** want, atol=1e-6 * 10.0 ** top)


@pytest.mark.parametrize("length", [3, 100, 406, 811, 812, 900])
def test_tile_to_fixed_frames_equal(length):
    spec = np.random.RandomState(length).randn(1000, 80).astype(np.float32)
    want = np.asarray(jax_tile(jnp.asarray(spec), jnp.asarray(length)))
    np.testing.assert_array_equal(tile_to_fixed_frames(torch.from_numpy(spec), length).numpy(), want)


def seeded_gst(seed=0) -> StyleEmbedding:
    """A StyleEmbedding with seeded weights and BatchNorm statistics (eval)."""
    torch.manual_seed(seed)
    gst = StyleEmbedding()
    with torch.no_grad():
        for name, buf in gst.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn_like(buf))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
        for name, p in gst.named_parameters():
            if ".convs." in name and p.dim() == 1:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * torch.randn_like(p))
    return gst.eval()


@pytest.fixture(scope="module")
def gst_pair():
    gst = seeded_gst()
    sd = {k: v.numpy() for k, v in gst.state_dict().items()}
    variables = convert_style_embedding(sd)
    return gst, variables


def test_style_embedding_matches_jax(gst_pair):
    gst, variables = gst_pair
    rng = np.random.RandomState(0)
    specs = rng.randn(3, 400, 80).astype(np.float32)
    lens = np.array([400, 250, 333])
    for refs in (True, False):
        want = np.asarray(JaxStyleEmbedding().apply(variables, jnp.asarray(specs), jnp.asarray(lens),
                                                    return_only_refs=refs))
        got = gst(torch.from_numpy(specs), torch.from_numpy(lens), return_only_refs=refs).numpy()
        assert got.shape == (3, 256 if refs else 64)
        np.testing.assert_allclose(got, want, atol=3e-4)


def test_style_embedding_round_trip(gst_pair):
    gst, variables = gst_pair
    sd = style_embedding_from_jax(variables)
    want = gst.state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


@pytest.fixture(scope="module")
def iface_pair(gst_pair):
    gst, variables = gst_pair
    tts_vars = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32), method=JaxToucanTTS.infer)
    voc_vars = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                jnp.zeros((1, 16, 80)))
    jax_iface = JaxInterface(tts_vars, voc_vars, variables, config=JaxConfig(**TINY),
                             vocoder=JaxHiFiGAN(channels=64), use_g2p=False)
    port = ToucanTTSInterface(toucan_tts_from_jax(tts_vars), hifigan_from_jax(voc_vars),
                              config=ToucanTTSConfig(**TINY), vocoder=HiFiGANGenerator(channels=64),
                              use_g2p=False, device="cpu", gst_state_dict=gst.state_dict())
    return jax_iface, port


def test_set_utterance_embedding_matches_jax(iface_pair, monkeypatch, tmp_path):
    monkeypatch.setenv("TOUCAN_NATIVE_RESAMPLE", "0")
    jax_iface, port = iface_pair
    wave = speech_like(24000, 1.5, seed=3)
    jax_iface.set_utterance_embedding(wave=wave, sr=24000)
    port.set_utterance_embedding(wave=wave, sr=24000)
    want, got = jax_iface.default_utterance_embedding, port.default_utterance_embedding
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, atol=3e-4)
    # a PCM WAV file gives the embedding of its 16-bit samples
    path = tmp_path / "ref.wav"
    write_wav(path, wave, 24000)
    port.set_utterance_embedding(str(path))
    from_file = port.default_utterance_embedding
    port.set_utterance_embedding(wave=audio.read_wav(path)[0], sr=24000)
    np.testing.assert_array_equal(from_file, port.default_utterance_embedding)
    port.set_utterance_embedding(embedding=np.ones(64))
    assert (port.default_utterance_embedding == 1).all()


def test_read_wav_takes_stereo_and_8_bit(tmp_path):
    import wave as wave_mod
    path = tmp_path / "s.wav"
    pcm = np.array([[0, 16384], [-32768, 32767]], np.int16)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(pcm.tobytes())
    data, sr = audio.read_wav(path)
    assert sr == 8000
    np.testing.assert_array_equal(data, pcm / 32768.0)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(1)
        f.setframerate(8000)
        f.writeframes(bytes([0, 128, 255]))
    np.testing.assert_array_equal(audio.read_wav(path)[0], np.array([-1, 0, 127 / 128], np.float32))


def test_embedding_from_audio_needs_the_gst(iface_pair):
    port = iface_pair[1]
    bare = ToucanTTSInterface(port.model.state_dict(), port.vocoder.state_dict(),
                              config=ToucanTTSConfig(**TINY), vocoder=HiFiGANGenerator(channels=64),
                              use_g2p=False, device="cpu")
    with pytest.raises(ValueError, match="gst_state_dict"):
        bare.set_utterance_embedding(wave=np.zeros(16000, np.float32))
